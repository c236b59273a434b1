"""The port's bf16 adjacency blocks (``TrainOptions(block_dtype="bf16")``)
against the JAX package.

The reference rounds a block to bf16 once, at the end of the extraction
(``kernels/extract_gather.py``: float32 accumulation, then the cast), and
keeps everything downstream float32: the SpMM promotes the bf16 tile
against a float32 x, its gradient in x is float32, a dense ``blk @ h``
promotes too. Here, on the CPU: the port's plain bf16 extraction (the
fused kernel's plain version, the COO extraction, both builder backends)
bit for bit the reference's fused kernel in interpret mode; the
block-ELL conversion of a bf16 block bit for bit the reference's; the
bf16-tile / f32 SpMM and its dX against ``repro.kernels.ops.spmm_ell`` and
``jax.grad`` at 1e-5; one training step on each aggregation backend
against the reference's with its sample injected, at the float32 path's
limits (the blocks are bitwise equal and the rest is float32); and a
bf16 run of ``Trainer`` resumed from a checkpoint holding the prefetched
bf16 blocks, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.core import fourd as jfourd  # noqa: E402
from repro.core import gcn_model as JM  # noqa: E402
from repro.graphs import build_partitioned_graph as jbuild  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import spmm_ell as jspmm  # noqa: E402
from repro.kernels.extract_gather import extract_dense_fused as jextract  # noqa: E402,E501
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.core.forward import TrainOptions  # noqa: E402
from repro_torch.core.minibatch import MinibatchBuilder  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.kernels import extract_gather as teg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spmm_ell as tspmm  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

D_IN, D_H, LAYERS, CLASSES, BATCH, TILE = 16, 32, 3, 4, 64, 16


@pytest.fixture(scope="module")
def data():
    ds = make_synthetic_dataset(n=256, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    jcfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                        num_classes=CLASSES, dropout=0.0)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    return ds, jcfg, jax.tree.map(np.asarray, jparams)


def _bits(t) -> np.ndarray:
    """A bf16 array's bits (uint16), from either package."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _sampled(ds, seed):
    """A sorted sample of BATCH rows and another of BATCH columns of the
    graph's one CSR block (g = 1)."""
    pg = tbuild(ds, g=1)
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(pg.n_pad, BATCH, replace=False)).astype(
        np.int32)
    cols = np.sort(rng.choice(pg.n_pad, BATCH, replace=False)).astype(
        np.int32)
    csr = (pg.block_rp[0, 0], pg.block_ci[0, 0], pg.block_val[0, 0])
    return csr, rows, cols, max(pg.max_block_row_nnz, 1)


# ---------------------------------------------------------------------------
# The extraction and the ELL conversion: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", ["scalar", "per-column"])
@pytest.mark.parametrize("diag", [True, False])
def test_plain_bf16_extraction_is_the_reference_fused_kernel(data, scale,
                                                             diag):
    """The reference's ``extract_dense_fused(dtype=bfloat16)`` in interpret
    mode against the port's fused wrapper (its plain version on the CPU),
    the COO extraction and the builder on both backends, each asked for
    bf16: the same bits; and each the float32 block's cast."""
    ds = data[0]
    csr, rows, cols, max_deg = _sampled(ds, 5)
    if diag:
        cols = rows
    col_scale = (np.float32(3.7) if scale == "scalar" else
                 np.random.default_rng(1).uniform(0.5, 4.0, BATCH).astype(
                     np.float32))
    want = jax.jit(lambda: jextract(
        *map(jnp.asarray, csr), jnp.asarray(rows), jnp.asarray(cols),
        col_scale=jnp.asarray(col_scale), diag=diag, max_deg=max_deg,
        dtype=jnp.bfloat16))()
    assert want.dtype == jnp.bfloat16 and np.count_nonzero(
        np.asarray(want, np.float32)) > 0
    t = [torch.from_numpy(np.asarray(a)) for a in csr]
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    ts = (float(col_scale) if scale == "scalar"
          else torch.from_numpy(col_scale))
    fused = teg.extract_dense_fused(*t, tr, tc, col_scale=ts, diag=diag,
                                    max_deg=max_deg, dtype=torch.bfloat16)
    coo = tsmp.extract_dense_block(*t, tr, tc, BATCH * max_deg,
                                   rescale_offdiag=ts, is_diag_block=diag,
                                   dtype=torch.bfloat16)
    f32 = teg.extract_dense_fused(*t, tr, tc, col_scale=ts, diag=diag,
                                  max_deg=max_deg)
    scfg = tsmp.SampleConfig(n_pad=tbuild(ds, g=1).n_pad, g=1, batch=BATCH,
                             e_cap=BATCH * max_deg)
    built = [MinibatchBuilder(scfg=scfg, impl=impl, max_row_nnz=max_deg,
                              block_dtype=torch.bfloat16).extract_block(
        *t, tr, tc, col_scale=ts, diag=diag) for impl in ("torch", "cuda")]
    for got in (fused, coo, *built):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(f32.to(torch.bfloat16)), _bits(want))


def test_bf16_block_ell_conversion_is_the_reference(data):
    """``dense_to_block_ell_ranked`` on a bf16 block (row-blocks with no
    live tile, fewer than the slots, more than the slots): bf16 tiles and
    colidx bit for bit the reference's; the direct ELL extraction gives
    the same tiles."""
    ds = data[0]
    csr, rows, _, max_deg = _sampled(ds, 9)
    t = [torch.from_numpy(np.asarray(a)) for a in csr]
    tr = torch.from_numpy(rows)
    dense = teg.extract_dense_fused(*t, tr, tr, col_scale=2.5, diag=True,
                                    max_deg=max_deg, dtype=torch.bfloat16)
    for slots in (1, 2, BATCH // TILE):
        jt, jc = jax.jit(lambda a: jspmm.dense_to_block_ell_ranked(
            a, TILE, TILE, slots))(jnp.asarray(dense.float().numpy()).astype(
                jnp.bfloat16))
        tt, tc = tspmm.dense_to_block_ell_ranked(dense, TILE, TILE, slots)
        assert tt.dtype == torch.bfloat16 and jt.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(tt), _bits(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        et, ec = tsmp.extract_block_ell(
            *t, tr, tr, BATCH * max_deg, rescale_offdiag=2.5,
            is_diag_block=True, bm=TILE, bn=TILE, n_slots=slots,
            dtype=torch.bfloat16)
        np.testing.assert_array_equal(_bits(et), _bits(tt))
        np.testing.assert_array_equal(ec.numpy(), tc.numpy())


# ---------------------------------------------------------------------------
# The bf16-tile / f32 SpMM and its dX
# ---------------------------------------------------------------------------

def test_bf16_tile_spmm_and_dx_match_the_reference():
    """bf16 tiles, float32 x: the output and dX are float32, within 1e-5
    of the largest |value| of the reference's interpret-mode kernel and
    ``jax.grad`` (float32 sums in other orders)."""
    rng = np.random.default_rng(2)
    n_rb, n_cb, bm, bn, d = 4, 5, 16, 16, 24
    keep = rng.random((n_rb, 1, n_cb, 1)) < 0.5
    dense = (rng.normal(size=(n_rb, bm, n_cb, bn)) * keep).reshape(
        n_rb * bm, n_cb * bn).astype(np.float32)
    jt, jc = jspmm.dense_to_block_ell_ranked(
        jnp.asarray(dense).astype(jnp.bfloat16), bm, bn, n_cb)
    x = rng.normal(size=(n_cb * bn, d)).astype(np.float32)
    g = rng.normal(size=(n_rb * bm, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda xx: jops.spmm_ell(jt, jc, xx),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    assert want.dtype == want_dx.dtype == jnp.float32
    tt = torch.from_numpy(_bits(jt).view(np.int16).copy()).view(
        torch.bfloat16)
    tc = torch.from_numpy(np.array(jc))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tops.spmm_ell(tt, tc, tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    assert out.dtype == dx.dtype == torch.float32
    for got, ref in ((out, want), (dx, want_dx)):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err
    np.testing.assert_array_equal(
        tspmm.spmm_ell_dx(tt, tc, torch.from_numpy(g), n_cb * bn).numpy(),
        dx.numpy())
    # the routes the wrappers take, and the pairs they refuse
    assert tspmm.route_of(tt, tx) == ("bf16_f32", 2)
    with pytest.raises(ValueError, match="bfloat16 tiles with a float32"):
        tspmm.route_of(tt.float(), tx.bfloat16())


# ---------------------------------------------------------------------------
# One training step on each backend, and a resumed bf16 run
# ---------------------------------------------------------------------------

def _tcfg(jcfg):
    return TM.GCNConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)
                           if f.name not in ("elementwise_impl",
                                             "spmm_impl")})


@pytest.mark.parametrize("spmm_impl", ["dense", "ell"])
def test_bf16_train_step_matches_reference(data, spmm_impl):
    """One step through ``fourd.value_and_grad`` and ``make_train_step``
    with ``block_dtype="bf16"`` (the fused extraction and tail) against the
    reference's with its sample injected: the bf16 blocks bit for bit,
    the loss within 1e-5 relative and each gradient leaf within 1e-4 of
    its largest |value|, the float32 path's limits."""
    ds, jcfg, np_params = data
    kw = dict(spmm_impl=spmm_impl, fused_elementwise=True, dropout=0.0,
              block_dtype="bf16", ell_tile=TILE, ell_slots=BATCH // TILE)
    jpg = jbuild(ds, g=1)
    jplan = jfourd.build_plan(jpg, jcfg, jfourd.make_mesh_4d(1, 1),
                              batch=BATCH,
                              opts=jfourd.TrainOptions(extract_impl="pallas",
                                                       **kw))
    jgraph = jplan.shard_graph(jpg)
    jloss = jfourd.make_loss_fn(jplan)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jgraph, jnp.asarray(0)).mean()))(
        jplan.shard_params(jax.tree.map(jnp.asarray, np_params)))
    tplan = tfourd.build_plan(tbuild(ds, g=1), _tcfg(jcfg),
                              tfourd.make_mesh_4d(1, 1, "cpu"), batch=BATCH,
                              opts=TrainOptions(extract_impl="cuda", **kw))
    assert tplan.builder.block_dtype == torch.bfloat16
    tgraph = tplan.shard_graph(tbuild(ds, g=1))
    ids = torch.from_numpy(np.array(jplan.builder.sample_ids(0, None, 0)))
    s = jnp.asarray(np.asarray(ids[0]))
    jblk = jax.jit(lambda: jplan.builder.extract_block(
        *(jnp.asarray(a[0, 0]) for a in (jpg.block_rp, jpg.block_ci,
                                         jpg.block_val)),
        s, s, col_scale=jplan.builder.rescale_constants()[0], diag=True))()
    mb = tfourd.make_loss_fn(tplan).sample(tgraph, 0, ids=ids)
    for a, b in zip(jax.tree.leaves(jblk), leaves(mb.adj[0])):
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(b), _bits(a))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tp = TM.params_from_numpy(np_params, device="cpu")
    tl, tg = tfourd.value_and_grad(tfourd.make_loss_fn(tplan), tp, tgraph,
                                   0, ids=ids)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    tstep = tfourd.make_train_step(tplan, topt.Sgd(lr=1.0))
    jstep = jfourd.make_train_step(jplan, jopt.Sgd(lr=1.0))
    jp = jplan.shard_params(jax.tree.map(jnp.asarray, np_params))
    tp = TM.params_from_numpy(np_params, device="cpu")
    jp, _, jl2 = jstep(jp, jopt.Sgd(lr=1.0).init(jp), jgraph, jnp.asarray(0))
    tp, _, tl2 = tstep(tp, topt.Sgd(lr=1.0).init(tp), tgraph, 0, ids=ids)
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-5)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-4 * max(
            np.abs(b).max(), 1e-30)


def test_bf16_run_resumes_bit_for_bit_with_its_prefetched_blocks(data,
                                                                  tmp_path):
    """``Trainer`` with ``block_dtype="bf16"`` and prefetch (the carry holds
    the next batch's bf16 tiles): 4 steps straight equal 2 steps, a
    checkpoint, a restore and 2 more, losses and state bit for bit; the
    restored carry is bf16 again."""
    ds, jcfg, np_params = data
    plan = tfourd.build_plan(
        tbuild(ds, g=1), _tcfg(jcfg), tfourd.make_mesh_4d(1, 1, "cpu"),
        batch=BATCH, opts=TrainOptions(
            spmm_impl="ell", fused_elementwise=True, extract_impl="cuda",
            dropout=0.3, seed=4, block_dtype="bf16", ell_tile=TILE,
            ell_slots=BATCH // TILE))
    graph = plan.shard_graph(tbuild(ds, g=1))
    params = TM.params_from_numpy(np_params, device="cpu")
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params)

    def trainer(steps, ckpt):
        return Trainer(plan, topt.AdamW(lr=1e-2, weight_decay=1e-4,
                                        grad_clip=1.0),
                       TrainLoopConfig(total_steps=steps, chunk_size=2,
                                       prefetch=True, ckpt_dir=ckpt,
                                       ckpt_every=2),
                       eval_fn=lambda p, g: 0.0)

    full = trainer(4, None)
    st_full, log_full = full.run(full.init_state(fresh(), graph), graph)
    assert st_full.minibatch.adj[0][0].dtype == torch.bfloat16
    part = trainer(2, str(tmp_path))
    _, log_a = part.run(part.init_state(fresh(), graph), graph)
    rest = trainer(4, str(tmp_path))
    st = rest.restore(rest.init_state(fresh(), graph))
    assert st.minibatch.adj[0][0].dtype == torch.bfloat16
    st, log_b = rest.run(st, graph)
    assert log_a.losses + log_b.losses == log_full.losses
    assert all(torch.equal(a, b) for a, b in zip(leaves(st),
                                                 leaves(st_full)))
    assert np.all(np.isfinite(log_full.losses))
