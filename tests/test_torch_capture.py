"""The captured-step runtime's CPU side, against the JAX package and the
port's own eager step.

The card captures one optimizer step in a CUDA graph and replays it
(``train/runner.py``); that needs a step with no host read of a device
value. Here, on the CPU: the sync-free block-ELL conversion gives the old
(``nonzero``-based, kept below) conversion's and the reference's layouts
bit for bit; one step driven by a device-style tensor step, with the
reference's sample and dropout masks injected, matches the reference's
``fourd.make_train_step``; ``Trainer.run`` equals ``Trainer.step`` called
step by step; the run loop's replay bookkeeping, rehearsed with a
stand-in for ``torch.cuda.CUDAGraph``, gives the eager bits and captures
once per state; and the step body runs to its end on the ``meta`` device,
which refuses every read of a value, so no host sync is left in it.
"""
import contextlib
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
from repro.graphs import make_synthetic_dataset as jdataset  # noqa: E402
from repro.kernels import spmm_ell as jspmm  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import forward as tforward  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch.kernels import counter_rng as crng  # noqa: E402
from repro_torch.kernels import extract_gather as teg  # noqa: E402
from repro_torch.kernels import fused_layer as tfl  # noqa: E402
from repro_torch.kernels import spmm_ell as tspmm  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402
from repro_torch.train import runner as trunner  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

N, D_IN, D_H, CLASSES, BATCH, TILE = 2048, 16, 16, 4, 256, 32


# ---------------------------------------------------------------------------
# The sync-free block-ELL conversion
# ---------------------------------------------------------------------------

def _ranked_with_nonzero(adj, bm, bn, n_slots):
    """The conversion before it was made sync-free: the kept blocks found
    with ``nonzero`` (a device-to-host read) and scattered onto zeros."""
    r, c = adj.shape
    blocks = adj.reshape(r // bm, bm, c // bn, bn).permute(0, 2, 1, 3)
    n_rb = blocks.shape[0]
    nz = blocks.float().abs().sum(dim=(2, 3)) > 0
    rank = torch.cumsum(nz.long(), dim=1) - 1
    ok = nz & (rank < n_slots)
    rb, cb = ok.nonzero(as_tuple=True)
    slot = rank[rb, cb]
    tiles = torch.zeros((n_rb, n_slots, bm, bn), dtype=adj.dtype)
    tiles.index_put_((rb, slot), blocks[rb, cb], accumulate=True)
    colidx = torch.zeros((n_rb, n_slots), dtype=torch.int32)
    colidx[rb, slot] = cb.to(torch.int32)
    return tiles, colidx


def _ell_case(bm, bn, n_rb, n_cb, seed):
    """A dense block whose row-blocks hold every count of live column
    blocks from none to all of them, with live blocks of one entry."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n_rb * bm, n_cb * bn), dtype=np.float32)
    for rb in range(n_rb):
        live = rng.choice(n_cb, size=rb % (n_cb + 1), replace=False)
        for cb in live:
            r = rb * bm + rng.integers(bm, size=rng.integers(1, 4))
            c = cb * bn + rng.integers(bn, size=r.shape[0])
            adj[r, c] = rng.normal(size=r.shape[0])
    return adj


@pytest.mark.parametrize("bm,bn,n_rb,n_cb", [(4, 4, 7, 6), (8, 4, 9, 8),
                                             (16, 16, 5, 4)])
@pytest.mark.parametrize("n_slots", [1, 2, 3, 8])
def test_sync_free_ell_conversion_bitmatches_the_old_one_and_jax(
        bm, bn, n_rb, n_cb, n_slots):
    """Empty row-blocks, row-blocks with fewer live blocks than slots and
    with more (their blocks past the slots dropped): tiles and colidx
    bit for bit."""
    adj = _ell_case(bm, bn, n_rb, n_cb, seed=n_slots)
    t = torch.from_numpy(adj)
    per_rb = (np.abs(adj).reshape(n_rb, bm, n_cb, bn).sum((1, 3)) > 0) \
        .sum(1)
    assert per_rb.min() == 0 and per_rb.max() > n_slots or n_slots >= n_cb
    got_t, got_c = tspmm.dense_to_block_ell_ranked(t, bm, bn, n_slots)
    old_t, old_c = _ranked_with_nonzero(t, bm, bn, n_slots)
    jt, jc = jspmm.dense_to_block_ell_ranked(jnp.asarray(adj), bm, bn,
                                             n_slots)
    assert got_c.dtype == torch.int32
    for got, want in ((got_t, old_t), (got_c, old_c)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# One step from a device-style counter against the reference
# ---------------------------------------------------------------------------

def _ref_masks(seed, step, layers, shape):
    """The reference's keep-masks of the 1x1x1x1 step (its ``_dropout_key``
    with every axis index 0)."""
    out = []
    for li in range(layers):
        k = jax.random.PRNGKey(seed + 1)
        for data in (step, li, 0, 0, 0):
            k = jax.random.fold_in(k, data)
        out.append(torch.from_numpy(np.array(
            jax.random.bernoulli(k, 0.7, shape))))
    return out


def test_tensor_step_with_injected_sample_and_masks_matches_reference(
        monkeypatch):
    """Two SGD steps of the block-ELL plan with dropout 0.3, the step a
    0-d int32 tensor: loss within rtol 1e-5 and grads and params within
    atol 1e-5 (f32 GEMMs summed in other orders) of
    ``repro.core.fourd.make_train_step``, fed the reference's ids and
    masks, as ``tests/test_torch_train.py`` holds the int step."""
    layers, b, seed = 3, 64, 4
    ds = jdataset(n=256, num_classes=CLASSES, d_in=D_IN, avg_degree=8,
                  seed=0)
    jcfg = JM.GCNConfig(d_in=D_IN, d_hidden=32, num_layers=layers,
                        num_classes=CLASSES, dropout=0.0)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jax.random.PRNGKey(1), jcfg))
    kw = dict(spmm_impl="ell", fused_elementwise=True, dropout=0.3,
              seed=seed, ell_tile=16, ell_slots=b // 16)
    jplan = jfourd.build_plan(jbuild(ds, g=1), jcfg,
                              jfourd.make_mesh_4d(1, 1), batch=b,
                              opts=jfourd.TrainOptions(extract_impl="pallas",
                                                       **kw))
    jgraph = jplan.shard_graph(jbuild(ds, g=1))
    jloss = jfourd.make_loss_fn(jplan)
    jvg = jax.jit(jax.value_and_grad(
        lambda p, step: jloss(p, jgraph, step).mean()))
    jstep = jfourd.make_train_step(jplan, jopt.Sgd(lr=1.0))
    tcfg = TM.GCNConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)
                           if f.name not in ("elementwise_impl",
                                             "spmm_impl")})
    tplan = tfourd.build_plan(tbuild(ds, g=1), tcfg,
                              tfourd.make_mesh_4d(1, 1, "cpu"), batch=b,
                              opts=tforward.TrainOptions(extract_impl="cuda",
                                                         **kw))
    tgraph = tplan.shard_graph(tbuild(ds, g=1))
    masks, seen = {}, []

    def injected(self, step, layer, st, shape, device):
        seen.append(isinstance(step, torch.Tensor))
        return masks[layer]

    monkeypatch.setattr(tforward.ForwardEngine, "keep_mask", injected)
    tloss = tfourd.make_loss_fn(tplan)
    tstep = tfourd.make_train_step(tplan, topt.Sgd(lr=1.0))
    jp = jplan.shard_params(jax.tree.map(jnp.asarray, np_params))
    tp = TM.params_from_numpy(np_params, device="cpu")
    jo, to = jopt.Sgd(lr=1.0).init(jp), topt.Sgd(lr=1.0).init(tp)
    for step in range(2):
        masks = dict(enumerate(_ref_masks(seed, step, layers, (b, 32))))
        ids = torch.from_numpy(np.array(jplan.builder.sample_ids(step, None,
                                                                 0)))
        t_step = torch.tensor(step, dtype=torch.int32)
        jl, jg = jvg(jp, jnp.asarray(step))
        tl, tg = tfourd.value_and_grad(tloss, tp, tgraph, t_step, ids=ids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, w in zip(leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)
        jp, jo, jl2 = jstep(jp, jo, jgraph, jnp.asarray(step))
        tp, to, tl2 = tstep(tp, to, tgraph, t_step, ids=ids)
        np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-5)
        for a, w in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                       atol=1e-5)
    assert seen and all(seen) and int(to["step"]) == 2


# ---------------------------------------------------------------------------
# The run loop against the eager step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    pg = tbuild(ds, g=1)
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=2,
                       num_classes=CLASSES)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return pg, cfg, params


def _plan(small, mesh=None, **kw):
    pg, cfg, _ = small
    opts = dict(spmm_impl="ell", fused_elementwise=True, extract_impl="cuda",
                dropout=0.3, seed=4, ell_tile=TILE, ell_slots=BATCH // TILE)
    opts.update(kw)
    return tfourd.build_plan(pg, cfg, mesh or tfourd.make_mesh_4d(1, 1,
                                                                  "cpu"),
                             batch=BATCH,
                             opts=tforward.TrainOptions(**opts))


def _trainer(plan, prefetch=False, **loop):
    kw = dict(total_steps=6, chunk_size=4)
    kw.update(loop)
    return Trainer(plan, topt.AdamW(lr=topt.linear_warmup_cosine(5e-3, 2, 6),
                                    weight_decay=1e-4, grad_clip=1.0),
                   TrainLoopConfig(prefetch=prefetch, **kw),
                   eval_fn=lambda p, g: 0.0)


def _fresh(small):
    return tree_map(lambda t: t.detach().clone(), small[2])


CASES = [dict(), dict(prefetch=True),
         dict(prefetch=True, compress="int8", sample_mode="epoch"),
         dict(prefetch=True, block_dtype="bf16")]


def _eager(small, plan, prefetch, steps=6):
    tr = _trainer(plan, prefetch)
    graph = plan.shard_graph(small[0])
    st = tr.init_state(_fresh(small), graph)
    losses = [tr.step(st, graph).item() for _ in range(steps)]
    return losses, st


@pytest.mark.parametrize("case", CASES, ids=["plain", "prefetch",
                                             "prefetch-int8-epoch",
                                             "prefetch-bf16-blocks"])
def test_run_in_chunks_equals_the_eager_steps(small, case):
    """6 steps of ``Trainer.run`` in chunks of 4 (a remainder chunk) and 6
    ``Trainer.step`` calls: losses and every state leaf bit for bit, the
    counters advanced in place on the state's device."""
    case = dict(case)
    prefetch = case.pop("prefetch", False)
    plan = _plan(small, **case)
    want_losses, want = _eager(small, plan, prefetch)
    tr = _trainer(plan, prefetch)
    graph = plan.shard_graph(small[0])
    st = tr.init_state(_fresh(small), graph)
    counters = (st.step, st.epoch, st.opt_state["step"])
    st, log = tr.run(st, graph)
    assert log.losses == want_losses
    assert (log.replays, log.capture_s) == (0, 0.0)   # the CPU runs eagerly
    for a, b in zip(leaves(st), leaves(want)):
        assert torch.equal(a, b)
    assert all(a is b for a, b in zip(counters, (st.step, st.epoch,
                                                 st.opt_state["step"])))
    assert int(st.step) == 6 and st.step.dtype == torch.int32


class _StandInGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: ``replay`` runs
    the captured body again, eagerly, and writes its loss into the
    captured loss tensor, as a replay rewrites its output buffer."""

    captures = 0

    def __init__(self):
        self.body = None

    def replay(self):
        self.body()


def _stand_in_capture(trainer, state_of):
    """A stand-in for ``torch.cuda.graph``: the body runs on copies of the
    state's values, which are put back on exit, as a capture runs nothing;
    the stand-in graph then replays the trainer's step."""

    @contextlib.contextmanager
    def graph(g):
        state, data = state_of()
        saved = [t.detach().clone() for t in leaves(state)]
        _StandInGraph.captures += 1
        yield
        with torch.no_grad():
            for t, v in zip(leaves(state), saved):
                t.copy_(v)
        g.body = lambda: trainer._graph.loss.copy_(
            trainer.step(state, data))
    return graph


@pytest.mark.parametrize("prefetch", [False, True])
def test_replay_bookkeeping_gives_the_eager_bits(small, monkeypatch,
                                                 prefetch):
    """The card's run loop rehearsed on the CPU with a stand-in graph: one
    warm-up step, one capture, replays for the rest (chunks of 4 over 10
    steps, so a remainder chunk replays the same graph), the losses and
    state of 10 eager steps; a second run over the same state replays
    with no new capture; a restored state is captured again."""
    plan = _plan(small)
    want_losses, want = _eager(small, plan, prefetch, steps=10)
    tr = _trainer(plan, prefetch, total_steps=10, ckpt_every=0)
    graph = plan.shard_graph(small[0])
    st = tr.init_state(_fresh(small), graph)
    monkeypatch.setattr(trunner.Trainer, "_captures", lambda self: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        _stand_in_capture(tr, lambda: (st, graph)))
    _StandInGraph.captures = 0
    tr.total_steps = 6
    st, log = tr.run(st, graph)
    assert (log.replays, _StandInGraph.captures) == (5, 1)
    tr.total_steps = 10
    st, log2 = tr.run(st, graph)
    assert (log2.replays, _StandInGraph.captures) == (4, 1)
    assert log.losses + log2.losses == want_losses
    for a, b in zip(leaves(st), leaves(want)):
        assert torch.equal(a, b)
    # a state the graph does not hold: warm-up and capture again
    other = tr.init_state(_fresh(small), graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        _stand_in_capture(tr, lambda: (other, graph)))
    tr.total_steps = 3
    other, log3 = tr.run(other, graph)
    assert (log3.replays, _StandInGraph.captures) == (2, 2)
    assert log3.losses == want_losses[:3]


def test_a_failed_capture_raises_and_nothing_runs_eagerly(small,
                                                          monkeypatch):
    """No fallback: when the capture fails, ``run`` raises that error after
    the warm-up step, and no further step runs eagerly in its place."""
    plan = _plan(small)
    tr = _trainer(plan)
    graph = plan.shard_graph(small[0])
    st = tr.init_state(_fresh(small), graph)

    @contextlib.contextmanager
    def failing(g):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
        yield

    monkeypatch.setattr(trunner.Trainer, "_captures", lambda self: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", failing)
    with pytest.raises(RuntimeError, match="capturing"):
        tr.run(st, graph)
    assert int(st.step) == 1 and tr._graph is None


P2P_CASES = [
    (2, dict(overlap_impl="ring"), ['overlap_impl="ring"']),
    (2, dict(compress="int8"), ["compress='int8'"]),
    (2, dict(compress="int4", compress_schedule="variable"),
     ["compress='int4'"]),
    (2, dict(reshard_impl="permute"), ['reshard_impl="permute"']),
    (2, dict(overlap_impl="ring", compress="int8", reshard_impl="permute"),
     ['overlap_impl="ring"', "compress='int8'", 'reshard_impl="permute"']),
    (2, dict(compress="bf16", bf16_collectives=True), []),
    (1, dict(overlap_impl="ring", compress="int8", reshard_impl="permute"),
     []),
]


@pytest.mark.parametrize("g,opts,names", P2P_CASES,
                         ids=["ring", "int8", "int4-variable", "permute",
                              "all", "bf16-g2", "all-g1"])
def test_point_to_point_options_raise_in_a_captured_run(small, monkeypatch,
                                                        g, opts, names):
    """On the card, ``run`` refuses the options whose point-to-point hops
    (``batch_isend_irecv``) would be captured at g > 1, before it runs
    anything, naming each option and the ROADMAP item; the NCCL
    collectives alone (a bf16 wire) and every option at g = 1 (no hop)
    are captured. The plan is built at g = 1 and given a g x g x g mesh
    shape: the check reads only the shape and the options."""
    plan = _plan(small, **opts)
    plan = dataclasses.replace(plan, mesh=dataclasses.replace(
        plan.mesh, shape=dict(plan.mesh.shape, x=g, y=g, z=g)))
    tr = _trainer(plan)
    assert tr._p2p_options() == names
    monkeypatch.setattr(trunner.Trainer, "_captures", lambda self: True)
    monkeypatch.setattr(torch.cuda, "graph", None)   # nothing may capture
    if names:
        with pytest.raises(NotImplementedError,
                           match=r"The captured step at g > 1") as err:
            tr.run(None, None)
        for name in names:
            assert name in str(err.value)


# ---------------------------------------------------------------------------
# No host read in the step body
# ---------------------------------------------------------------------------

def _shape_only_extraction(rp, ci, val, rows, cols, **kw):
    return torch.empty((rows.shape[0], cols.shape[0]), device=rows.device)


@pytest.mark.parametrize("sample_mode", ["step", "epoch"])
def test_step_body_runs_on_the_meta_device(small, monkeypatch, sample_mode):
    """``Trainer.step`` with prefetch, dropout, the fused extraction and the
    block-ELL conversion, on the ``meta`` device, where ``.item()``,
    ``int()``, ``nonzero`` and every other read of a value raise: the body
    reaches its end, so no host sync is left in it. The CUDA wrappers run
    their plain versions here, and the extraction a shape-only stand-in:
    its plain version's ``repeat_interleave`` has no meta kernel without
    an output size (``test_cuda_eager_step_syncs_nowhere`` runs the kernel
    under ``torch.cuda.set_sync_debug_mode("error")`` on the card)."""
    for mod, name, plain in ((tspmm, "spmm_ell", tspmm.spmm_ell_plain),
                             (tspmm, "spmm_ell_dx", tspmm.spmm_ell_dx_plain),
                             (tfl, "fused_layer", tfl.fused_layer_plain),
                             (tfl, "fused_layer_bwd",
                              tfl.fused_layer_bwd_plain),
                             (teg, "extract_dense_fused",
                              _shape_only_extraction),
                             (crng, "hash_keys", crng.hash_keys_plain),
                             (crng, "keep_mask", crng.keep_mask_plain)):
        monkeypatch.setattr(mod, name, plain)
    cpu = tfourd.make_mesh_4d(1, 1, "cpu")
    plan = _plan(small, mesh=dataclasses.replace(
        cpu, device=torch.device("meta")), sample_mode=sample_mode)
    graph = plan.shard_graph(small[0])
    tr = _trainer(plan, prefetch=True)
    st = tr.init_state(tree_map(lambda t: t.to("meta"), _fresh(small)),
                       graph)
    loss = tr.step(st, graph)
    assert loss.device.type == "meta" and loss.shape == ()
    assert st.step.device.type == "meta" and st.epoch.device.type == "meta"
    with pytest.raises(RuntimeError, match="meta"):
        int(st.step)
