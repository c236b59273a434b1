"""The fused tail's backward and its counter-drawn keep bits, on the CPU.

The tail's backward is a CUDA kernel of the port (``fused_layer_bwd``);
on the CPU it runs ``fused_layer_bwd_plain``, held here against the
reference's ``_fused_bwd`` through ``jax.vjp`` of its ``fused_layer_tail``
(the Pallas forward in interpret mode) with the reference's injected mask,
in every flag case. The tail takes its keep bits from a mask or from the
counter key of ``counter_rng.keep_mask``; the counter form must equal the
bytes form fed ``keep_mask_plain``'s mask bit for bit (output and all
three gradients), and so must the model forwards and a ``Trainer`` run
whose engine hands the tail keys instead of masks. The kernels themselves
are held against these plain versions on a card by
``test_torch_cuda_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import forward as tforward  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch.kernels import counter_rng as crng  # noqa: E402
from repro_torch.kernels import fused_layer as tfl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

RATE = 0.3


def _case(b, d, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    res = rng.normal(size=(b, d)).astype(np.float32)
    mask = rng.random((b, d)) < 1.0 - RATE
    g = rng.normal(size=(b, d)).astype(np.float32)
    return x, scale, res, mask, g


@pytest.mark.parametrize("has_res", [False, True])
@pytest.mark.parametrize("has_mask", [False, True])
@pytest.mark.parametrize("use_relu", [False, True])
@pytest.mark.parametrize("use_rmsnorm", [False, True])
def test_bwd_plain_matches_the_references_vjp(use_rmsnorm, use_relu,
                                              has_mask, has_res):
    """dx and d_scale of ``fused_layer_bwd_plain`` against ``jax.vjp`` of
    the reference's tail (its ``_fused_bwd``), the reference's mask
    injected; the residual's gradient is the cotangent itself: atol 1e-5."""
    b, d = 32, 24
    x, scale, res, mask, g = _case(b, d)
    kw = dict(dropout_rate=RATE, eps=1e-6, use_rmsnorm=use_rmsnorm,
              use_relu=use_relu)

    def jtail(xx, ss, rr):
        return jops.fused_layer_tail(
            xx, rr if has_res else None, ss,
            dropout_mask=jnp.asarray(mask) if has_mask else None,
            row_tile=b, **kw)

    _, vjp = jax.vjp(jtail, jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(res))
    jdx, jds, jdr = vjp(jnp.asarray(g))
    dx, ds = tfl.fused_layer_bwd_plain(
        torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(mask) if has_mask else None, **kw)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jdr),
                                  g if has_res else np.zeros_like(g))
    if not use_rmsnorm:
        assert not ds.any()


@pytest.mark.parametrize("b,d", [(32, 24), (9, 33), (64, 256)])
@pytest.mark.parametrize("has_res", [False, True])
@pytest.mark.parametrize("use_rmsnorm,use_relu", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_counter_tail_equals_bytes_tail_bit_for_bit(b, d, has_res,
                                                    use_rmsnorm, use_relu):
    """``fused_layer_tail`` with ``dropout_key`` against the same call with
    ``dropout_mask=keep_mask_plain(key, b, d, rate)``: the output and the
    gradients of x, scale and the residual, bit for bit, for a key above
    2^63 too."""
    x, scale, res, _, g = _case(b, d)
    kw = dict(dropout_rate=RATE, eps=1e-6, use_rmsnorm=use_rmsnorm,
              use_relu=use_relu)
    for key in (12345, 2 ** 64 - 5):
        k = tsmp.key_tensor(key, "cpu")
        runs = []
        for src in (dict(dropout_key=k),
                    dict(dropout_mask=crng.keep_mask_plain(k, b, d, RATE))):
            tx, ts, tr = (torch.from_numpy(a).requires_grad_(True)
                          for a in (x, scale, res))
            y = tops.fused_layer_tail(tx, tr if has_res else None, ts,
                                      **src, **kw)
            (y * torch.from_numpy(g)).sum().backward()
            runs.append((y.detach(), tx.grad, ts.grad, tr.grad))
        (y1, dx1, ds1, dr1), (y2, dx2, ds2, dr2) = runs
        assert torch.equal(y1, y2) and torch.equal(dx1, dx2)
        assert torch.equal(ds1, ds2)
        if has_res:
            assert torch.equal(dr1, dr2) and torch.equal(
                dr1, torch.from_numpy(g))
        else:
            assert dr1 is None and dr2 is None
        # the key draws: some lanes dropped, so the test sees the mask
        assert not torch.equal(y1, tops.fused_layer_tail(
            torch.from_numpy(x), torch.from_numpy(res) if has_res else None,
            torch.from_numpy(scale), **kw))


def test_bwd_wrapper_on_cpu_tensors_is_the_plain_version():
    """``fused_layer_bwd`` on CPU tensors runs the plain version (either
    keep source) and counts no launch."""
    x, scale, res, mask, g = (torch.from_numpy(a) for a in _case(16, 33))
    n0 = (tfl.BWD_LAUNCHES, dict(tfl.BWD_ROUTE_LAUNCHES))
    k = tsmp.key_tensor(99, "cpu")
    for src in (dict(dropout_mask=mask), dict(dropout_key=k), {}):
        got = tfl.fused_layer_bwd(g, x, scale, dropout_rate=RATE,
                                  dropout_mask=src.get("dropout_mask"),
                                  dropout_key=src.get("dropout_key"))
        want = tfl.fused_layer_bwd_plain(
            g, x, scale, src.get("dropout_mask"), dropout_rate=RATE,
            dropout_key=src.get("dropout_key"))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tfl.BWD_LAUNCHES, tfl.BWD_ROUTE_LAUNCHES) == n0


def test_mask_and_key_together_raise():
    x, scale, res, mask, g = (torch.from_numpy(a) for a in _case(8, 16))
    k = tsmp.key_tensor(1, "cpu")
    m = mask
    with pytest.raises(ValueError, match="not both"):
        tops.fused_layer_tail(x, res, scale, dropout_mask=m, dropout_key=k,
                              dropout_rate=RATE)
    with pytest.raises(ValueError, match="not both"):
        tfl.fused_layer(x, scale, m, res, dropout_key=k, dropout_rate=RATE)
    with pytest.raises(ValueError, match="not both"):
        tfl.fused_layer_bwd(g, x, scale, m, dropout_key=k,
                            dropout_rate=RATE)
    cfg = TM.GCNConfig(d_in=4, d_hidden=16, num_layers=1, num_classes=2)
    with pytest.raises(ValueError, match="not both"):
        TM.forward(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu"), torch.eye(8), torch.ones(8, 4),
                   cfg, train=True, keep_masks=[m], dropout_keys=[k])


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 255, 256, 300, 2047, 2048,
                                  2049, 8192, 8193, 100_000])
def test_bwd_grid_covers_the_rows_with_no_idle_cta(rows):
    """The backward's launch: at most BWD_MAX_CTAS CTAs of 8 warps cover
    the rows, the last CTA has a row, and rows per warp grow only past
    8 * BWD_MAX_CTAS rows."""
    grid, rpw = tfl.bwd_grid(rows)
    per_cta = tfl.ROWS_PER_CTA * rpw
    assert 1 <= grid <= tfl.BWD_MAX_CTAS
    assert grid * per_cta >= rows > (grid - 1) * per_cta
    assert (rpw == 1) == (rows <= tfl.ROWS_PER_CTA * tfl.BWD_MAX_CTAS)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("use_rmsnorm", [True, False])
def test_model_forward_with_dropout_keys_equals_masks(impl, use_rmsnorm):
    """``gcn_model.forward`` and ``sage_forward`` handed one dropout key per
    layer give the loss and gradients of the same calls handed the keys'
    ``keep_mask`` masks, bit for bit (the plain tail and, on the CPU, the
    fused tail's plain versions)."""
    from repro_torch.core import baselines as tbl
    cfg = TM.GCNConfig(d_in=8, d_hidden=32, num_layers=2, num_classes=3,
                       use_rmsnorm=use_rmsnorm, elementwise_impl=impl)
    rng = np.random.default_rng(3)
    b = 24
    adj = torch.from_numpy((rng.random((b, b)) < 0.2).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(b, 8)).astype(np.float32))
    keys = [tsmp.key_tensor(tsmp.fold_in(5, li), "cpu") for li in range(2)]
    sage = tbl.sage_batch(torch.arange(4), [torch.arange(8).reshape(4, 2),
                                            torch.arange(12).reshape(12, 1)],
                          feats, torch.zeros(b, dtype=torch.int64))
    sizes = [f.shape[0] for f in sage.frontiers[:2]]

    def grads(fn, **drop):
        params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        for t in leaves(params):
            t.requires_grad_(True)
        loss = fn(params, **drop).square().sum()
        # without RMSNorm the plain tail leaves the scales unused
        return [loss.detach(), *torch.autograd.grad(loss, leaves(params),
                                                    allow_unused=True)]

    same = lambda a, w: (a is None and w is None) or torch.equal(a, w)

    for fn, rows in ((lambda p, **k: TM.forward(p, adj, feats, cfg,
                                                train=True, **k), [b, b]),
                     (lambda p, **k: TM.sage_forward(p, sage, cfg,
                                                     train=True, **k),
                      sizes)):
        masks = [crng.keep_mask_plain(k, r, 32, cfg.dropout)
                 for k, r in zip(keys, rows)]
        got = grads(fn, dropout_keys=keys)
        want = grads(fn, keep_masks=masks)
        assert all(same(a, w) for a, w in zip(got, want))
        assert not torch.equal(got[0], grads(fn)[0])


N, D_IN, D_H, CLASSES, BATCH, TILE = 1024, 16, 32, 4, 128, 32


@pytest.fixture(scope="module")
def small():
    ds = make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    return tbuild(ds, g=1)


@pytest.mark.parametrize("use_rmsnorm", [True, False])
def test_trainer_through_the_counter_equals_the_masks(small, monkeypatch,
                                                      use_rmsnorm):
    """The 4D step and ``Trainer`` on the CPU with the fused tail: with the
    engine handing the tail its dropout keys (``tail_draws`` forced on, as
    on the card), the first step's loss and gradients and four steps'
    losses and params equal the mask route's, bit for bit, and no mask is
    drawn."""
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=3,
                       num_classes=CLASSES, use_rmsnorm=use_rmsnorm)
    plan = tfourd.build_plan(
        small, cfg, tfourd.make_mesh_4d(1, 1, "cpu"), batch=BATCH,
        opts=tforward.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                                   extract_impl="cuda", dropout=0.3, seed=4,
                                   ell_tile=TILE, ell_slots=BATCH // TILE))
    graph = plan.shard_graph(small)
    params0 = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)

    def run():
        loss, grads = tfourd.value_and_grad(tfourd.make_loss_fn(plan),
                                            fresh(), graph, 1)
        tr = Trainer(plan, topt.AdamW(lr=5e-3, weight_decay=1e-4,
                                      grad_clip=1.0),
                     TrainLoopConfig(total_steps=4, chunk_size=2),
                     eval_fn=lambda p, g: 0.0)
        st, log = tr.run(tr.init_state(fresh(), graph), graph)
        return [loss, *leaves(grads), *leaves(st.params)], log.losses

    masks_seen = []
    real_keep_mask = crng.keep_mask

    def counted(*a, **k):
        masks_seen.append(1)
        return real_keep_mask(*a, **k)

    monkeypatch.setattr(crng, "keep_mask", counted)
    want, want_losses = run()
    assert masks_seen            # the CPU's engine hands the tail masks
    masks_seen.clear()
    monkeypatch.setattr(tforward.ForwardEngine, "tail_draws",
                        lambda self, device: True)
    got, got_losses = run()
    assert not masks_seen and got_losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tail_draws_on_meta_and_where_the_plan_says():
    """The meta device walks the card's route (the fused tail draws); a
    plan's ``draw_in_tail`` sets the fused tail's route on any device, and
    the unfused tail takes masks whatever it says."""
    cfg = TM.GCNConfig(d_in=4, d_hidden=8, num_layers=1, num_classes=2)
    fused = tforward.ForwardEngine(
        cfg=cfg, opts=tforward.TrainOptions(dropout=0.3,
                                            fused_elementwise=True),
        mesh=tfourd.make_mesh_4d(1, 1, "cpu"))
    assert fused.tail_draws(torch.device("meta"))
    for route in (True, False):
        forced = dataclasses.replace(fused, draw_in_tail=route)
        assert all(forced.tail_draws(torch.device(d)) is route
                   for d in ("cpu", "meta", "cuda"))
        unfused = dataclasses.replace(forced, opts=tforward.TrainOptions(
            dropout=0.3))
        assert not unfused.tail_draws(torch.device("cuda"))


def test_tail_draws_only_when_fused_on_the_card():
    """The engine hands the tail a key only for the fused tail on the
    card; the unfused tail and any CPU tail get keep-masks."""
    cfg = TM.GCNConfig(d_in=4, d_hidden=8, num_layers=1, num_classes=2)
    eng = tforward.ForwardEngine(cfg=cfg,
                                 opts=tforward.TrainOptions(dropout=0.3),
                                 mesh=tfourd.make_mesh_4d(1, 1, "cpu"))
    assert not eng.tail_draws(torch.device("cpu"))
    assert eng.tail_draws(torch.device("cuda")) is False
    fused = dataclasses.replace(eng, opts=tforward.TrainOptions(
        dropout=0.3, fused_elementwise=True))
    assert fused.tail_draws(torch.device("cuda"))
    assert not fused.tail_draws(torch.device("cpu"))
