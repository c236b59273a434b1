"""The port's step walk and roofline (``repro_torch.launch.roofline``) and
the kernels' cost functions, against the reference's ``analyze_hlo`` of
the same programs compiled by XLA."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import fourd as jfourd  # noqa: E402
from repro.core import gcn_model as JM  # noqa: E402
from repro.graphs import build_partitioned_graph as jbuild  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.kernels import counter_rng as crng  # noqa: E402
from repro_torch.kernels import extract_gather as eg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_layer as fl  # noqa: E402
from repro_torch.kernels import spmm_ell as sp  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def test_one_matmul_is_exactly_2mnk_as_the_reference_counts_it():
    a, b = np.zeros((64, 128), np.float32), np.zeros((128, 32), np.float32)
    got = troof.analyze_step(lambda x, y: x @ y, torch.from_numpy(a),
                             torch.from_numpy(b))
    want = jroof.analyze_hlo(_hlo(lambda x, y: x @ y, a, b))
    assert got["flops"] == 2 * 64 * 128 * 32 == want["flops"]
    # operands and result of the matmul, as the reference's proxy
    assert got["bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert got["coll_total"] == 0 and got["upper_bound"] is False
    assert set(k for k in want) <= set(got)


def test_a_python_loop_is_the_reference_s_scan():
    """A loop of 10 matmuls, unrolled by the walk, against the reference's
    ``lax.scan`` of 10, whose trip count its analyzer reads from the HLO."""
    a = np.full((32, 32), 0.01, np.float32)

    def scan(x):
        return jax.lax.scan(lambda c, _: (c @ a, None), x, None,
                            length=10)[0]

    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x

    t = torch.from_numpy(a)
    got = troof.analyze_step(loop, t, t)
    want = jroof.analyze_hlo(_hlo(scan, a))
    assert got["flops"] == 10 * 2 * 32 ** 3 == want["flops"]


def test_roofline_terms_dominance_on_the_h100():
    t = troof.roofline_terms({"flops": 67e12, "bytes": 1.0,
                              "coll_total": 1.0})
    assert t["dominant"] == "compute" and t["t_compute_s"] == 1.0
    t = troof.roofline_terms({"flops": 989e12, "bytes": 1.0,
                              "coll_total": 1.0}, dtype=torch.bfloat16)
    assert t["dominant"] == "compute" and t["t_compute_s"] == 1.0
    t = troof.roofline_terms({"flops": 1.0, "bytes": 3.35e12,
                              "coll_total": 1.0})
    assert t["dominant"] == "memory" and t["t_bound_s"] == 1.0
    t = troof.roofline_terms({"flops": 0.0, "bytes": 0.0,
                              "coll_total": 450e9})
    assert t["dominant"] == "collective" and t["t_collective_s"] == 1.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_model_flops_equal_the_reference(arch):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert INPUT_SHAPES[shape] == J_SHAPES[shape] or \
            dataclasses.astuple(INPUT_SHAPES[shape]) == dataclasses.astuple(
                J_SHAPES[shape])
        got = troof.model_flops(get_config(arch), INPUT_SHAPES[shape], 256)
        want = jroof.model_flops(j_config(arch), J_SHAPES[shape], 256)
        assert got == want, (arch, shape)
    assert get_config(arch).num_active_params() == \
        j_config(arch).num_active_params()


D_IN, D_H, LAYERS, CLASSES, BATCH = 32, 64, 3, 4, 64


@pytest.fixture(scope="module")
def gcn():
    ds = make_synthetic_dataset(n=256, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    return ds


def _port_step(ds, device, draw_in_tail=None, **opts):
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES)
    pg = tbuild(ds, g=1)
    plan = dataclasses.replace(
        tfourd.build_plan(pg, cfg, tfourd.make_mesh_4d(1, 1, "cpu"),
                          batch=BATCH, opts=tfourd.TrainOptions(**opts)),
        draw_in_tail=draw_in_tail)
    graph = plan.shard_graph(pg)
    params = plan.shard_params(TM.init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    step = torch.zeros((), dtype=torch.int64)
    if device == "meta":
        plan = dataclasses.replace(plan, mesh=dataclasses.replace(
            plan.mesh, device=torch.device("meta")))
        graph, params, step = (tree_map(lambda t: t.to("meta"), x)
                               for x in (graph, params, step))
    loss_fn = tfourd.make_loss_fn(plan)
    return lambda: tfourd.value_and_grad(loss_fn, params, graph, step)


def test_gcn_step_flops_equal_the_reference_s(gcn):
    """One loss and grad of the 3-layer GCN (g = 1, dense aggregation, d
    32/64, batch 64): the walked FLOPs against the reference's
    ``analyze_hlo`` of its jitted grad. The limit is 1 %; they are equal
    (the same GEMMs: the input projection's weight gradient only, the
    aggregation's input gradient only, both of every other product)."""
    cfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0)
    plan = jfourd.build_plan(jbuild(gcn, g=1), cfg, jfourd.make_mesh_4d(1, 1),
                             batch=BATCH)
    params = plan.shard_params(JM.init_params(jax.random.PRNGKey(1), cfg))
    graph = plan.shard_graph(jbuild(gcn, g=1))
    loss_fn = jfourd.make_loss_fn(plan)
    want = jroof.analyze_hlo(_hlo(jax.grad(
        lambda p: loss_fn(p, graph, jnp.asarray(0)).mean()), params))
    got = troof.analyze_step(_port_step(gcn, "cpu"))
    assert abs(got["flops"] - want["flops"]) <= 0.01 * want["flops"]
    assert got["flops"] == want["flops"]


@pytest.mark.parametrize("opts", [{}, dict(extract_impl="cuda",
                                           fused_elementwise=True,
                                           dropout=0.1)],
                         ids=["torch-extraction", "kernels"])
def test_the_step_walks_the_same_on_the_cpu_and_on_meta(gcn, opts):
    """The same step walked on the CPU and on the meta device: equal FLOPs
    and bytes (the kernels on this path count the same on both routes;
    the fused extraction's count is data-dependent, so its CPU count is
    at most its meta upper bound, which the walk flags). The meta device
    walks the card's step, whose fused tail draws its dropout bits from
    the key (no ``keep_mask``); the CPU walk is set to that route
    (``draw_in_tail``)."""
    cpu = troof.analyze_step(_port_step(gcn, "cpu", draw_in_tail=True,
                                        **opts))
    meta = troof.analyze_step(_port_step(gcn, "meta", **opts))
    assert cpu["flops"] > 0
    if "extract_impl" not in opts:
        assert (cpu["flops"], cpu["bytes"]) == (meta["flops"], meta["bytes"])
        assert not meta["upper_bound"]
        return
    assert meta["upper_bound"] and not cpu["upper_bound"]
    ex_c, ex_m = (w["kernels"].pop("extract_dense_fused") for w in (cpu,
                                                                    meta))
    assert ex_c["flops"] <= ex_m["flops"] and ex_c["bytes"] <= ex_m["bytes"]
    assert cpu["kernels"] == meta["kernels"]
    # as on the card: the tail draws, no keep_mask pass
    assert set(meta["kernels"]) == {"hash_keys", "fused_layer",
                                    "fused_layer_bwd"}
    # the CPU's own route hands the tail keep_mask's masks
    assert "keep_mask" in troof.analyze_step(
        _port_step(gcn, "cpu", **opts))["kernels"]
    assert (cpu["flops"] - ex_c["flops"], cpu["bytes"] - ex_c["bytes"]) == (
        meta["flops"] - ex_m["flops"], meta["bytes"] - ex_m["bytes"])


def _meta(*ts):
    return [t.to("meta") if isinstance(t, torch.Tensor) else t for t in ts]


def test_each_cost_by_hand_on_both_routes():
    """Each wrapper's cost on a tiny case, against a count by hand, the
    same on its CPU route and its meta route (the data-dependent ones on
    inputs where every slot is full, which is what the meta route
    counts)."""
    gen = torch.Generator().manual_seed(0)
    key = torch.tensor(5, dtype=torch.int64)
    # fused tail (16, 8): x, residual, out, scale, the key
    x, s = torch.randn((16, 8), generator=gen), torch.ones(8)
    cases = [
        (fl.fused_layer, (x, s, None, x),
         dict(dropout_rate=0.1, dropout_key=key),
         (7 * 128, 3 * 4 * 128 + 4 * 8 + 8)),
        (fl.fused_layer, (x, s, torch.ones((16, 8), dtype=torch.bool), None),
         dict(dropout_rate=0.1, use_rmsnorm=False),
         (2 * 128, 2 * 4 * 128 + 4 * 8 + 128)),
        (fl.fused_layer_bwd, (x, x, s, None),
         dict(dropout_rate=0.1, dropout_key=key),
         (14 * 128, 12 * 128 + 8 * 8 + 8)),
        (crng.hash_keys, (key, 100), {}, (0, 808)),
        (crng.keep_mask, (key, 4, 8, 0.1), {}, (0, 40)),
    ]
    # block-ELL with every tile dense: 2 row-blocks x 2 slots of (4, 4)
    tiles = torch.rand((2, 2, 4, 4), generator=gen) + 0.5
    colidx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    h = torch.randn((8, 3), generator=gen)
    cases += [
        (sp.spmm_ell, (tiles, colidx, h), {},
         (2 * 64 * 3, 4 * 64 + 4 * 4 + 4 * 24 + 4 * 24)),
        (sp.spmm_ell_dx, (tiles, colidx, h, 8), {},
         (2 * 64 * 3, 4 * 64 + 4 * 4 + 4 * 24 + 4 * 24)),
    ]
    # extraction: 4 rows of a complete graph on 4 vertices, max_deg 4
    rp = torch.tensor([0, 4, 8, 12, 16], dtype=torch.int32)
    ci = torch.arange(4, dtype=torch.int32).repeat(4)
    val = torch.ones(16)
    rows = torch.arange(4, dtype=torch.int32)
    cases.append((eg.extract_dense_fused, (rp, ci, val, rows, rows),
                  dict(col_scale=2.0, diag=True, max_deg=4),
                  (16 * (2 + 1) + 2 * 16,
                   4 * 4 + 8 * 4 + 8 * 16 + 4 * 4 + 4 * 16)))
    # attention (1, 4, 2, 16) over 4 keys, causal: 10 pairs a head
    q = torch.randn((1, 4, 2, 16), generator=gen)
    cases.append((fa.flash_attention, (q, q[:, :, :1], q[:, :, :1]),
                  dict(causal=True),
                  (4 * 16 * 10 * 2, 4 * (2 * 128 + 2 * 64) + 4 * 2 * 4)))
    # its backward: five products; q, out, dout, dq and k, v, dk, dv once,
    # the lse once
    kv = torch.randn((1, 4, 1, 16), generator=gen)
    cases.append((fa.flash_attention_bwd,
                  (q, kv, kv, q, torch.zeros((1, 2, 4)), q), dict(causal=True),
                  (10 * 16 * 10 * 2, 4 * (4 * 128 + 4 * 64) + 4 * 2 * 4)))
    for fn, args, kw, want in cases:
        cpu_out = fn(*args, **kw)
        meta_args = _meta(*args)
        meta_kw = {k: _meta(v)[0] for k, v in kw.items()}
        meta_out = fn(*meta_args, **meta_kw)
        outs = [cpu_out, meta_out] if isinstance(cpu_out, torch.Tensor) \
            else list(zip(cpu_out, meta_out))
        for a, b in (outs if isinstance(cpu_out, tuple) else [outs]):
            assert b.device.type == "meta" and a.shape == b.shape \
                and a.dtype == b.dtype, fn.__name__
        got_cpu = fn.cost(*args, out=cpu_out, **kw)
        got_meta = fn.cost(*meta_args, out=meta_out, **meta_kw)
        assert got_cpu == got_meta == want, (fn.__name__, got_cpu, got_meta,
                                             want)


def test_the_meta_route_checks_shapes_and_the_cuda_route_is_untouched():
    """The meta route raises on the shapes the card's would; a device that
    is neither CPU, CUDA nor meta still raises."""
    tiles = torch.empty((2, 2, 4, 4), device="meta")
    colidx = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not a multiple"):
        sp.spmm_ell(tiles, colidx, torch.empty((7, 3), device="meta"))
    with pytest.raises(ValueError, match="2-D"):
        fl.fused_layer(torch.empty((2, 3, 4), device="meta"),
                       torch.empty(4, device="meta"), None, None)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*[torch.empty((1, 4, 2, 12), device="meta")] * 3)
