"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same numpy inputs: the router's
top-k (ids equal, ties to the lower id), the capacity dispatch with its
drops, and the layer at both MoE smoke configs (mixtral's top-2,
llama4-scout's top-1 with its shared expert). float32 throughout; the
tolerances are a few ulps of sums taken in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MOE_ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(cfg, seed, scale=0.1):
    """Random expert weights (and llama4's shared expert) from numpy."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    p = {"router": mk(d, e) * 10, "wg": mk(e, d, f), "wu": mk(e, d, f),
         "wd": mk(e, f, d)}
    if cfg.moe.shared_expert:
        p["shared"] = {"wg": mk(d, f), "wu": mk(d, f), "wd": mk(f, d)}
    return p


def _both(p):
    to_j = lambda v: ({k: to_j(x) for k, x in v.items()}
                      if isinstance(v, dict) else jnp.asarray(v))
    to_t = lambda v: ({k: to_t(x) for k, x in v.items()}
                      if isinstance(v, dict) else _t(v))
    return to_j(p), to_t(p)


def _cfgs(arch, **moe):
    """(reference, port) smoke configs of ``arch``, their MoE settings
    replaced by ``moe``."""
    j, t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe)))


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (40, 16, 1), (7, 4, 3)])
def test_router_topk_matches(t, e, k):
    logits = np.random.default_rng(t).normal(size=(t, e)).astype(np.float32)
    jw, jids, jaux = JM.router_topk(jnp.asarray(logits), k)
    tw, tids, taux = TM.router_topk(_t(logits), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert tw.dtype == torch.float32


def test_router_ties_take_the_lower_id():
    """Zero logits: every probability ties, the ids are (0, 1) on every
    row as ``jax.lax.top_k`` gives them, and the aux loss is exactly 1;
    a row with ties among its largest takes them in id order too."""
    jw, jids, jaux = JM.router_topk(jnp.zeros((64, 8)), 2)
    tw, tids, taux = TM.router_topk(torch.zeros((64, 8)), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert (tids.numpy() == [0, 1]).all()
    assert float(taux) == float(jaux) == 1.0
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    logits = np.array([[0.0, 2.0, 1.0, 2.0, 2.0]], np.float32)
    _, jids, _ = JM.router_topk(jnp.asarray(logits), 3)
    _, tids, _ = TM.router_topk(_t(logits), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tids.numpy(), [[1, 3, 4]])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, tp = _both(_params(jcfg, 1))
    x = np.random.default_rng(2).normal(size=(2, 8, jcfg.d_model)
                                        ).astype(np.float32)
    want, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, taux = TM.moe_ffn(tp, _t(x), tcfg)
    assert got.shape == (2, 8, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_drops_what_the_reference_drops(arch):
    """A router that sends every token's first choice to expert 0, at
    capacity factor 0.5: the expert keeps its first C pairs in token
    order and drops the rest, as the reference does."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    p = _params(jcfg, 3)
    p["router"][0] = 0.0
    p["router"][0, 0] = 50.0
    x = np.random.default_rng(4).normal(size=(2, 8, jcfg.d_model)
                                        ).astype(np.float32)
    x[..., 0] = 2.0 + np.abs(x[..., 0])         # expert 0 wins every row
    jp, tp = _both(p)
    want, _ = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    with TM.RouteLog() as log:
        got, _ = TM.moe_ffn(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    (route,) = log.routes
    cap = TM.capacity(16, tcfg)
    assert cap == max(int(-(-16 * tcfg.moe.top_k // tcfg.moe.num_experts)
                          * 0.5), 1)
    assert (route.ids[:, 0] == 0).all()
    keep0 = route.keep[:, 0].numpy()
    np.testing.assert_array_equal(keep0, np.arange(16) < cap)
    assert route.real.all()
    np.testing.assert_allclose(route.logits.numpy(),
                               x.reshape(16, -1) @ p["router"], rtol=1e-5)


def test_ample_capacity_equals_dense_dispatch():
    """With ample capacity no pair drops, and the scatter dispatch equals
    the O(E * T) dense formula (every expert on every token, the router's
    k picked out), as ``tests/test_models.py`` checks the reference."""
    _, cfg = _cfgs("mixtral-8x7b", capacity_factor=8.0)
    p = _both(_params(cfg, 5))[1]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    out, aux = TM.moe_ffn(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    w, ids, _ = TM.router_topk(xt @ p["router"], 2)
    h = torch.einsum("td,edf->tef", xt, p["wg"])
    u = torch.einsum("td,edf->tef", xt, p["wu"])
    o = torch.einsum("tef,efd->ted", torch.nn.functional.silu(h) * u,
                     p["wd"])
    ref = (w[..., None] * o[torch.arange(16)[:, None], ids]).sum(1)
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), atol=1e-4)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_reads_nothing_to_the_host(arch):
    """On the meta device every shape is static and a host read raises:
    the layer runs through, so a decode step of it can be captured."""
    cfg = tconfigs.get_smoke(arch)
    p = _both(_params(cfg, 7))[1]
    meta = lambda v: ({k: meta(x) for k, x in v.items()}
                      if isinstance(v, dict) else v.to("meta"))
    out, aux = TM.moe_ffn(meta(p), torch.empty((8, 1, cfg.d_model),
                                               device="meta"), cfg)
    assert out.shape == (8, 1, cfg.d_model) and aux.shape == ()


def test_route_log_marks_the_real_rows():
    """A prefill declares its prompt's tokens real and a decode step its
    active slots; outside a log nothing is recorded."""
    cfg = tconfigs.get_smoke("mixtral-8x7b")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = TT.init_slot_cache(cfg, 3, 16, "cpu")
    toks = torch.zeros((1, 12), dtype=torch.int32)
    toks[0, :5] = torch.arange(1, 6)
    with TM.RouteLog() as log:
        TT.prefill_into_slot(model, toks, 5, cache, 1, cfg)
        active = torch.tensor([False, True, False])
        TT.decode_step_slots(model, torch.ones((3, 1), dtype=torch.int32),
                             cache, cfg, active)
    assert TM.active_log() is None
    assert len(log.routes) == 2 * cfg.n_layers
    for r in log.routes[:cfg.n_layers]:
        np.testing.assert_array_equal(r.real.numpy(), np.arange(12) < 5)
        assert r.keep.shape == (12, 2)
    for r in log.routes[cfg.n_layers:]:
        np.testing.assert_array_equal(r.real.numpy(), active.numpy())


def test_moe_training_raises_until_its_slice():
    """Its slice has come: both training entry points take the MoE family
    (``tests/test_torch_llm_train_families.py`` holds them against the
    reference). The gradient reaches the router and every expert,
    finite, and ``train`` still refuses bf16 params, as for every
    family."""
    from repro_torch.launch import train_transformer as TTR
    cfg = tconfigs.get_smoke("mixtral-8x7b")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           trainable=True)
    toks = torch.arange(16, dtype=torch.int32).reshape(1, 16)
    loss, grads = TTR.loss_and_grads(model, toks, toks, cfg)
    assert torch.isfinite(loss)
    for name in ("router", "wg", "wu", "wd"):
        for g in grads["blocks"]["moe"][name]:
            assert torch.isfinite(g).all() and g.abs().max() > 0, name
    with pytest.raises(ValueError, match="float32"):
        TTR.train(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                  steps=1, batch=1, seq=8, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_log_replays_another_logs_experts(arch):
    """A log entered with ``force`` makes each call take the recorded
    call's experts: replaying a run's own routes gives its bits again, and
    replaying other experts (ample capacity, nothing dropped) gives the
    dense formula at those experts, weighted by the call's own
    probabilities of them, renormalised (by at least 1e-9, as the
    router's own top k are)."""
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    p = _both(_params(cfg, 8))[1]
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    with TM.RouteLog() as free:
        want, _ = TM.moe_ffn(p, x, cfg)
    with TM.RouteLog(force=free.routes) as again:
        got, _ = TM.moe_ffn(p, x, cfg)
    assert torch.equal(got, want)
    assert torch.equal(again.routes[0].ids, free.routes[0].ids)
    ids = (free.routes[0].ids + 1) % cfg.moe.num_experts
    with TM.RouteLog(force=[dataclasses.replace(free.routes[0], ids=ids)]
                     ) as moved:
        got, _ = TM.moe_ffn(p, x, cfg)
        with pytest.raises(RuntimeError, match="a call more"):
            TM.moe_ffn(p, x, cfg)
    assert torch.equal(moved.routes[0].ids, ids)
    assert moved.routes[0].keep.all()
    xt = x.reshape(-1, cfg.d_model)
    w = torch.gather(torch.softmax(xt @ p["router"], -1), 1, ids)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    h = torch.einsum("td,edf->tef", xt, p["wg"])
    u = torch.einsum("td,edf->tef", xt, p["wu"])
    o = torch.einsum("tef,efd->ted", torch.nn.functional.silu(h) * u,
                     p["wd"])
    ref = (w[..., None] * o[torch.arange(16)[:, None], ids]).sum(1)
    if "shared" in p:
        ref = ref + (torch.nn.functional.silu(xt @ p["shared"]["wg"])
                     * (xt @ p["shared"]["wu"])) @ p["shared"]["wd"]
    np.testing.assert_allclose(got.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), atol=1e-4)
