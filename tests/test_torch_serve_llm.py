"""The port's ``LLMEngine`` (``device="cpu"``) against the JAX package's on
the same weights and the same prompt stream: the greedy completions must be
identical token for token, and the scheduler's counts equal.

The JAX side is the tinyllama smoke model of ``tests/conftest.py``'s
``llm_serving_setup`` (and mixtral-8x7b's smoke model for the MoE
stream); its weights reach the port through numpy.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import LLMEngine as JEngine  # noqa: E402
from repro.serve import LLMServeOptions as JOptions  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve_llm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import LLMEngine, LLMServeOptions  # noqa: E402

MAX_NEW = 8
PROMPTS = [[7, 3, 11], [101, 5], [42, 42, 9, 1], [250, 8], [63],
           [12, 77, 130, 2, 2], [200, 14, 6]]
# the scheduler's counts, which both engines keep alike
COUNTS = ("completed", "device_calls", "capacity", "shed_deadline",
          "prefills", "decode_steps", "queued", "wait_high_water",
          "active_slots", "slot_occupancy", "mid_stream_refills")


@pytest.fixture(scope="module")
def port_model(llm_serving_setup):
    cfg, params = llm_serving_setup
    tcfg = get_smoke("tinyllama-1.1b")
    return tcfg, TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      "cpu")


def _engines(llm_serving_setup, port_model, **kw):
    cfg, params = llm_serving_setup
    tcfg, model = port_model
    opts = dict(slots=3, max_prompt_len=8, max_new_tokens=MAX_NEW,
                replay=True)
    opts.update(kw)
    return (JEngine(params, cfg, JOptions(**opts)),
            LLMEngine(model, tcfg, LLMServeOptions(device="cpu", **opts)))


def _stagger(eng, prompts):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, now=i * 1e-3))
        eng.pump(now=i * 1e-3)      # active slots decode between arrivals
        eng.pump(now=i * 1e-3)
    eng.drain(now=1.0)
    done = eng.take_completed()
    return [done[r] for r in rids]


def _counts(eng):
    st = eng.stats()
    return {k: st[k] for k in COUNTS}


def test_stream_larger_than_pool_gives_identical_completions(
        llm_serving_setup, port_model):
    """7 staggered prompts through 3 slots: freed slots are re-prefilled
    mid-stream, and every completion equals the JAX engine's."""
    jeng, teng = _engines(llm_serving_setup, port_model)
    want, got = _stagger(jeng, PROMPTS), _stagger(teng, PROMPTS)
    for a, b in zip(want, got):
        assert b.dtype == np.int32 and b.shape == (MAX_NEW,)
        np.testing.assert_array_equal(b, a)
    assert _counts(teng) == _counts(jeng)
    st = teng.stats()
    assert st["mid_stream_refills"] > 0 and st["prefills"] == len(PROMPTS)
    assert max(teng.backend._slot_gen) > 1
    assert st["decode_p50_ms"] > 0 and st["prefill_p50_ms"] > 0


def test_moe_stream_larger_than_pool_gives_identical_completions():
    """mixtral-8x7b's smoke model (top-2 of 4 experts, a window of 16) at
    capacity factor 0.5: 7 staggered prompts through 3 slots. A decode
    step routes every slot, free ones included, and an expert then holds
    one pair of the step, so a free slot's leftover token can take an
    active slot's place: the port's engine must feed free slots what the
    reference's engine does. Every completion equals the JAX engine's,
    free slots decode beside active ones mid-stream, and the counts are
    equal."""
    moe = lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=0.5))
    cfg = moe(jconfigs.get_smoke("mixtral-8x7b"))
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = moe(get_smoke("mixtral-8x7b"))
    model = TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
    opts = dict(slots=3, max_prompt_len=8, max_new_tokens=MAX_NEW,
                replay=True)
    jeng = JEngine(params, cfg, JOptions(**opts))
    teng = LLMEngine(model, tcfg, LLMServeOptions(device="cpu", **opts))
    want, got = _stagger(jeng, PROMPTS), _stagger(teng, PROMPTS)
    for a, b in zip(want, got):
        assert b.dtype == np.int32 and b.shape == (MAX_NEW,)
        np.testing.assert_array_equal(b, a)
    assert _counts(teng) == _counts(jeng)
    st = teng.stats()
    assert st["mid_stream_refills"] > 0 and st["prefills"] == len(PROMPTS)
    assert 0 < st["slot_occupancy"] < 1          # free slots were routed


def test_static_batching_never_refills_mid_stream(llm_serving_setup,
                                                  port_model):
    jeng, teng = _engines(llm_serving_setup, port_model, slots=2,
                          continuous=False)
    want = jeng.generate(PROMPTS[:5], now=0.0)
    got = teng.generate(PROMPTS[:5], now=0.0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert teng.stats()["mid_stream_refills"] == 0
    assert _counts(teng) == _counts(jeng)


def test_eos_id_truncates_and_frees_the_slot(llm_serving_setup, port_model):
    """An EOS id taken from a completion stops that sequence at the token
    and frees its slot; the two engines agree on every output."""
    jeng, _ = _engines(llm_serving_setup, port_model)
    seq = jeng.generate([PROMPTS[0]], now=0.0)[0]
    k = next(i for i in range(1, MAX_NEW) if seq[i] not in seq[:i])
    eos = int(seq[k])
    jeng, teng = _engines(llm_serving_setup, port_model, slots=1,
                          eos_id=eos)
    want = jeng.generate(PROMPTS[:3], now=0.0)
    got = teng.generate(PROMPTS[:3], now=0.0)
    np.testing.assert_array_equal(got[0], seq[:k + 1])     # EOS included
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert _counts(teng) == _counts(jeng)


def test_cancelled_and_shed_prompts_give_the_same_counts(llm_serving_setup,
                                                         port_model):
    """One slot: a prompt shed by its deadline while queued, and the
    decoding one cancelled, whose slot the next prompt then takes. Same
    failures, same outputs, same counts."""
    results = []
    for eng in _engines(llm_serving_setup, port_model, slots=1):
        r_active = eng.submit(PROMPTS[0], now=0.0)       # claims the slot
        r_shed = eng.submit(PROMPTS[1], now=0.0, deadline_ms=1.0)
        r_next = eng.submit(PROMPTS[2], now=0.0)
        assert eng.poll(r_shed, now=0.005) is None       # expired, queued
        failed = eng.take_failed()
        assert set(failed) == {r_shed}
        assert type(failed[r_shed]).__name__ == "Overloaded"
        eng.pump(now=0.006)
        eng.backend.cancel(r_active)                     # mid-decode
        eng.drain(now=1.0)
        done = eng.take_completed()
        assert r_active not in done
        results.append((done[r_next], _counts(eng)))
    (j_out, j_counts), (t_out, t_counts) = results
    np.testing.assert_array_equal(t_out, j_out)
    assert t_counts == j_counts and t_counts["shed_deadline"] == 1


def test_replay_streams_are_deterministic(port_model):
    tcfg, model = port_model
    runs = [LLMEngine(model, tcfg, LLMServeOptions(
        slots=3, max_prompt_len=8, max_new_tokens=MAX_NEW, replay=True,
        device="cpu")).generate(PROMPTS, now=0.0) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_cli_serves_on_the_cpu(arch, capsys):
    """``launch/serve_llm.py``: 5 prompts through 2 slots behind the
    driver, every prompt its full completion; ``--legacy-loop`` raises
    and names its ROADMAP part."""
    out = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch",
                          "5", "--prompt-len", "12", "--new-tokens", "4",
                          "--slots", "2"])
    assert out["tokens"] == 20 and out["stats"]["prefills"] == 5
    assert all(o.shape == (4,) and o.dtype == np.int32
               for o in out["outputs"])
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="scalar-pos prefill"):
        serve_llm.main(["--device", "cpu", "--arch", arch, "--legacy-loop"])
