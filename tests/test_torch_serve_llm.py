"""The port's ``LLMEngine`` (``device="cpu"``) against the JAX package's on
the same weights and the same prompt stream: the greedy completions must be
identical token for token, and the scheduler's counts equal. Then the
legacy loop (the scalar-pos ``prefill`` / ``decode_step`` of every family
the port serves) against the reference's, and the CLI.

The JAX side is the tinyllama smoke model of ``tests/conftest.py``'s
``llm_serving_setup`` (and mixtral-8x7b's smoke model for the MoE
stream, and each family's smoke model for the legacy loop); its weights
reach the port through numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
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
    driver, every prompt its full completion; ``--legacy-loop`` serves 3
    prompts of 20 tokens through the static-batch loop."""
    out = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch",
                          "5", "--prompt-len", "12", "--new-tokens", "4",
                          "--slots", "2"])
    assert out["tokens"] == 20 and out["stats"]["prefills"] == 5
    assert all(o.shape == (4,) and o.dtype == np.int32
               for o in out["outputs"])
    assert "tok/s" in capsys.readouterr().out
    # the static-batch loop, with prompts longer than mixtral's window of 16
    out = serve_llm.main(["--device", "cpu", "--arch", arch, "--legacy-loop",
                          "--batch", "3", "--prompt-len", "20",
                          "--new-tokens", "4"])
    assert out["tokens"] == 12 and len(out["outputs"]) == 3
    assert all(o.shape == (4,) and o.dtype == np.int32
               for o in out["outputs"])
    printed = capsys.readouterr().out
    assert "prefill 3x20" in printed and "falling back" not in printed


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_cli_falls_back_to_the_legacy_loop_for_ssm_families(arch, capsys):
    """The ssm and hybrid families have no slot scheduling: the CLI prints
    the example's note and serves them through the legacy loop."""
    out = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--prompt-len", "10", "--new-tokens", "3"])
    assert out["tokens"] == 6 and "stats" not in out
    assert all(o.shape == (3,) and o.dtype == np.int32
               for o in out["outputs"])
    printed = capsys.readouterr().out
    fam = get_smoke(arch).family
    assert f"[{fam} family has no slot scheduling yet; falling back to " \
        "--legacy-loop]" in printed


# (arch, prompt length): every family the port serves, and a mixtral prompt
# longer than its window of 16 (the prefill's ring reorder)
LEGACY_CASES = [("tinyllama-1.1b", 12), ("mixtral-8x7b", 12),
                ("mixtral-8x7b", 20), ("mamba2-780m", 12),
                ("zamba2-2.7b", 12)]


@pytest.fixture(scope="module")
def legacy_models():
    """Each arch's smoke model, built once: the reference's config and
    params, its jitted ``decode_step``, and the port's config and model on
    the same weights."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = jconfigs.get_smoke(arch)
            params = jax.jit(lambda k: JT.init_params(k, cfg))(
                jax.random.PRNGKey(0))
            tcfg = get_smoke(arch)
            model = TT.params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
            decode = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, cfg))
            built[arch] = cfg, params, decode, tcfg, model
        return built[arch]
    return get


@pytest.mark.parametrize("arch,s", LEGACY_CASES,
                         ids=[f"{a}-{s}" for a, s in LEGACY_CASES])
def test_legacy_loop_matches_the_reference(legacy_models, arch, s):
    """The example's legacy loop (one prefill of 2 prompts, then greedy
    decode steps to 8 new tokens): the port's ``legacy_generate`` gives the
    reference's ``prefill`` / ``decode_step`` greedy tokens, its logits
    within 1e-4 at every step, and the final cache within 1e-4 (K/V rows,
    a ring past the window, the conv and ssm states) at the same ``pos``."""
    cfg, params, decode, tcfg, model = legacy_models(arch)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (2, s),
                                                dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: JT.prefill(
        p, t, cfg, max_len=s + MAX_NEW))(params, jnp.asarray(prompts))
    want_logits, want_toks = [], []
    for step in range(MAX_NEW):
        if step:
            logits, cache = decode(params, tok, cache)
        want_logits.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want_toks.append(np.asarray(tok))
    got = serve_llm.legacy_generate(model, tcfg, torch.from_numpy(prompts),
                                    MAX_NEW)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.concatenate(want_toks, axis=1))
    for a, w in zip(got["logits"], want_logits):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4)
    port_cache = got["cache"]
    assert int(port_cache["pos"]) == int(cache["pos"]) == s + MAX_NEW - 1
    for key, ref in cache.items():
        if key == "pos":
            continue
        mine = port_cache[key]
        pairs = ([(mine[k], ref[k]) for k in ("k", "v")]
                 if isinstance(ref, dict) else [(mine, ref)])
        for a, w in pairs:
            assert tuple(a.shape) == w.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4)
