"""The VLM and audio families (llama-3.2-vision, whisper) of the port
against the JAX package's, on the CPU, at their float32 smoke configs.

The cross layers' gates (zero at init) are drawn N(0, 1) and whisper's
LayerNorm and MLP biases (zero at init) N(0, 0.02), so that every layer
counts: at init a cross layer adds nothing, whatever its attention
computes. The memory (image or frame embeddings) is drawn with numpy from
a seed. Weights reach the port through numpy (``params_from_numpy``);
the reference runs jitted. Tolerances are of the largest |value|: 1e-5
for logits and caches (float32 sums in another order).
The gradient and four AdamW steps are in
``tests/test_torch_llm_train_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve_llm  # noqa: E402
from repro_torch.launch import train_transformer as TTR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["llama-3.2-vision-90b", "whisper-base"]
RTOL = 1e-5
BATCH, PROMPT, STEPS = 2, 12, 4


def nonzero_leaves(tree: dict, seed: int = 1) -> dict:
    """A numpy copy of a reference pytree with the leaves that init sets
    to zero drawn instead: the cross layers' gates N(0, 1), the LayerNorm
    and MLP biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("gate_attn", "gate_mlp"):
                out[k] = rng.normal(size=np.shape(v)).astype(np.float32)
            elif k in ("bias", "b1", "b2"):
                out[k] = (0.02 * rng.normal(size=np.shape(v))).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def memory_for(cfg, batch: int, seed: int = 5) -> np.ndarray:
    """(batch, n, d_model) float32 N(0, 1): the vlm's image embeddings or
    the audio family's frame embeddings."""
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder.n_frames
    return np.random.default_rng(seed).normal(
        size=(batch, n, cfg.d_model)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(reference cfg, reference params, port cfg, port model, memory):
    seeded weights with non-zero gates and biases, both packages."""
    cfg = jconfigs.get_smoke(request.param)
    init = jax.jit(lambda k: JT.init_params(k, cfg))(jax.random.PRNGKey(0))
    tree = nonzero_leaves(jax.tree.map(np.asarray, init))
    tcfg = tconfigs.get_smoke(request.param)
    return (cfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TT.params_from_numpy(tree, tcfg, "cpu"), memory_for(cfg, BATCH))


def _prompts(cfg, s=PROMPT, seed=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, s),
                                                dtype=np.int32)


def test_sinusoidal_table_matches():
    """Within two float32 ulps of a 1500-rad angle (2.4e-4): the two
    frameworks' ``exp`` part by an ulp in some frequencies (21 of 256 at
    d 512), and the angle, up to 1500 rad, by an ulp with it."""
    for d in (2, 128, 512):
        pos = np.arange(0, 1500, 7)
        want = np.asarray(JT._sinusoidal(jnp.asarray(pos), d))
        got = TT._sinusoidal(torch.from_numpy(pos), d).numpy()
        np.testing.assert_allclose(got, want, atol=2.5e-4, rtol=0)
    rows = torch.tensor([[3], [40]])                 # decode's (B, 1)
    assert TT._sinusoidal(rows, 64).shape == (2, 1, 64)


@pytest.mark.parametrize("kv_heads,t", [(2, 48), (4, 1500)])
def test_cross_attention_block_matches(kv_heads, t):
    """A memory no multiple of 512 (the reference halves its block) and
    whisper's 1500 frames; GQA and MHA."""
    rng = np.random.default_rng(2)
    d, h, hd = 64, 4, 16
    p = {name: (0.1 * rng.normal(size=shape)).astype(np.float32)
         for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv_heads * hd)),
                             ("wv", (d, kv_heads * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    mem = rng.normal(size=(2, t, d)).astype(np.float32)
    want = JL.cross_attention_block(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(mem), n_heads=h, n_kv=kv_heads, hd=hd)
    got, (k, v) = TL.cross_attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(mem), n_heads=h, n_kv=kv_heads, hd=hd,
        return_kv=True)
    assert _rel(got.numpy(), want) <= RTOL
    np.testing.assert_allclose(
        k.numpy(), (mem @ p["wk"]).reshape(2, t, kv_heads, hd), atol=1e-5)


def test_forward_train_matches_the_reference(family):
    cfg, params, tcfg, model, mem = family
    toks = _prompts(cfg, 16)
    want, aux = jax.jit(lambda p, t, m: JT.forward_train(
        p, t, cfg, memory=m))(params, jnp.asarray(toks), jnp.asarray(mem))
    got, taux = TT.forward_train(model, torch.from_numpy(toks), tcfg,
                                 memory=torch.from_numpy(mem))
    assert _rel(got.detach().numpy(), want) <= RTOL
    assert float(taux) == float(aux) == 0.0
    np.testing.assert_array_equal(
        TT.forward(model, torch.from_numpy(toks), tcfg,
                   memory=torch.from_numpy(mem)).numpy(),
        got.detach().numpy())


def _reference_greedy(cfg, params, prompts, mem, steps):
    """The reference's jitted prefill and ``steps`` greedy decode steps:
    (each call's last-position logits, the greedy tokens (B, steps + 1),
    the final cache)."""
    logits, cache = jax.jit(lambda p, t, m: JT.prefill(
        p, t, cfg, max_len=prompts.shape[1] + steps + 1, memory=m))(
            params, jnp.asarray(prompts), jnp.asarray(mem))
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, cfg))
    out, toks = [], []
    for step in range(steps + 1):
        if step:
            logits, cache = decode(params, tok, cache)
        out.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return out, np.concatenate(toks, axis=1), cache


def test_prefill_and_decode_match_the_reference(family):
    """``prefill(memory=)`` and 4 decode steps fed the reference's greedy
    tokens: every call's logits, and the final ``self_kv`` and
    ``cross_kv`` (the vlm's self layers only; written once by the
    prefill) at the same ``pos``."""
    cfg, params, tcfg, model, mem = family
    prompts = _prompts(cfg)
    want, toks, cache = _reference_greedy(cfg, params, prompts, mem, STEPS)
    logits, tcache = TT.prefill(model, torch.from_numpy(prompts), tcfg,
                                max_len=PROMPT + STEPS + 1,
                                memory=torch.from_numpy(mem))
    got = [logits[:, -1].numpy()]
    for j in range(STEPS):
        logits, tcache = TT.decode_step(
            model, torch.from_numpy(toks[:, j:j + 1]), tcache, tcfg)
        got.append(logits[:, -1].numpy())
    for a, w in zip(got, want):
        assert _rel(a, w) <= RTOL
    assert int(tcache["pos"]) == int(cache["pos"]) == PROMPT + STEPS
    assert sorted(tcache) == sorted(cache) == ["cross_kv", "pos", "self_kv"]
    for key in ("self_kv", "cross_kv"):
        for kv in ("k", "v"):
            a, w = tcache[key][kv].numpy(), np.asarray(cache[key][kv])
            assert a.shape == w.shape, key
            assert _rel(a, w) <= RTOL, (key, kv)


def test_legacy_loop_matches_the_reference(family):
    """``launch/serve_llm.py``'s ``legacy_generate`` with the memory: the
    reference's greedy tokens at every step, free running."""
    cfg, params, tcfg, model, mem = family
    prompts = _prompts(cfg, seed=9)
    want, toks, _ = _reference_greedy(cfg, params, prompts, mem, 7)
    got = serve_llm.legacy_generate(model, tcfg, torch.from_numpy(prompts),
                                    8, memory=torch.from_numpy(mem))
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    for a, w in zip(got["logits"], want):
        assert _rel(a.numpy(), w) <= RTOL


def test_params_round_trip_bit_for_bit(family):
    cfg, params, tcfg, model, _ = family
    back = TT.params_to_numpy(TT.params_from_numpy(
        TT.params_to_numpy(model), tcfg, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    if cfg.family == "vlm":
        gates = [b.gate_attn for b in model.cross_blocks]
        assert all(g.dim() == 0 and g.dtype == torch.float32 for g in gates)


def test_bf16_weights_keep_float32_gates():
    tcfg = dataclasses.replace(tconfigs.get_smoke("llama-3.2-vision-90b"),
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tree = TT.params_to_numpy(model)
    assert tree["cross_blocks"]["gate_attn"].shape == (1,)
    back = TT.params_from_numpy(tree, tcfg, "cpu")
    assert back.cross_blocks[0].gate_mlp.dtype == torch.float32
    assert back.blocks[0].attn["wq"].dtype == torch.bfloat16


def test_memory_is_checked():
    """The vlm and audio families need a memory of the config's length
    (the vlm's in the compute dtype); the others take none."""
    vlm = tconfigs.get_smoke("llama-3.2-vision-90b")
    audio = tconfigs.get_smoke("whisper-base")
    dense = tconfigs.get_smoke("tinyllama-1.1b")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for cfg, mem, match in (
            (vlm, None, "needs a memory of 32 image"),
            (audio, None, "needs a memory of 48 frame"),
            (vlm, torch.zeros((1, 31, 128)), "expected"),
            (audio, torch.zeros((2, 48, 128)), "expected"),
            (vlm, torch.zeros((1, 32, 128), dtype=torch.float64),
             "compute dtype"),
            (dense, torch.zeros((1, 32, 64)), "takes no memory")):
        model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match=match):
            TT.forward_train(model, toks, cfg, memory=mem)
        with pytest.raises(ValueError, match=match):
            TT.prefill(model, toks, cfg, 8, memory=mem)
    bad = dataclasses.replace(vlm, n_layers=5)
    with pytest.raises(ValueError, match="whole groups"):
        TT.init_cache(bad, 1, 8, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_through_the_legacy_loop(arch, capsys):
    """The CLI takes both ids, falls back to the legacy loop with the
    example's note and draws the memory stub after the prompts."""
    out = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--prompt-len", "10", "--new-tokens", "3"])
    assert out["tokens"] == 6 and "stats" not in out
    printed = capsys.readouterr().out
    fam = tconfigs.get_smoke(arch).family
    assert f"[{fam} family has no slot scheduling yet; falling back to " \
        "--legacy-loop]" in printed
    cfg = tconfigs.get_smoke(arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 10))
    stub = serve_llm.memory_stub(cfg, 2, rng, torch.device("cpu"))
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = serve_llm.legacy_generate(
        model, cfg, torch.as_tensor(prompts, dtype=torch.int32), 3,
        memory=stub)
    np.testing.assert_array_equal(np.stack(out["outputs"]),
                                  again["tokens"].numpy())


def test_training_refuses_both_families_but_has_their_gradient():
    """``train`` and the CLI refuse the vlm and audio families with the
    example's message; ``loss_and_grads`` needs their memory."""
    for arch in ARCHS:
        cfg = tconfigs.get_smoke(arch)
        with pytest.raises(ValueError, match="targets decoder-only"):
            TTR.train(cfg, steps=1, batch=1, seq=8, device="cpu")
        with pytest.raises(ValueError, match="targets decoder-only"):
            TTR.main(["--device", "cpu", "--arch", arch, "--steps", "1"])
        model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               trainable=True)
        toks = torch.zeros((1, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="needs a memory"):
            TTR.loss_and_grads(model, toks, toks, cfg)
