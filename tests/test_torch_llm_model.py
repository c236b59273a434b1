"""The port's transformer (``repro_torch.models``) against the JAX package's
on the same weights and inputs, at the smoke configs of tinyllama-1.1b,
qwen2-0.5b (QKV bias, tied embeddings) and the MoE family's mixtral-8x7b
(top-2, a sliding window) and llama4-scout-17b-a16e (top-1, a shared
expert).

Weights go from the reference's pytree to the port through numpy
(``params_from_numpy``). Full-sequence attention on CPU tensors is the
flash kernel's plain version; the reference's is its jnp running-softmax
scan, which ``tests/test_kernels_flash.py`` holds equal to its Pallas
kernel. f32 tolerances are 1e-4 absolute (sums in another order).
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
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MOE_ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
ARCHS = ["tinyllama-1.1b", "qwen2-0.5b"] + MOE_ARCHS
# every config the port has: the dense, MoE, SSM, hybrid, VLM and audio
# families
PORTED = ARCHS + ["internlm2-1.8b", "command-r-plus-104b", "mamba2-780m",
                  "zamba2-2.7b", "llama-3.2-vision-90b", "whisper-base"]
ATOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, reference params, port cfg, port model); qwen2's
    zero-initialised QKV biases are made non-zero so that they count."""
    cfg = jconfigs.get_smoke(request.param)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:
        attn = params["blocks"]["attn"]
        keys = jax.random.split(jax.random.PRNGKey(1), 3)
        for key, name in zip(keys, ("bq", "bk", "bv")):
            attn[name] = 0.1 * jax.random.normal(key, attn[name].shape)
    tcfg = tconfigs.get_smoke(request.param)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, TT.params_from_numpy(tree, tcfg, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape,
                                                dtype=np.int32)


def test_configs_match_the_reference():
    for arch in PORTED:
        for get in ("get_config", "get_smoke"):
            ref, port = (getattr(m, get)(arch) for m in (jconfigs, tconfigs))
            rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
            for f in ("param_dtype", "compute_dtype"):
                assert (jnp.dtype(rd.pop(f)).name
                        == str(pd.pop(f)).removeprefix("torch."))
            assert rd == pd
            assert port.num_params() == ref.num_params()
            assert port.num_active_params() == ref.num_active_params()
            assert port.kv_cache_len(100) == ref.kv_cache_len(100)
    # every id of the reference's registry resolves in the port
    assert set(jconfigs.ARCH_IDS) == set(PORTED) == set(tconfigs.ARCH_IDS)
    for arch in jconfigs.ARCH_IDS:
        assert tconfigs.get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


def test_params_round_trip_through_numpy(model):
    cfg, params, tcfg, tm = model
    back = TT.params_to_numpy(tm)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_ref:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    assert sum(p.numel() for p in tm.parameters()) == \
        cfg.num_params() + cfg.d_model       # + the final norm's scale


def test_bf16_weights_keep_their_bits():
    cfg = dataclasses.replace(jconfigs.get_smoke("tinyllama-1.1b"),
                              param_dtype=jnp.bfloat16)
    params = JT.init_params(jax.random.PRNGKey(2), cfg)
    tcfg = dataclasses.replace(tconfigs.get_smoke("tinyllama-1.1b"),
                               param_dtype=torch.bfloat16)
    tm = TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert tm.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tm.blocks[1].attn["wq"].float().numpy(),
        np.asarray(params["blocks"]["attn"]["wq"][1], np.float32))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3
    p = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
         "bias": rng.normal(size=24).astype(np.float32)}
    want = JL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()}, kind, 1e-5)
    got = TL.apply_norm(_t(x), {k: _t(v) for k, v in p.items()}, kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 4, 32)).astype(np.float32)
    pos = (rng.integers(0, 500, size=(3, 7)) if per_row
           else np.arange(7)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(TL.rope(_t(x), _t(pos), 1e4).numpy(),
                               np.asarray(want), atol=1e-5)


def test_decode_attention_with_per_row_cache_len():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    for cache_len in (np.array([[1], [6], [12]], np.int32), 4):
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(cache_len))
        got = TL.decode_attention(_t(q), _t(kc), _t(vc),
                                  torch.as_tensor(cache_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_block_matches(model):
    cfg, params, tcfg, tm = model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              rope_theta=cfg.rope_theta)
    want = JL.attention_block(jp, jnp.asarray(x), positions=jnp.arange(20),
                              **kw)
    for impl in TL.ATTN_IMPLS:
        got = TL.attention_block(tm.blocks[0].attn, _t(x),
                                 positions=torch.arange(20), attn_impl=impl,
                                 **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forward_logits_match_forward_train(model):
    """Logits, and the auxiliary loss summed over the layers in float32
    (the MoE family's; zero for the dense one)."""
    cfg, params, tcfg, tm = model
    toks = _tokens(cfg, (2, 24))
    want, want_aux = JT.forward_train(params, jnp.asarray(toks), cfg)
    got = TT.forward(tm, _t(toks), tcfg)
    assert got.shape == (2, 24, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        logits, aux = TT.forward_train(tm, _t(toks), tcfg)
    np.testing.assert_array_equal(logits.numpy(), got.numpy())
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= ATOL
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_tree_round_trip_in_the_reference_leaf_order(arch):
    """``param_tree`` walks the reference's leaves in its order (each
    stacked leaf giving its layers in turn), ``blocks.moe.shared`` nested
    for llama4, and ``params_to_numpy`` of a model built from the tree's
    values gives them back."""
    cfg = jconfigs.get_smoke(arch)
    params = JT.init_params(jax.random.PRNGKey(4), cfg)
    tcfg = tconfigs.get_smoke(arch)
    tm = TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tree = TT.param_tree(tm)
    paths = [p for p, _ in ttree.flatten_with_paths(tree)]
    ref = ["::".join(str(k.key) for k in path)
           for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    assert ["::".join(p[:-1] if p[0] == "blocks" else p) for p in paths] \
        == [r for r in ref for _ in range(
            cfg.n_layers if r.startswith("blocks") else 1)]
    assert any("shared" in r for r in ref) == cfg.moe.shared_expert
    assert tree["blocks"]["moe"]["wg"][1] is tm.blocks[1].moe["wg"]
    back = TT.params_to_numpy(TT.params_from_numpy(
        TT.params_to_numpy(tm), tcfg, "cpu"))
    assert len(jax.tree_util.tree_leaves(back)) == len(ref)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_prefill_then_decode_slots_match(model):
    """Prefill two prompts into slots 2 and 0 of a 3-slot pool, then 6
    decode steps with slot 1 idle: tokens equal, logits within 1e-4, and
    the per-slot positions equal after every step."""
    cfg, params, tcfg, tm = model
    cap = 12
    jc = JT.init_slot_cache(cfg, 3, cap + 8)
    tc = TT.init_slot_cache(tcfg, 3, cap + 8, "cpu")
    toks = np.zeros((3,), np.int32)
    for slot, n, seed in ((2, 9, 4), (0, 4, 5)):
        padded = np.zeros((1, cap), np.int32)
        padded[0, :n] = _tokens(cfg, (n,), seed)
        jt, jl, jc = JT.prefill_into_slot(params, jnp.asarray(padded),
                                          jnp.asarray(n), jc,
                                          jnp.asarray(slot), cfg)
        tt, tl, tc = TT.prefill_into_slot(tm, _t(padded), n, tc, slot, tcfg)
        assert int(tt[0]) == int(jt[0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        toks[slot] = int(jt[0])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    active = np.array([True, False, True])
    for _ in range(6):
        jt, jl, jc = JT.decode_step_slots(params, jnp.asarray(toks)[:, None],
                                          jc, cfg, jnp.asarray(active))
        tt, tl, tc = TT.decode_step_slots(tm, _t(toks)[:, None], tc, tcfg,
                                          _t(active))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        toks = np.asarray(jt)
    np.testing.assert_allclose(tc["self_kv"]["k"].numpy(),
                               np.asarray(jc["self_kv"]["k"]), atol=ATOL)


def test_bf16_forward_within_reference_tolerance():
    """The whole smoke model in bf16: logits within 5e-2 of the
    reference's (bf16 rounds at other places in the two frameworks)."""
    cfg = dataclasses.replace(jconfigs.get_smoke("tinyllama-1.1b"),
                              param_dtype=jnp.bfloat16,
                              compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tconfigs.get_smoke("tinyllama-1.1b"),
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    params = JT.init_params(jax.random.PRNGKey(3), cfg)
    tm = TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = _tokens(cfg, (1, 32), seed=6)
    want, _ = JT.forward_train(params, jnp.asarray(toks), cfg)
    got = TT.forward(tm, _t(toks), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_other_families_and_paths_raise():
    # the slot API refuses the vlm and audio families with the reference's
    # own message: their cross K/V is per-request state
    for arch in ("llama-3.2-vision-90b", "whisper-base"):
        with pytest.raises(NotImplementedError,
                           match="slot-scheduled serving supports dense/moe"):
            TT.init_slot_cache(tconfigs.get_smoke(arch), 2, 8, "cpu")
    # the slot API refuses the ssm family with the reference's own message
    with pytest.raises(NotImplementedError,
                       match="slot-scheduled serving supports dense/moe"):
        TT.init_slot_cache(tconfigs.get_smoke("mamba2-780m"), 2, 8, "cpu")
    q = torch.zeros((1, 4, 2, 16))
    # a query offset is taken (the LLM mesh's); a negative one is refused
    with pytest.raises(ValueError, match="q_offset"):
        TL.blockwise_attention(q, q, q, q_offset=-2)
    with pytest.raises(ValueError, match="attn_impl"):
        TL.blockwise_attention(q, q, q, attn_impl="triton")
