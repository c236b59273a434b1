"""The port's Mamba2 / SSD (``repro_torch.models.ssm``) and its ``ssm`` and
``hybrid`` families against the JAX package's on the same seeded numpy
inputs: the SSD pieces within 1e-5 in float32 (sums in another order; of
the largest |value| for the whole block, whose random weights give outputs
in the tens), the smoke models' logits within 1e-4, and the weights' round
trip through the reference's pytree (``a_log``, ``d_skip`` and ``dt_bias``
float32 under a bf16 ``param_dtype``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.launch import train_transformer as TTR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ATOL = 1e-5
SSM_ARCHS = ["mamba2-780m", "zamba2-2.7b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(rng, b, s, h, p, g, n, state=False):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    a_log = rng.normal(scale=0.5, size=h).astype(np.float32)
    bb = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, g, n)).astype(np.float32)
    d = rng.normal(size=h).astype(np.float32)
    st = (rng.normal(size=(b, h, p, n)).astype(np.float32) if state
          else None)
    return x, dt, a_log, bb, cc, d, st


# (name, b, s, h, p, g, n, chunk, init_state)
SSD_CASES = [
    ("chunk divides S", 2, 64, 4, 8, 1, 16, 16, False),
    ("padded S", 2, 50, 4, 8, 1, 16, 16, False),
    ("init_state", 2, 48, 4, 8, 1, 16, 16, True),
    ("chunk longer than S", 1, 12, 2, 8, 1, 8, 32, True),
    ("two groups", 2, 40, 4, 8, 2, 8, 8, False),
]


@pytest.mark.parametrize("name,b,s,h,p,g,n,chunk,state", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_chunked_matches(name, b, s, h, p, g, n, chunk, state):
    """y and the final state of the chunked SSD; a chunk longer than S is
    the padded path with one chunk."""
    args = _ssd_inputs(np.random.default_rng(0), b, s, h, p, g, n, state)
    x, dt, a_log, bb, cc, d, st = args
    want_y, want_st = jax.jit(JS.ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, (x, dt, a_log, bb, cc, d)), chunk,
        None if st is None else jnp.asarray(st))
    got_y, got_st = TS.ssd_chunked(*map(_t, (x, dt, a_log, bb, cc, d)), chunk,
                                   None if st is None else _t(st))
    assert got_y.shape == (b, s, h, p) and got_st.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               atol=ATOL)


def test_segsum_masks_exactly():
    """-inf above the diagonal, which exp turns into exact zeros."""
    a = _t(np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32))
    got = TS._segsum(a)
    assert torch.isneginf(got[:, 0, 1:]).all()
    assert (torch.exp(got).triu(1) == 0).all()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JS._segsum(jnp.asarray(a.numpy()))),
                               atol=ATOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches(g):
    x, dt, a_log, bb, cc, d, st = _ssd_inputs(np.random.default_rng(2), 3, 1,
                                              4, 8, g, 16, state=True)
    sq = lambda a: a[:, 0]
    want = jax.jit(JS.ssd_decode_step)(*map(jnp.asarray, (
        sq(x), sq(dt), a_log, sq(bb), sq(cc), d, st)))
    got = TS.ssd_decode_step(*map(_t, (sq(x), sq(dt), a_log, sq(bb), sq(cc),
                                       d, st)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL)


def test_conv1d_causal_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TS._conv1d_causal(_t(x), _t(w)).numpy(),
        np.asarray(JS._conv1d_causal(jnp.asarray(x), jnp.asarray(w))),
        atol=ATOL)


def _close_to_largest(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def mamba_layer():
    """mamba2's smoke config (2 groups, so that B and C repeat over the
    heads) and one Mamba2 block's weights, every leaf random."""
    cfg = jconfigs.get_smoke("mamba2-780m")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           n_groups=2))
    tcfg = tconfigs.get_smoke("mamba2-780m")
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             n_groups=2))
    shapes = jax.tree.map(lambda a: a.shape[1:], jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg))["blocks"]["mamba"])
    rng = np.random.default_rng(4)
    p = {k: (rng.normal(scale=0.3, size=s) if k != "dt_bias"
             else rng.uniform(-1, 1, size=s)).astype(np.float32)
         for k, s in shapes.items()}
    return cfg, tcfg, p


def test_mamba2_block_matches(mamba_layer):
    """The full-sequence block over a padded S (40 tokens, chunk 32) from
    a carried state: y and the final state."""
    cfg, tcfg, p = mamba_layer
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    din, gn, nh, _ = TS.mamba2_split_sizes(tcfg)
    st = rng.normal(size=(2, nh, cfg.ssm.head_dim,
                          cfg.ssm.d_state)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax.jit(lambda q, a, b: JS.mamba2_block(q, a, cfg, b))(
        jp, jnp.asarray(x), jnp.asarray(st))
    tp = {k: _t(v) for k, v in p.items()}
    got = TS.mamba2_block(tp, _t(x), tcfg, _t(st))
    for a, w in zip(got, want):
        _close_to_largest(a, w)
    y, state, conv_in = TS.mamba2_block(tp, _t(x), tcfg, _t(st),
                                        return_conv_input=True)
    assert torch.equal(y, got[0]) and torch.equal(state, got[1])
    assert conv_in.shape == (2, 40, din + 2 * gn)


def test_mamba2_decode_matches(mamba_layer):
    cfg, tcfg, p = mamba_layer
    rng = np.random.default_rng(6)
    din, gn, nh, k = TS.mamba2_split_sizes(tcfg)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, k - 1, din + 2 * gn)).astype(np.float32)
    st = rng.normal(size=(3, nh, cfg.ssm.head_dim,
                          cfg.ssm.d_state)).astype(np.float32)
    want = jax.jit(lambda q, a, c, b: JS.mamba2_decode(q, a, cfg, c, b))(
        {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x),
        jnp.asarray(conv), jnp.asarray(st))
    got = TS.mamba2_decode({k_: _t(v) for k_, v in p.items()}, _t(x), tcfg,
                           _t(conv), _t(st))
    for a, w in zip(got, want):
        _close_to_largest(a, w)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def model(request):
    cfg = jconfigs.get_smoke(request.param)
    params = jax.jit(lambda k: JT.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke(request.param)
    return cfg, params, tcfg, TT.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def test_forward_train_matches(model):
    """Logits within 1e-4, and a float32 zero aux."""
    cfg, params, tcfg, tm = model
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 40),
                                             dtype=np.int32)
    want, want_aux = jax.jit(lambda p, t: JT.forward_train(p, t, cfg))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = TT.forward_train(tm, _t(toks), tcfg)
    assert got.shape == (2, 40, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0


def test_params_round_trip_in_the_reference_layout(model):
    """params_to_numpy gives back the reference's tree, leaf for leaf;
    param_tree walks the reference's leaves in its order (``shared_attn``
    unstacked); the parameter count is the config's plus the final norm and,
    a Mamba layer, the gated norm's d_inner beside the one d_model norm
    the config counts twice."""
    cfg, params, tcfg, tm = model
    back = TT.params_to_numpy(tm)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    paths = ["::".join(p[:-1] if p[0] == "blocks" else p)
             for p, _ in ttree.flatten_with_paths(TT.param_tree(tm))]
    ref = ["::".join(str(k.key) for k in path) for path, _ in flat]
    assert paths == [r for r in ref for _ in range(
        cfg.n_layers if r.startswith("blocks") else 1)]
    din = tcfg.ssm.d_inner(tcfg.d_model)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(params)) == (
        tcfg.num_params() + tcfg.d_model
        + tcfg.n_layers * (din - tcfg.d_model))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_params_keep_float32_ssm_leaves(arch):
    """Under a bf16 param_dtype the reference keeps a_log, d_skip and
    dt_bias in float32: so do init_params and params_from_numpy, and the
    other leaves keep their bf16 bits."""
    cfg = dataclasses.replace(jconfigs.get_smoke(arch),
                              param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                               param_dtype=torch.bfloat16)
    params = jax.jit(lambda k: JT.init_params(k, cfg))(jax.random.PRNGKey(1))
    params["blocks"]["mamba"]["a_log"] = 0.1 + jax.random.normal(
        jax.random.PRNGKey(2), params["blocks"]["mamba"]["a_log"].shape)
    for tm in (TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu"),
               TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")):
        for blk in tm.blocks:
            for name, leaf in blk.mamba.items():
                assert leaf.dtype == (torch.float32
                                      if name in TS.F32_LEAVES
                                      else torch.bfloat16), name
        assert tm.embed.dtype == torch.bfloat16
    tm = TT.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    np.testing.assert_array_equal(
        tm.blocks[1].mamba["a_log"].numpy(),
        np.asarray(params["blocks"]["mamba"]["a_log"][1]))
    back = TT.params_to_numpy(tm)
    np.testing.assert_array_equal(
        back["blocks"]["mamba"]["in_proj"],
        np.asarray(params["blocks"]["mamba"]["in_proj"], np.float32))


def test_families_the_port_does_not_serve_or_train_raise():
    """The slot API refuses the ssm family with the reference's message;
    both training entry points take the ssm and hybrid families (the
    gradient reaches a_log, dt_bias and, in zamba2, the shared block;
    ``tests/test_torch_llm_train_families.py`` holds them against the
    reference); ``loss_and_grads`` takes VLM and audio with their memory
    and raises without it, and ``train`` refuses them with the reference
    example's message; the hybrid family needs shared_attn_every to
    divide its layers."""
    cfg = tconfigs.get_smoke("mamba2-780m")
    with pytest.raises(NotImplementedError,
                       match="slot-scheduled serving supports dense/moe"):
        TT.init_slot_cache(cfg, 2, 8, "cpu")
    toks = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    for arch in SSM_ARCHS:
        c = tconfigs.get_smoke(arch)
        tm = TT.init_params(c, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        loss, grads = TTR.loss_and_grads(tm, toks, toks, c)
        assert torch.isfinite(loss)
        for name in ("a_log", "dt_bias"):
            for g in grads["blocks"]["mamba"][name]:
                assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert ("shared_attn" in grads) == (c.family == "hybrid")
    for arch in ("llama-3.2-vision-90b", "whisper-base"):
        c = tconfigs.get_smoke(arch)
        tm = TT.init_params(c, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        n = c.n_image_tokens if c.family == "vlm" else c.encoder.n_frames
        mem = torch.randn((1, n, c.d_model),
                          generator=torch.Generator().manual_seed(1))
        loss, grads = TTR.loss_and_grads(tm, toks, toks, c, memory=mem)
        assert torch.isfinite(loss)
        assert ("cross_blocks" in grads) == (c.family == "vlm")
        assert ("enc_blocks" in grads) == (c.family == "audio")
        with pytest.raises(ValueError, match="needs a memory"):
            TTR.loss_and_grads(tm, toks, toks, c)
        with pytest.raises(ValueError, match="LM pretraining example "
                                             "targets decoder-only"):
            TTR.train(c, steps=1, batch=1, seq=8, device="cpu")
    bad = dataclasses.replace(tconfigs.get_smoke("zamba2-2.7b"), n_layers=3)
    with pytest.raises(ValueError, match="shared_attn_every"):
        TT.init_cache(bad, 1, 8, "cpu")
