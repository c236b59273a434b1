"""The port's LLM training path against the JAX package's, on the CPU.

The flash-attention backward's plain version against ``jax.vjp`` of the
reference's ``blockwise_attention`` (its custom VJP, ``_flash_bwd``) and of
``ops.flash_attention`` (the Pallas forward in interpret mode, ``_fa_bwd``);
the whole model's loss and gradients, and four AdamW steps, against
``jax.value_and_grad`` of ``lm_loss(forward_train(...)) + 0.01 * aux`` on
the same weights (``params_from_numpy``) and the same ``TokenStream``
batch, at the float32 smoke configs of tinyllama-1.1b, qwen2-0.5b (QKV
bias, tied embeddings) and command-r-plus-104b (bias-free LayerNorm);
the token stream bit for bit; the training entry point's checkpoint in the
reference's ``load_checkpoint``; and the reference's failure to train bf16
params beyond one step, which the port's ``train`` refuses up front.

Tolerances: float32 attention gradients 1e-5 of each one's largest |.|
(sums in another order); bf16 5e-2, the reference's bf16 tolerance (the
reference rounds p to bf16 inside its forward, the port's plain forward
does not); the model's loss 1e-5 relative and each gradient leaf 1e-4 of
its largest |.|, as the GNN slices hold theirs; after four AdamW steps
each step's loss within 1e-4 and the params within 1e-3 of each leaf's
largest |.| (chip_smoke's TRAJ_RTOL for the GNN's eight steps): Adam's
first steps move every element by about the learning rate whatever the
size of its gradient, so an element whose gradient is float noise moves
either way in the two frameworks (1.4e-4 and 2.3e-4 of the largest embed
and wo values at tinyllama's and command-r's smoke configs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import linear_warmup_cosine as j_sched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.launch import train_transformer as TTR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJ_RTOL = 1e-3


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# (i), (ii): the flash-attention backward
# ---------------------------------------------------------------------------

# (b, sq, t, h, kv, hd, causal, window, kv_block): g = h / kv in {1, 2, 4};
# hd 32, 128 and 80 (zamba2's shared attention); kv_block below T (and not
# dividing it) pads the reference's K/V, the ragged T
BWD_CASES = [
    (2, 64, 64, 4, 2, 32, True, None, 512),
    (2, 48, 48, 4, 4, 32, True, 16, 512),
    (1, 40, 72, 8, 2, 32, False, None, 512),
    (1, 50, 100, 4, 1, 32, False, 30, 32),
    (2, 70, 70, 4, 1, 128, True, None, 32),
    (1, 32, 32, 2, 2, 128, False, None, 512),
    (2, 70, 70, 4, 4, 80, True, None, 32),
    (1, 40, 90, 4, 2, 80, True, 25, 512),
]


def _bwd_inputs(b, sq, t, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(b, sq, h, hd), mk(b, t, kv, hd), mk(b, t, kv, hd), \
        mk(b, sq, h, hd)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _j_blockwise_vjp(q, k, v, dout, causal, window, kv_block):
    f = lambda q, k, v: JL.blockwise_attention(
        q, k, v, causal=causal, window=window, kv_block=kv_block)
    out, vjp = jax.vjp(f, q, k, v)
    return vjp(dout)


def _port_bwd(q, k, v, dout, causal, window, dtype):
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, dout))
    out, lse = tflash.flash_attention_plain(tq, tk, tv, causal, window)
    return tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                            causal, window)


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window,kv_block", BWD_CASES)
def test_plain_bwd_matches_the_reference_vjp(b, sq, t, h, kv, hd, causal,
                                             window, kv_block):
    q, k, v, dout = _bwd_inputs(b, sq, t, h, kv, hd)
    want = _j_blockwise_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)),
                            causal, window, kv_block)
    got = _port_bwd(q, k, v, dout, causal, window, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= 1e-5, name


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window,kv_block",
                         [BWD_CASES[0], BWD_CASES[4], BWD_CASES[6]])
def test_plain_bwd_bf16_matches_the_reference_vjp(b, sq, t, h, kv, hd,
                                                  causal, window, kv_block):
    q, k, v, dout = _bwd_inputs(b, sq, t, h, kv, hd, seed=3)
    want = _j_blockwise_vjp(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k, v, dout)),
                            causal, window, kv_block)
    got = _port_bwd(q, k, v, dout, causal, window, torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g.float().numpy(), w) <= 5e-2, name


@functools.partial(jax.jit, static_argnums=(4, 5))
def _j_ops_vjp(q, k, v, dout, causal, window):
    out, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, causal, window), q, k, v)
    return vjp(dout)


def test_plain_bwd_matches_the_pallas_ops_vjp():
    """``repro.kernels.ops.flash_attention``: the Pallas forward (interpret
    mode) saves (out, lse) and ``_fa_bwd`` pads T to its block."""
    q, k, v, dout = _bwd_inputs(1, 64, 100, 4, 2, 32, seed=7)
    want = _j_ops_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)), True,
                      None)
    got = _port_bwd(q, k, v, dout, True, None, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), w) <= 1e-5, name


# ---------------------------------------------------------------------------
# (iii): the whole model, one gradient and four AdamW steps
# ---------------------------------------------------------------------------

ARCHS = ["tinyllama-1.1b", "qwen2-0.5b", "command-r-plus-104b"]
BATCH, SEQ, STEPS = 2, 48, 4


def _j_loss(cfg, p, toks, tgts):
    logits, aux = JT.forward_train(p, toks, cfg)
    return JT.lm_loss(logits, tgts, cfg.vocab) \
        + 0.01 * jnp.asarray(aux, jnp.float32)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The reference's four steps (one jitted value_and_grad + AdamW
    update, as ``examples/train_transformer.py``'s ``train_step``) from
    seeded weights; qwen2's zero QKV biases made non-zero so they count.
    Returns (port cfg, initial weights, batches, per step (loss, grads),
    final params)."""
    cfg = jconfigs.get_smoke(request.param)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:
        attn = params["blocks"]["attn"]
        for i, name in enumerate(("bq", "bk", "bv")):
            attn[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(i + 1),
                                                 attn[name].shape)
    init = jax.tree.map(np.asarray, params)
    opt = JAdamW(lr=j_sched(3e-3, 10, STEPS), grad_clip=1.0)

    @jax.jit
    def step(p, o, toks, tgts):
        loss, grads = jax.value_and_grad(
            functools.partial(_j_loss, cfg))(p, toks, tgts)
        p2, o2 = opt.update(p, grads, o)
        return p2, o2, loss, grads

    stream = TokenStream(cfg.vocab, BATCH, SEQ, seed=1, coherence=0.8)
    batches = [stream.batch_at(s) for s in range(STEPS)]
    state, per_step = opt.init(params), []
    for toks, tgts in batches:
        params, state, loss, grads = step(params, state, jnp.asarray(toks),
                                          jnp.asarray(tgts))
        per_step.append((float(loss), jax.tree.map(np.asarray, grads)))
    return (tconfigs.get_smoke(request.param), init, batches, per_step,
            jax.tree.map(np.asarray, params))


def _numpy_tree(tree):
    """The port's param tree (per-layer lists) stacked into the
    reference's layout, as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return np.stack([t.detach().numpy() for t in tree])
    return tree.detach().numpy()


def _assert_tree_close(got, want, rtol, what):
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        g = got
        for p in path:
            g = g[p.key]
        assert _rel_err(g, leaf) <= rtol, (what, jax.tree_util.keystr(path),
                                           _rel_err(g, leaf))


def test_model_loss_and_grads_match_the_reference(run):
    tcfg, init, batches, per_step, _ = run
    model = TT.params_from_numpy(init, tcfg, "cpu", trainable=True)
    toks, tgts = (torch.from_numpy(a) for a in batches[0])
    loss, grads = TTR.loss_and_grads(model, toks, tgts, tcfg)
    want_loss, want_grads = per_step[0]
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_tree_close(_numpy_tree(grads), want_grads, GRAD_RTOL, "grad")


def test_four_adamw_steps_match_the_reference(run):
    """The port's AdamW on ``param_tree`` (the reference's leaf order, so
    the global norm sums the same leaves): each step's loss within 1e-4,
    and the params after four steps within ``TRAJ_RTOL``, against the
    reference's."""
    tcfg, init, batches, per_step, final = run
    model = TT.params_from_numpy(init, tcfg, "cpu", trainable=True)
    tree = TT.param_tree(model)
    opt = AdamW(lr=linear_warmup_cosine(3e-3, 10, STEPS), grad_clip=1.0)
    state = opt.init(tree)
    for (toks, tgts), (want_loss, _) in zip(batches, per_step):
        loss, grads = TTR.loss_and_grads(model, torch.from_numpy(toks),
                                         torch.from_numpy(tgts), tcfg)
        assert abs(float(loss) - want_loss) <= GRAD_RTOL * abs(want_loss)
        opt.update(tree, grads, state)
    _assert_tree_close(_numpy_tree(tree), final, TRAJ_RTOL, "params")


def test_param_tree_walks_the_reference_leaf_order(run):
    tcfg, init, *_ = run
    model = TT.params_from_numpy(init, tcfg, "cpu")
    paths = [p for p, _ in ttree.flatten_with_paths(TT.param_tree(model))]
    ref = ["::".join(str(k.key) for k in path)
           for path, _ in jax.tree_util.tree_leaves_with_path(init)]
    # each reference leaf gives its layers in turn
    assert ["::".join(p[:-1] if p[0] == "blocks" else p) for p in paths] \
        == [r for r in ref for _ in range(
            tcfg.n_layers if r.startswith("blocks") else 1)]


# ---------------------------------------------------------------------------
# (iv)-(vi): the token stream, the checkpoint, the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_token_stream_is_the_reference_bit_for_bit(seed, step):
    kw = dict(vocab_size=32000, batch=3, seq_len=50, seed=seed,
              coherence=0.8)
    for got, want in zip(TokenStream(**kw).batch_at(step),
                         JTokenStream(**kw).batch_at(step)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_checkpoint_loads_in_the_reference(tmp_path):
    cfg = tconfigs.get_smoke("command-r-plus-104b")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           trainable=True)
    log = TTR.train(cfg, steps=12, batch=2, seq=32, device="cpu",
                    ckpt_dir=str(tmp_path), params=model, log=lambda _: None)
    example = JT.init_params(jax.random.PRNGKey(0),
                             jconfigs.get_smoke("command-r-plus-104b"))
    restored, step = j_load(str(tmp_path), 12, example)
    assert step == 12 and log.ckpt.endswith("ckpt_00000012.npz")
    want = TT.params_to_numpy(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(restored):
        w = want
        for p in path:
            w = w[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), w)


def test_cli_trains_on_the_cpu(capsys):
    log = TTR.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                    "--steps", "20", "--batch", "4", "--seq", "64"])
    assert len(log.losses) == 20 and log.losses[-1] < log.losses[0]
    assert log.peak_bytes is None and log.tokens_per_s > 0
    assert "planted bigram structure is learnable" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (vii): bf16 params
# ---------------------------------------------------------------------------

def test_reference_cannot_train_bf16_params_beyond_one_step():
    """Pinned reference behaviour: one AdamW update turns bf16 params into
    float32 ones (the float32 learning rate and bias corrections promote),
    and the next ``forward_train`` fails on the scan's carry types."""
    cfg = dataclasses.replace(jconfigs.get_smoke("tinyllama-1.1b"),
                              param_dtype=jnp.bfloat16,
                              compute_dtype=jnp.bfloat16)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks = jnp.asarray(JTokenStream(cfg.vocab, 2, 16).batch_at(0)[0])
    grads = jax.tree.map(lambda p: 0.01 * p, params)      # bf16 as well
    opt = JAdamW(lr=j_sched(3e-3, 10, 4), grad_clip=1.0)
    new, _ = jax.jit(opt.update)(params, grads, opt.init(params))
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(params))
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(new))
    with pytest.raises(TypeError, match="carry"):
        JT.forward_train(new, toks, cfg)


def test_port_train_refuses_bf16_params():
    cfg = dataclasses.replace(tconfigs.get_smoke("tinyllama-1.1b"),
                              param_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        TTR.train(cfg, steps=2, batch=1, seq=8, device="cpu")
