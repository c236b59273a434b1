"""Training of the MoE, SSM, hybrid, VLM and audio families: the port
against the JAX package, on the CPU.

At the float32 smoke configs of mixtral-8x7b (top-2 of 4 experts, a window
of 16), llama4-scout-17b-a16e (top-1 and the shared expert), mamba2-780m
and zamba2-2.7b (Mamba2 layers and the weight-shared attention block),
llama-3.2-vision-90b (a gated cross layer to image embeddings) and
whisper-base (the encoder over frame embeddings, cross-attention in every
decoder layer), ``train_transformer.loss_and_grads`` against
``jax.value_and_grad`` of the reference's ``lm_loss(forward_train(...,
memory=)) + 0.01 * aux`` on the same weights (``params_from_numpy``),
``TokenStream`` batch and seeded memory, and four AdamW steps against the
reference's jitted step (the reference trains the VLM and audio families
only in its dry run's ``train_step``; the steps use the port's ``AdamW`` on
``param_tree`` directly). The Mamba blocks' ``a_log`` and ``dt_bias``, the
cross layers' gates and whisper's LayerNorm and MLP biases (zeros at init)
are drawn non-zero so that their gradients count; every MoE batch drops
pairs by capacity, so the gradient through a dropped pair is held too. Tolerances as ``test_torch_llm_train.py``'s:
loss 1e-5 relative, each gradient leaf 1e-4 of its largest |.|; after four
steps each loss within 1e-4 and each param within 1e-3 of its leaf's
largest |.|, but for the elements whose gradient was float noise at every
step in both frameworks (at most ``NOISE`` of the leaf's largest |grad|):
Adam's normalised step moves such an element by up to the learning rate
whichever way its noise points, and so by a different amount in each
framework (llama4-scout's embedding row of a token seen once, an element of
-2e-10 in the port and -1.4e-8 in the reference against a row of 0.022,
moved 6.6e-6 and 3.6e-4), so each of those is held to twice the learning
rates' sum.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import linear_warmup_cosine as j_sched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train_transformer as TTR  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from test_torch_llm_train import (GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                                  TRAJ_RTOL, _assert_tree_close,
                                  _numpy_tree)
from test_torch_multimodal import memory_for, nonzero_leaves  # noqa: E402

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-2.7b", "llama-3.2-vision-90b", "whisper-base"]
BATCH, SEQ, STEPS = 2, 64, 4
NOISE = 1e-6   # a gradient element this far below its leaf's largest |.|


def _j_loss(cfg, p, toks, tgts, memory):
    logits, aux = JT.forward_train(p, toks, cfg, memory=memory)
    return JT.lm_loss(logits, tgts, cfg.vocab) \
        + 0.01 * jnp.asarray(aux, jnp.float32)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The reference's four steps (a jitted value_and_grad and AdamW
    update) from seeded weights, the Mamba blocks' ``a_log`` and
    ``dt_bias``, the gates and the biases drawn non-zero, and, for the VLM
    and audio families, a seeded memory. Returns (port cfg, initial
    weights, batches, per step (loss, grads), final params, the memory as
    a tensor or None)."""
    cfg = jconfigs.get_smoke(request.param)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.ssm is not None:
        mamba = params["blocks"]["mamba"]
        mamba["a_log"] = 0.1 + jax.random.normal(jax.random.PRNGKey(1),
                                                 mamba["a_log"].shape)
        mamba["dt_bias"] = 0.5 * jax.random.normal(jax.random.PRNGKey(2),
                                                   mamba["dt_bias"].shape)
    init = nonzero_leaves(jax.tree.map(np.asarray, params))
    params = jax.tree.map(jnp.asarray, init)
    memory = (memory_for(cfg, BATCH) if cfg.family in ("vlm", "audio")
              else None)
    opt = JAdamW(lr=j_sched(3e-3, 10, STEPS), grad_clip=1.0)

    @jax.jit
    def step(p, o, toks, tgts, mem):
        loss, grads = jax.value_and_grad(
            functools.partial(_j_loss, cfg))(p, toks, tgts, mem)
        p2, o2 = opt.update(p, grads, o)
        return p2, o2, loss, grads

    stream = TokenStream(cfg.vocab, BATCH, SEQ, seed=1, coherence=0.8)
    batches = [stream.batch_at(s) for s in range(STEPS)]
    state, per_step = opt.init(params), []
    for toks, tgts in batches:
        params, state, loss, grads = step(
            params, state, jnp.asarray(toks), jnp.asarray(tgts),
            None if memory is None else jnp.asarray(memory))
        per_step.append((float(loss), jax.tree.map(np.asarray, grads)))
    return (tconfigs.get_smoke(request.param), init, batches, per_step,
            jax.tree.map(np.asarray, params),
            None if memory is None else torch.from_numpy(memory))


def test_loss_and_grads_match_the_reference(run):
    """One gradient, every leaf (the router, the experts, the shared
    expert, a_log, dt_bias, d_skip, the conv, the shared block's leaves
    summed over its applications, the cross layers' gates, the encoder's
    leaves); an MoE batch drops pairs."""
    tcfg, init, batches, per_step, _, memory = run
    model = TT.params_from_numpy(init, tcfg, "cpu", trainable=True)
    toks, tgts = (torch.from_numpy(a) for a in batches[0])
    with TM.RouteLog() as log:
        loss, grads = TTR.loss_and_grads(model, toks, tgts, tcfg,
                                         memory=memory)
    want_loss, want_grads = per_step[0]
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_tree_close(_numpy_tree(grads), want_grads, GRAD_RTOL, "grad")
    if tcfg.moe is not None:
        assert len(log.routes) == tcfg.n_layers
        dropped = sum(int((~r.keep).sum()) for r in log.routes)
        assert dropped >= 1, "the batch dropped no (token, choice) pair"
    else:
        assert log.routes == []


def test_four_adamw_steps_match_the_reference(run):
    """The port's AdamW on ``param_tree``: each step's loss within 1e-4 and
    the params after four steps within ``TRAJ_RTOL`` (the elements of
    float-noise gradients within twice the learning rates' sum, module
    docstring); the Mamba blocks' float32 leaves stay float32."""
    tcfg, init, batches, per_step, final, memory = run
    model = TT.params_from_numpy(init, tcfg, "cpu", trainable=True)
    tree = TT.param_tree(model)
    sched = linear_warmup_cosine(3e-3, 10, STEPS)
    opt = AdamW(lr=sched, grad_clip=1.0)
    state = opt.init(tree)
    quiet = lambda g: np.abs(g) <= NOISE * np.abs(g).max()
    noise = None
    for (toks, tgts), (want_loss, want_grads) in zip(batches, per_step):
        loss, grads = TTR.loss_and_grads(model, torch.from_numpy(toks),
                                         torch.from_numpy(tgts), tcfg,
                                         memory=memory)
        assert abs(float(loss) - want_loss) <= GRAD_RTOL * abs(want_loss)
        step_noise = jax.tree.map(lambda a, b: quiet(a) & quiet(b),
                                  _numpy_tree(grads), want_grads)
        noise = step_noise if noise is None else jax.tree.map(
            np.logical_and, noise, step_noise)
        opt.update(tree, grads, state)
    lr_sum = sum(float(sched(torch.tensor(s, dtype=torch.int32)))
                 for s in range(1, STEPS + 1))
    got = _numpy_tree(tree)
    for path, want in jax.tree_util.tree_leaves_with_path(final):
        g, quiet_leaf = got, noise
        for p in path:
            g, quiet_leaf = g[p.key], quiet_leaf[p.key]
        err = np.abs(g - want)
        name = jax.tree_util.keystr(path)
        assert err[~quiet_leaf].max(initial=0.0) \
            <= TRAJ_RTOL * np.abs(want).max(), name
        assert err[quiet_leaf].max(initial=0.0) <= 2 * lr_sum, name
    assert all(x.dtype == torch.float32 for x in ttree.leaves(tree))


def test_param_tree_walks_the_reference_leaf_order(run):
    """``param_tree`` in the reference's leaf order, each stacked leaf's
    layers in turn (the vlm's self layers in ``blocks``, its cross layers
    in ``cross_blocks``, whisper's encoder in ``enc_blocks``), zamba2's
    unstacked ``shared_attn`` and whisper's ``enc_norm`` once."""
    tcfg, init, *_ = run
    model = TT.params_from_numpy(init, tcfg, "cpu")
    paths = [p for p, _ in ttree.flatten_with_paths(TT.param_tree(model))]
    ref = ["::".join(str(k.key) for k in path)
           for path, _ in jax.tree_util.tree_leaves_with_path(init)]
    counts = {"blocks": tcfg.n_layers}
    if tcfg.family == "vlm":
        n_cross = tcfg.n_layers // tcfg.cross_attn_every
        counts = {"blocks": tcfg.n_layers - n_cross, "cross_blocks": n_cross}
    if tcfg.family == "audio":
        counts["enc_blocks"] = tcfg.encoder.n_layers
    assert ["::".join(p[:-1] if p[0] in counts else p) for p in paths] \
        == [r for r in ref for _ in range(counts.get(r.split("::")[0], 1))]
    assert any(r.startswith("shared_attn") for r in ref) \
        == (tcfg.family == "hybrid")


def test_cli_trains_mamba2_on_the_cpu(capsys):
    log = TTR.main(["--device", "cpu", "--arch", "mamba2-780m",
                    "--steps", "12", "--batch", "2", "--seq", "64"])
    assert len(log.losses) == 12 and log.losses[-1] < log.losses[0]
    out = capsys.readouterr().out
    assert "training mamba2-smoke (ssm)" in out
    assert "planted bigram structure is learnable" in out
