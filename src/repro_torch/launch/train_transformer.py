"""Train a transformer on the synthetic token stream — the LLM
training path: token stream -> ``forward_train`` -> ``lm_loss`` ->
backward (through the flash-attention backward kernel) -> AdamW ->
checkpoint.

Counterpart of ``examples/train_transformer.py`` with its flags, plus
``--device``. As the example, the CLI trains the reduced ``get_smoke``
config of ``--arch``; :func:`train` runs the same loop on any config (the
card's smoke test calls it at each family's published width). It runs
on the card unless ``--device cpu`` (a rehearsal on the CPU, where the
flash kernels run their plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.train_transformer \\
        --device cpu --arch tinyllama-1.1b --steps 20

Training is float32 only, as the reference trains: its AdamW turns bf16
params into float32 ones (``p - lr * ...`` promotes with the float32
learning rate), and its second ``forward_train`` then fails on the scan's
mixed carry types. The port's AdamW updates in place and would keep bf16,
a result the reference never gives, so :func:`train` refuses any other
``param_dtype``. A bf16 gradient (:func:`loss_and_grads`) is fine.

Every decoder-only family trains: dense, MoE (mixtral, llama4-scout: the
gradient flows through the capacity dispatch, a dropped pair giving none,
and the auxiliary loss), SSM (mamba2: through the chunked SSD) and hybrid
(zamba2: the shared block's gradient summed over its applications, its
attention's backward at head dim 80). The VLM and audio families
(llama-3.2-vision, whisper) have a gradient, :func:`loss_and_grads` with
their ``memory`` (the reference's dry-run ``train_step`` takes
``jax.value_and_grad`` of ``forward_train(memory=)``): it reaches the
cross layers' gates and whisper's encoder, through the flash backward at
the cross-attention's and the encoder's shapes. :func:`train` and the CLI
refuse them with the example's message, as the reference has no training
loop for them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional, Union

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, linear_warmup_cosine

AUX_WEIGHT = 0.01      # the example's weight of the MoE auxiliary loss


@dataclasses.dataclass
class LMTrainLog:
    """What a run measured: each step's loss, ms per step and tokens per
    second (the host's clock around the whole loop, the token stream's
    batches included, ended by a synchronize), the parameter count, the
    device's peak memory (None on the CPU) and the checkpoint written."""
    losses: List[float]
    ms_per_step: float
    tokens_per_s: float
    n_params: int
    peak_bytes: Optional[int] = None
    ckpt: Optional[str] = None


def _check_trainable(cfg: ModelConfig) -> None:
    """Raise unless the reference trains ``cfg``: a decoder-only family
    (its example refuses the others), and float32 params (module
    docstring)."""
    if cfg.family in TT.MEMORY_FAMILIES:
        raise ValueError(f"{cfg.name}: LM pretraining example targets "
                         "decoder-only families; the multimodal stubs are "
                         "exercised by the dry-run and smoke tests")
    if cfg.param_dtype != torch.float32:
        raise ValueError(
            f"train: param_dtype {cfg.param_dtype} is not float32. The "
            "reference cannot train such params beyond one step: its AdamW "
            "returns float32 params from bf16 ones, and its next "
            "forward_train raises TypeError on the scan's carry types. The "
            "port trains float32 params only, as the reference does")


def loss_and_grads(params: TT.Transformer, tokens: torch.Tensor,
                   targets: torch.Tensor, cfg: ModelConfig, *,
                   memory: Optional[torch.Tensor] = None,
                   attn_impl: str = "cuda", mesh=None):
    """``lm_loss(forward_train(...)) + 0.01 * aux`` and its gradients, as
    ``(loss, grads)`` with ``grads`` in the layout of
    ``TT.param_tree(params)`` (every leaf: for the vlm and audio families,
    which need ``memory``, the gates and the encoder too). With ``mesh``
    (``models/sharded.py``) the params are this rank's blocks, ``tokens``
    and ``targets`` its batch rows; the loss is the global batch's and
    the gradients are those of the blocks, summed over the ranks."""
    tree = TT.param_tree(params)
    logits, aux = TT.forward_train(params, tokens, cfg, memory=memory,
                                   attn_impl=attn_impl, mesh=mesh)
    loss = TT.lm_loss(logits, targets, cfg.vocab, mesh=mesh) \
        + AUX_WEIGHT * aux
    grads = torch.autograd.grad(loss, tree_util.leaves(tree))
    return loss.detach(), tree_util.unflatten(tree, list(grads))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _save_params(ckpt_dir: str, step: int, params: TT.Transformer) -> str:
    """The reference's checkpoint of ``params`` (its pytree of float32
    arrays, layer leaves stacked), which its ``load_checkpoint`` reads."""
    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.from_numpy(node)
    return save_checkpoint(ckpt_dir, step,
                           tensors(TT.params_to_numpy(params)))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          seed: int = 0,
          device: Optional[Union[str, torch.device]] = None,
          ckpt_dir: Optional[str] = None,
          params: Optional[TT.Transformer] = None,
          log: Callable[[str], None] = print,
          log_every: int = 25) -> LMTrainLog:
    """The example's loop: ``steps`` AdamW steps (``linear_warmup_cosine(
    3e-3, 10, steps)``, gradients clipped to norm 1) on ``TokenStream(
    coherence=0.8)`` batches of ``batch`` x ``seq`` from ``seed``, the loss
    ``lm_loss + 0.01 * aux``; raises ``AssertionError`` if the last loss is
    not below the first. ``params`` (trainable, updated in place) defaults
    to ``init_params`` from ``seed``; with ``ckpt_dir`` the final params
    are checkpointed at step ``steps``."""
    _check_trainable(cfg)
    if steps < 1:
        raise ValueError(f"train: steps={steps}, expected at least 1")
    dev = resolve_device(device)
    use_full_f32_matmul()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = TT.init_params(cfg, gen, dev, trainable=True)
    tree = TT.param_tree(params)
    n_params = sum(p.numel() for p in tree_util.leaves(tree))
    opt = AdamW(lr=linear_warmup_cosine(3e-3, 10, steps), grad_clip=1.0)
    state = opt.init(tree)
    stream = TokenStream(vocab_size=cfg.vocab, batch=batch, seq_len=seq,
                         seed=seed, coherence=0.8)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        toks, tgts = (torch.from_numpy(a).to(dev)
                      for a in stream.batch_at(step))
        loss, grads = loss_and_grads(params, toks, tgts, cfg)
        opt.update(tree, grads, state)
        losses.append(loss)
        if step % log_every == 0:
            log(f"step {step:4d}  loss {float(loss):.4f}  "
                f"t={time.perf_counter() - t0:.1f}s")
    _sync(dev)
    dt = time.perf_counter() - t0
    out = LMTrainLog(
        losses=torch.stack(losses).float().cpu().tolist(),
        ms_per_step=dt * 1e3 / steps, tokens_per_s=steps * batch * seq / dt,
        n_params=n_params,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None))
    log(f"loss: {out.losses[0]:.3f} -> {out.losses[-1]:.3f} "
        f"(planted bigram structure is learnable)")
    if not out.losses[-1] < out.losses[0]:
        raise AssertionError(f"no learning happened: {out.losses}")
    if ckpt_dir:
        out.ckpt = _save_params(ckpt_dir, steps, params)
        log(f"saved: {out.ckpt}")
    return out


def main(argv=None) -> LMTrainLog:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    _check_trainable(cfg)
    print(f"training {cfg.name} ({cfg.family}) on synthetic tokens")
    log = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                device=args.device, ckpt_dir=args.ckpt_dir)
    print(f"parameters: {log.n_params:,}; {log.ms_per_step:.2f} ms/step, "
          f"{log.tokens_per_s:.1f} tokens/s")
    return log


if __name__ == "__main__":
    main()
