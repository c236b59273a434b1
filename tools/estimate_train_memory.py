#!/usr/bin/env python3
"""Estimate the activations a training step keeps, on the meta device.

    PYTHONPATH=src python3 tools/estimate_train_memory.py \\
        mamba2-780m:48:1x2048:f32 zamba2-2.7b:54:1x512:f32

Each argument is ``ARCH:LAYERS:BxS:DTYPE`` (DTYPE ``bf16`` or ``f32``).
The model is built at the config's published widths with ``LAYERS``
layers on the meta device (no memory, no card: every shape, nothing
computed), and ``lm_loss(forward_train(...))`` runs through the flash
wrapper's meta route under ``torch.autograd.graph.saved_tensors_hooks``
(the VLM and audio families with a memory of the config's image tokens or
frames a row; a VLM's ``LAYERS`` is whole groups' worth, e.g. 5 for
llama-3.2-vision-90b's one cross and four self layers).
It prints the parameters' bytes and the bytes of the tensors autograd
saves for the backward, each tensor object once and the parameters left
out. Views of one tensor saved by several nodes count once a view, so the
figure is an upper bound of what the caching allocator holds at the
forward's end; the backward's transients and the optimizer come on top.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def meta_model(cfg) -> TT.Transformer:
    """``cfg``'s model with every weight an empty meta tensor."""
    e = lambda *shape, dtype=cfg.param_dtype: torch.empty(
        shape, dtype=dtype, device="meta")
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    norm = lambda: ({"scale": e(d), "bias": e(d)} if cfg.norm == "layernorm"
                    else {"scale": e(d)})
    attn = lambda: {"wq": e(d, hq), "wk": e(d, hkv), "wv": e(d, hkv),
                    "wo": e(hq, d)}
    mlp = lambda: ({"wg": e(d, f), "wu": e(d, f), "wd": e(f, d)}
                   if cfg.mlp == "swiglu" else
                   {"w1": e(d, f), "b1": e(f), "w2": e(f, d), "b2": e(d)})
    counts = TT._layer_counts(cfg)
    extra = {}
    if cfg.family == "vlm":
        gate = lambda: e(dtype=torch.float32)
        extra["cross_blocks"] = [
            TT.CrossBlock(attn(), mlp(), norm(), norm(), gate(), gate(), True)
            for _ in range(counts["cross_blocks"])]
    if cfg.family == "audio":
        extra["enc_blocks"] = [TT.EncoderBlock(attn(), norm(), norm(), mlp(),
                                               True)
                               for _ in range(counts["enc_blocks"])]
        extra["enc_norm"] = norm()
    if cfg.family == "hybrid":
        extra["shared_attn"] = TT.SharedAttnBlock(attn(), norm(), mlp(),
                                                  norm(), True)
    blocks = []
    for _ in range(counts["blocks"]):
        if cfg.family in ("ssm", "hybrid"):
            din, gn, nh, k = SSM.mamba2_split_sizes(cfg)
            f32 = torch.float32
            blocks.append(TT.MambaBlock(
                {"in_proj": e(d, 2 * din + 2 * gn + nh),
                 "conv_w": e(din + 2 * gn, k), "a_log": e(nh, dtype=f32),
                 "d_skip": e(nh, dtype=f32), "dt_bias": e(nh, dtype=f32),
                 "norm_scale": e(din), "out_proj": e(din, d)}, norm(), True))
        elif cfg.family == "moe":
            n = cfg.moe.num_experts
            ffn = {"router": e(d, n), "wg": e(n, d, f), "wu": e(n, d, f),
                   "wd": e(n, f, d)}
            if cfg.moe.shared_expert:
                ffn["shared"] = mlp()
            blocks.append(TT.MoEBlock(attn(), norm(), norm(), ffn, True))
        elif cfg.family == "audio":
            blocks.append(TT.AudioBlock(attn(), attn(), mlp(), norm(), norm(),
                                        norm(), True))
        else:
            blocks.append(TT.DenseBlock(attn(), norm(), norm(), mlp(), True))
    return TT.Transformer(cfg, e(cfg.vocab_padded, d), norm(),
                          None if cfg.tie_embeddings
                          else e(d, cfg.vocab_padded), blocks, True, **extra)


def estimate(arch: str, layers: int, b: int, s: int, dtype: str) -> tuple:
    """(parameter bytes, saved activation bytes) of one training step."""
    cfg = get_config(arch)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    cfg = dataclasses.replace(cfg, n_layers=layers, param_dtype=dt,
                              compute_dtype=dt)
    model = meta_model(cfg)
    params = {id(p) for p in model.parameters()}
    saved = {}

    def pack(t):
        if id(t) not in params and id(t._base) not in params:
            saved[id(t)] = t.numel() * t.element_size()
        return t

    toks = torch.zeros((b, s), dtype=torch.int32, device="meta")
    memory = None
    if cfg.family in TT.MEMORY_FAMILIES:
        n = (cfg.n_image_tokens if cfg.family == "vlm"
             else cfg.encoder.n_frames)
        memory = torch.zeros((b, n, cfg.d_model), dtype=dt, device="meta")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = TT.forward_train(model, toks, cfg, memory=memory)
        TT.lm_loss(logits, toks, cfg.vocab)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return n_bytes, sum(saved.values())


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for spec in argv:
        arch, layers, shape, dtype = spec.split(":")
        b, s = map(int, shape.split("x"))
        p_bytes, a_bytes = estimate(arch, int(layers), b, s, dtype)
        print(f"{arch} {layers} layers {b} x {s} {dtype}: parameters "
              f"{p_bytes / 2**30:.2f} GiB, saved activations "
              f"{a_bytes / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
