"""LLM serving from the command line: prompts submitted as futures to
the same ``ServingDriver`` that fronts GNN serving, with KV-cache slot
scheduling and continuous batching behind it (``serve/llm_engine.py``),
or the static-batch loop over the scalar-pos ``prefill`` /
``decode_step`` (``--legacy-loop``).

Counterpart of ``examples/serve_llm.py``, with its flags plus
``--device``. As the example, it serves the reduced ``get_smoke`` config
of ``--arch`` (any of the ten) with seeded random weights and random
prompts, and the ``ssm``, ``hybrid``, ``vlm`` and ``audio`` families,
which have no slot scheduling in either package, fall back to the legacy
loop; the vlm and audio families' prompts come with a memory stub, drawn
as the example draws it (patch or frame embeddings). It runs on the card
unless ``--device cpu`` (a rehearsal on the CPU, where the flash kernel
runs its plain version)::

    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --device cpu --arch mixtral-8x7b --batch 4 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --device cpu --arch mamba2-780m --legacy-loop
    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --device cpu --arch whisper-base --legacy-loop
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serve import LLMEngine, LLMServeOptions, ServingDriver


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_stub(cfg: ModelConfig, batch: int, rng: np.random.Generator,
                dev: torch.device) -> Optional[torch.Tensor]:
    """The example's stand-in for the modality frontend: (batch, n, d_model)
    N(0, 1) from ``rng`` in the compute dtype, ``n`` the vlm family's
    ``n_image_tokens`` patch embeddings or the audio family's ``n_frames``
    frame embeddings; None for the other families."""
    if cfg.family not in TT.MEMORY_FAMILIES:
        return None
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder.n_frames
    return torch.as_tensor(rng.normal(size=(batch, n, cfg.d_model)),
                           dtype=cfg.compute_dtype, device=dev)


def legacy_generate(model: TT.Transformer, cfg: ModelConfig,
                    prompts: torch.Tensor, new_tokens: int, *,
                    memory: Optional[torch.Tensor] = None) -> dict:
    """The example's static-batch loop: one ``prefill`` of the (B, S)
    prompts (with ``memory``, the vlm and audio families' embeddings) for
    a horizon of S + ``new_tokens``, then ``new_tokens`` - 1 greedy
    ``decode_step`` calls. Returns the greedy ``tokens`` (B, new_tokens)
    int32, each call's last-position ``logits`` (B, Vp) in float32, the
    final ``cache``, and the prefill's and the decode loop's wall times in
    ms (the device synchronised)."""
    b, s = prompts.shape
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = TT.prefill(model, prompts, cfg, max_len=s + new_tokens,
                               memory=memory)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps = [logits[:, -1].float()]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = TT.decode_step(model, tok, cache, cfg)
        steps.append(logits[:, -1].float())
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        outs.append(tok)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": torch.cat(outs, dim=1), "logits": steps,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms, "cache": cache}


def legacy_loop(cfg: ModelConfig, model: TT.Transformer, args,
                rng: np.random.Generator, dev: torch.device) -> dict:
    """``--legacy-loop``: ``--batch`` random prompts of ``--prompt-len``
    tokens, then the memory stub (:func:`memory_stub`, from the same
    ``rng``, as the example draws them), through :func:`legacy_generate`;
    prints and returns the completions and the times."""
    b, s = args.batch, args.prompt_len
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                              dtype=torch.int32, device=dev)
    out = legacy_generate(model, cfg, prompts, args.new_tokens,
                          memory=memory_stub(cfg, b, rng, dev))
    print(f"{cfg.name}: prefill {b}x{s} in {out['prefill_ms']:.1f} ms")
    dt = out["decode_ms"] / 1e3
    print(f"decoded {args.new_tokens} tokens/seq in {out['decode_ms']:.1f} "
          f"ms ({b * args.new_tokens / max(dt, 1e-9):.0f} tok/s batch "
          f"throughput)")
    gen = out["tokens"].cpu().numpy()
    print("sample token ids:", gen[0][:16].tolist())
    return {"outputs": list(gen), "tokens": int(gen.size),
            "seconds": (out["prefill_ms"] + out["decode_ms"]) / 1e3,
            "prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms"]}


def main(argv=None) -> dict:
    """Serve ``--batch`` random prompts of ``--prompt-len`` tokens; print
    and return the throughput, the scheduler's counts (the driver path)
    and the completions."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4,
                    help="KV cache pool size (driver path)")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="bypass the driver: the static-batch loop over "
                         "prefill/decode_step (the only path of the ssm, "
                         "hybrid, vlm and audio families)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    model = TT.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    if args.legacy_loop or cfg.family not in ("dense", "moe"):
        if not args.legacy_loop:
            print(f"[{cfg.family} family has no slot scheduling yet; "
                  f"falling back to --legacy-loop]")
        return legacy_loop(cfg, model, args, rng, dev)

    engine = LLMEngine(model, cfg, LLMServeOptions(
        slots=args.slots, max_prompt_len=args.prompt_len,
        max_new_tokens=args.new_tokens, device=str(dev)))
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.batch)]

    t0 = time.perf_counter()
    with ServingDriver(engine, starvation_ms=5.0) as drv:
        futs = [drv.submit(p) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        st = drv.stats()
    dt = time.perf_counter() - t0

    total = sum(len(o) for o in outs)
    print(f"{cfg.name} ({cfg.family}) on {dev}: {args.batch} prompts x "
          f"{args.prompt_len} tokens through ServingDriver ({args.slots} "
          f"slots)")
    print(f"generated {total} tokens in {dt * 1e3:.1f} ms "
          f"({total / dt:.0f} tok/s), prefills={st['prefills']} "
          f"decode_steps={st['decode_steps']} "
          f"occupancy={st['slot_occupancy']:.2f}")
    print("sample token ids:", np.asarray(outs[0])[:16].tolist())
    return {"outputs": outs, "tokens": total, "seconds": dt, "stats": st}


if __name__ == "__main__":
    main()
