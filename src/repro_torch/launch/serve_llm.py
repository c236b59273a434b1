"""LLM serving from the command line: prompts submitted as futures to
the same ``ServingDriver`` that fronts GNN serving, with KV-cache slot
scheduling and continuous batching behind it (``serve/llm_engine.py``).

Counterpart of the driver path of ``examples/serve_llm.py``, with its
flags plus ``--device``. As the example, it serves the reduced
``get_smoke`` config of ``--arch`` with seeded random weights and random
prompts. It runs on the card unless ``--device cpu`` (a rehearsal on the
CPU, where the flash kernel runs its plain version)::

    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --device cpu --arch mixtral-8x7b --batch 4 --prompt-len 16

``--legacy-loop`` (the example's static-batch loop over the scalar-pos
``prefill`` / ``decode_step``) is not ported and raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import PORTED_IDS, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TT
from repro_torch.serve import LLMEngine, LLMServeOptions, ServingDriver

LEGACY_TODO = ('--legacy-loop is not ported yet: ROADMAP queue 1, '
               f'{TT.LLM_ITEM} (the scalar-pos prefill and decode_step)')


def main(argv=None) -> dict:
    """Serve ``--batch`` random prompts of ``--prompt-len`` tokens; print
    and return the throughput, the scheduler's counts and the
    completions."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=PORTED_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4,
                    help="KV cache pool size")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="the example's batch loop (not ported: raises)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.legacy_loop:
        raise NotImplementedError(LEGACY_TODO)

    cfg = get_smoke(args.arch)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    model = TT.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
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
