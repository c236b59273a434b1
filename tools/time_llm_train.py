#!/usr/bin/env python3
"""Time the port's float32 LLM training step at ``chip_smoke.py``'s phase-7
shape, for comparing two trees of the port on one card in one sitting.

    python3 tools/time_llm_train.py --src src            # this tree
    python3 tools/time_llm_train.py --src OLD_TREE/src   # another tree

It imports ``repro_torch`` from ``--src`` and uses only the interface both
the parent and this tree have: tinyllama-1.1b at its published width
(``configs.get_config``) in float32, seeded weights, one gradient
(``loss_and_grads``, which builds the kernels and warms the GEMMs), then
``launch.train_transformer.train`` on those weights for ``--steps`` eager
AdamW steps of 2 x 2048 ``TokenStream`` tokens (the kernels' f32 routes
once a layer a step), as ``chip_smoke.py``'s phase 7 runs them. It prints
the card's name and power limit, then one JSON object: the run's ms/step
and tokens/s (``LMTrainLog``: wall time over the steps) and its losses.
Alternate the trees (parent, change, change, parent) in one call: hosts
differ between machines.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train_transformer as TTR
    from repro_torch.models import transformer as TT
    if not torch.cuda.is_available():
        print("time_llm_train: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = get_config("tinyllama-1.1b")
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    dev = torch.device("cuda")
    model = TT.init_params(c32, torch.Generator(device=dev).manual_seed(0),
                           dev, trainable=True)
    stream = TokenStream(vocab_size=c32.vocab, batch=2, seq_len=2048, seed=0,
                         coherence=0.8)
    toks, tgts = (torch.from_numpy(a).to(dev) for a in stream.batch_at(0))
    TTR.loss_and_grads(model, toks, tgts, c32)[0].item()     # warm-up
    run = TTR.train(c32, steps=args.steps, batch=2, seq=2048, seed=0,
                    device=dev, params=model, log=lambda m: None)
    print(json.dumps({"src": args.src, "steps": args.steps,
                      "ms_per_step": run.ms_per_step,
                      "tokens_per_s": run.tokens_per_s,
                      "losses": run.losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
