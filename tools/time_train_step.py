#!/usr/bin/env python3
"""Time the port's training step at ``chip_smoke.py``'s phase-5 shape, for
comparing two trees of the port on one card in one sitting.

    python3 tools/time_train_step.py --src src            # this tree
    python3 tools/time_train_step.py --src OLD_TREE/src   # another tree

It imports ``repro_torch`` from ``--src`` and uses only the interface both
the parent and this tree have (``fourd.build_plan``, ``Trainer``): the
ogbn-products stand-in at ``--vertices`` (its full size by default),
``paper_model("ogbn-products")`` with the block-ELL SpMM, the fused tail and
the fused extraction, batch 8192, ``ell_slots`` 32, dropout 0.3, AdamW with
warm-up and cosine decay. It runs ``--runs`` times 48 steps in chunks of 8
from one seeded init and prints each run's ms/step (``RunLog``: wall time
over the steps, losses read once at the end) after the card's name and
power limit. Alternate the trees (parent, change, change, parent) on one
machine: the host bounds the step, and hosts differ between machines.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--vertices", type=int, default=2_449_029)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_train_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.device import use_full_f32_matmul
    from repro_torch.graphs import build_partitioned_graph, get_dataset
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    use_full_f32_matmul()
    dev = torch.device("cuda")
    t0 = time.monotonic()
    pg = build_partitioned_graph(get_dataset(
        "ogbn-products", scale_vertices=args.vertices), g=1)
    cfg = paper_model("ogbn-products")
    opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              extract_impl="cuda", dropout=0.3,
                              ell_tile=128, ell_slots=32)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(1, 1, dev),
                            batch=8192, opts=opts)
    graph = plan.shard_graph(pg)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    print(f"set-up {time.monotonic() - t0:.1f} s", flush=True)
    ms = []
    for _ in range(args.runs):
        tr = Trainer(plan, AdamW(lr=linear_warmup_cosine(5e-3, 20, 48),
                                 weight_decay=1e-4, grad_clip=1.0),
                     TrainLoopConfig(total_steps=48, chunk_size=8),
                     eval_fn=lambda p, g: 0.0)
        params = tree_map(lambda t: t.detach().clone(), params0)
        _, log = tr.run(tr.init_state(params), graph)
        ms.append(log.ms_per_step)
    print(json.dumps({"src": args.src, "ms_per_step": ms,
                      "last_loss": log.losses[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
