#!/usr/bin/env python3
"""Time §V-A prefetch at ``chip_smoke.py``'s phase-5 shape: the training
step with prefetch off, with the next batch built on the side CUDA stream
(the Trainer's path), and with the same carry built inline on the main
stream, in turns on one card.

    python3 tools/time_prefetch.py [--runs 3] [--vertices N]

The ogbn-products stand-in at ``--vertices`` (its full size by default),
``paper_model("ogbn-products")`` with the block-ELL SpMM, the fused tail
and the fused extraction, batch 8192, ``ell_slots`` 32, dropout 0.3, AdamW
with warm-up and cosine decay, 48 steps in chunks of 8 from one seeded
init. The inline mode runs the Trainer's prefetch body with its side
stream taken away (``SideStream.stream = None``, the CPU's path), so the
carry, the order of the work and the batches are the same and only the
stream differs. Each run prints its ms/step (``RunLog``; the Trainer
replays a captured step) and the host's ms/step inside the ``prefetch``
span (the fork of the eager warm-up step and of the capture), after the
card's name and power limit; every mode's losses must be prefetch-off's
bits.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = ("off", "side", "inline")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=2_449_029)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_prefetch: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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

    def run(mode):
        tr = Trainer(plan, AdamW(lr=linear_warmup_cosine(5e-3, 20, 48),
                                 weight_decay=1e-4, grad_clip=1.0),
                     TrainLoopConfig(total_steps=48, chunk_size=8,
                                     prefetch=mode != "off"),
                     eval_fn=lambda p, g: 0.0)
        if mode == "inline":
            tr._side.stream = None
        params = tree_map(lambda t: t.detach().clone(), params0)
        _, log = tr.run(tr.init_state(params, graph), graph)
        host = tr.tracer.totals().get("prefetch", 0.0) * 1e3 / 48
        return log, host

    want = run("off")[0].losses                   # a warm-up run
    out = {m: {"ms_per_step": [], "host_prefetch_ms": []} for m in MODES}
    for r in range(args.runs):
        order = MODES[r % 3:] + MODES[:r % 3]
        for mode in order:
            log, host = run(mode)
            if log.losses != want:
                raise AssertionError(f"{mode}: the losses changed")
            out[mode]["ms_per_step"].append(log.ms_per_step)
            out[mode]["host_prefetch_ms"].append(host)
            print(f"run {r} {mode}: {log.ms_per_step:.4f} ms/step, host in "
                  f"the prefetch {host:.4f} ms/step", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
