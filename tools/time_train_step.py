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
power limit, and the seconds each run spent capturing a CUDA graph (0 on
a tree that captures none; ms/step includes them, as the reference's
includes its compile). Alternate the trees (parent, change, change,
parent) on one machine: hosts differ between machines.

``--block-dtype`` lists the block types to run in turn in one process on
the one graph, e.g. ``f32,bf16,bf16,f32`` (``TrainOptions.block_dtype``;
a tree older than the bf16 blocks takes ``f32`` only). After each entry's
runs it times ``--chunks`` more chunks of 8 replays of its last captured
step with CUDA events (the replays' host enqueue included) and prints
their median ms a step with the entry's ms/step.

With ``--profile`` it then profiles, in this order, one more chunk of 8
replays of the last run's captured step (a step's device time, the device
busy share and each kernel's time by name) and one chunk of 8 eager
``Trainer.step`` calls, from which it sums the device time of the kernels
launched inside the tail's autograd node (``_FusedTailBackward``): a
chunk's tail backward, whatever kernels a tree runs there. The replays are
profiled first: a profiled replay after another profiler session of the
process can crash (ROADMAP queue 3).
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
    ap.add_argument("--profile", action="store_true",
                    help="profile a chunk of replays, then an eager chunk")
    ap.add_argument("--block-dtype", default="f32",
                    help="block types to run in turn, comma-separated")
    ap.add_argument("--chunks", type=int, default=5,
                    help="chunks of 8 replays timed after each entry")
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
    mesh = fourd.make_mesh_4d(1, 1, dev)
    graph = None
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    for block_dtype in args.block_dtype.split(","):
        opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                                  extract_impl="cuda", dropout=0.3,
                                  ell_tile=128, ell_slots=32,
                                  block_dtype=block_dtype)
        plan = fourd.build_plan(pg, cfg, mesh, batch=8192, opts=opts)
        if graph is None:
            graph = plan.shard_graph(pg)
            print(f"set-up {time.monotonic() - t0:.1f} s", flush=True)
        ms, capture_s = [], []
        for _ in range(args.runs):
            tr = Trainer(plan, AdamW(lr=linear_warmup_cosine(5e-3, 20, 48),
                                     weight_decay=1e-4, grad_clip=1.0),
                         TrainLoopConfig(total_steps=48, chunk_size=8),
                         eval_fn=lambda p, g: 0.0)
            params = tree_map(lambda t: t.detach().clone(), params0)
            state, log = tr.run(tr.init_state(params), graph)
            ms.append(log.ms_per_step)
            capture_s.append(getattr(log, "capture_s", 0.0))
        out = {"src": args.src, "block_dtype": block_dtype,
               "ms_per_step": ms, "capture_s": capture_s,
               "last_loss": log.losses[-1],
               "replay_ms_per_step": replay_ms(torch, tr, state, graph,
                                               args.chunks)}
        if args.profile:
            out.update(profile(torch, tr, state, graph))
        print(json.dumps(out), flush=True)
        del tr, state
    return 0


def replay_ms(torch, tr, state, graph, chunks: int, steps: int = 8
              ) -> float:
    """The median over ``chunks`` chunks of ``steps`` replays of the
    trainer's captured step of their CUDA-event time a step (the replays'
    host enqueue and the losses' read included)."""
    import statistics
    times = []
    for _ in range(chunks):
        tr.total_steps += steps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        tr.run(state, graph)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return statistics.median(times)


def profile(torch, tr, state, graph, steps: int = 8) -> dict:
    """A step's device time from ``steps`` profiled replays, then the
    device time inside ``_FusedTailBackward`` over ``steps`` profiled eager
    steps (``chip_smoke.device_profile`` reads both traces)."""
    from torch.profiler import ProfilerActivity, profile as prof_

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import device_profile
    out = {}
    for kind in ("replays", "eager"):
        torch.cuda.synchronize()
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            if kind == "replays":
                tr.total_steps += steps
                tr.run(state, graph)
            else:
                for _ in range(steps):
                    tr.step(state, graph)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        seen = device_profile(prof, wall_us, f"{steps} steps, {kind}",
                              spans=("_FusedTailBackward",))
        out[f"{kind}_device_ms_per_step"] = seen["busy_us"] / steps / 1e3
        out[f"{kind}_busy_share"] = seen["busy_us"] / seen["wall_us"]
        if kind == "eager":
            out["tail_backward_us_per_chunk"] = seen["span_us"][
                "_FusedTailBackward"]
    return out


if __name__ == "__main__":
    sys.exit(main())
