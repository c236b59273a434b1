#!/usr/bin/env python3
"""Hold the captured training step against the eager one on a data-parallel
mesh of several ranks: the gradient all-reduce and the loss all-gather over
``d`` then cross ranks inside the CUDA graph.

    torchrun --standalone --nproc_per_node 4 tools/check_capture_mesh.py
    torchrun --standalone --nproc_per_node 4 tools/check_capture_mesh.py \\
        --device cpu          # gloo ranks: both runs eager (no graphs)

Every rank builds the (G_d, 1, 1, 1) mesh, G_d the world size, over NCCL on
its card (gloo on the CPU), the paper's GCN width (d_hidden 256, 3 layers,
block-ELL SpMM, fused tail and extraction, dropout 0.3, AdamW with warm-up,
cosine decay and clipping) on a synthetic graph of ``--vertices``, and
runs ``--steps`` steps twice from one seeded init: ``Trainer.run`` (on the
card a warm-up step, a capture and replays) and ``Trainer.step`` in a loop.
Each rank checks that the two runs give the same losses and params bit for
bit and that every rank holds the same losses and params; rank 0 prints
the card's name and power limit, each run's ms/step (the spread of
``--runs`` runs of each, in turns), and one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu for gloo ranks")
    ap.add_argument("--vertices", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.device import use_full_f32_matmul
    from repro_torch.graphs import build_partitioned_graph, get_dataset
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves, tree_map

    cpu = args.device == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    use_full_f32_matmul()
    mesh = fourd.make_mesh_4d(world, 1, "cpu" if cpu else None)
    if rank == 0 and not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    pg = build_partitioned_graph(get_dataset(
        "ogbn-products", scale_vertices=args.vertices), g=1)
    cfg = paper_model("ogbn-products")
    opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              extract_impl="cuda", dropout=0.3,
                              ell_tile=128, ell_slots=32)
    plan = fourd.build_plan(pg, cfg, mesh, batch=args.batch, opts=opts)
    graph = plan.shard_graph(pg)
    params0 = plan.shard_params(M.init_params(
        cfg, torch.Generator().manual_seed(0), device=mesh.device))
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)

    def trainer():
        return Trainer(plan, AdamW(lr=linear_warmup_cosine(
            5e-3, 4, args.steps), weight_decay=1e-4, grad_clip=1.0),
            TrainLoopConfig(total_steps=args.steps, chunk_size=8),
            eval_fn=lambda p, g: 0.0)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def run():
        tr = trainer()
        st, log = tr.run(tr.init_state(fresh()), graph)
        return log.losses, st.params, log.ms_per_step, log.replays

    def eager():
        tr = trainer()
        st = tr.init_state(fresh())
        sync()
        t0 = time.perf_counter()
        losses = torch.stack([tr.step(st, graph) for _ in range(
            args.steps)]).cpu().tolist()
        return (losses, st.params,
                (time.perf_counter() - t0) * 1e3 / args.steps, 0)

    out = {"run": [], "step": []}
    for kind in ("run", "step", "run", "step", "run", "step")[:2 * args.runs]:
        out[kind].append(run() if kind == "run" else eager())
        if rank == 0:
            print(f"[capture-mesh] Trainer.{kind}: {out[kind][-1][2]:.4f} "
                  f"ms/step", flush=True)
    want_losses, want_params = out["step"][0][:2]
    same = all(r[0] == want_losses and all(
        torch.equal(a, b) for a, b in zip(leaves(r[1]), leaves(want_params)))
        for r in out["run"] + out["step"])
    # every rank holds the same losses and params (G_d replicas)
    flat = torch.cat([t.reshape(-1) for t in leaves(want_params)]
                     + [torch.tensor(want_losses, device=mesh.device)])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    replicas = all(torch.equal(g, flat) for g in gathered)
    if rank == 0:
        print(f"[capture-mesh] {world} ranks, mesh {mesh.shape} on "
              f"{mesh.device.type}, {args.vertices} vertices, batch "
              f"{args.batch}, {args.steps} steps: Trainer.run "
              f"({out['run'][0][3]} replays) and Trainer.step bit-identical "
              f"{same}; every rank the same losses and params {replicas}",
              flush=True)
        print(f"[capture-mesh] ms/step, in turns: Trainer.run "
              f"{', '.join(f'{r[2]:.4f}' for r in out['run'])}; "
              f"Trainer.step {', '.join(f'{r[2]:.4f}' for r in out['step'])}",
              flush=True)
        print(json.dumps({"ranks": world, "device": mesh.device.type,
                          "bit_identical": same, "replicas_equal": replicas,
                          "ms_run": [r[2] for r in out["run"]],
                          "ms_step": [r[2] for r in out["step"]],
                          "losses": want_losses}), flush=True)
    dist.barrier()
    del out                  # the runs' graphs are gone with their trainers
    gc.collect()
    dist.destroy_process_group()
    return 0 if same and replicas else 1


if __name__ == "__main__":
    sys.exit(main())
