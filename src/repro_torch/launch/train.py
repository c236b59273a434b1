"""End-to-end GNN training driver — a thin CLI over ``repro_torch.train``.

Counterpart of ``repro/launch/train.py`` with the same flags: it trains the
paper's GCN on a synthetic stand-in dataset through ``Trainer`` (chunked
steps, one eval per report boundary, full-state checkpointing with
``--resume``) on a ``--gd`` x ``--g``^3 mesh. It runs on the card unless
``--device cpu`` (a rehearsal on the CPU, where every kernel runs its
plain version). A mesh of more than one rank runs under ``torchrun``, one
process per rank: NCCL on the cards (rank r on ``cuda:LOCAL_RANK``), gloo
with ``--device cpu``; ``--overlap ring``, ``--compress``,
``--compress-schedule``, ``--bf16-collectives`` and ``--prefetch`` select
the paper's §V communication and sampling overlaps. The flags of features
not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
Examples::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --dataset ogbn-products --vertices 65536 --batch 1024 --steps 100 \\
        --fused-elementwise
    PYTHONPATH=src torchrun --nproc_per_node 8 -m repro_torch.launch.train \\
        --device cpu --g 2 --vertices 2048 --batch 256 --steps 8 \\
        --overlap ring --compress int8 --prefetch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import fourd, gcn_model as GM
from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.graphs import build_partitioned_graph, get_dataset
from repro_torch.obs import Tracer, set_tracer
from repro_torch.optim import (AdamW, linear_warmup_cosine,
                               linear_warmup_cosine_epochs)
from repro_torch.train import Trainer, TrainLoopConfig


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--vertices", type=int, default=8192)
    ap.add_argument("--gd", type=int, default=1, help="data-parallel groups "
                    "(the mesh has gd * g^3 ranks, one process each)")
    ap.add_argument("--g", type=int, default=1, help="3D PMM cube side")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--d-hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps to run (default 300; mutually "
                         "exclusive with --epochs)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="run whole epochs of n_pad/batch steps instead of "
                         "--steps")
    ap.add_argument("--sample-mode", default="step",
                    choices=["step", "epoch"],
                    help="'step': independent per-step samples (seed, step, "
                         "dp); 'epoch': without replacement — one "
                         "permutation per (seed, epoch, dp)")
    ap.add_argument("--sample-kind", default="stratified",
                    choices=["stratified", "partition", "walk"],
                    help="sampling family; partition and walk are not "
                         "ported yet")
    ap.add_argument("--clusters", type=int, default=0)
    ap.add_argument("--walk-len", type=int, default=4)
    ap.add_argument("--walk-k", type=int, default=8)
    ap.add_argument("--mmap-dir", default=None, metavar="DIR",
                    help="mmap shard ingestion: not ported yet")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--bf16-collectives", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8", "int4"])
    ap.add_argument("--compress-schedule", default="uniform",
                    choices=["uniform", "variable"])
    ap.add_argument("--fused-elementwise", action="store_true",
                    help="the fused RMSNorm/ReLU/dropout/residual kernel")
    ap.add_argument("--reshard", default="gather",
                    choices=["gather", "permute"])
    ap.add_argument("--overlap", default="none", choices=["none", "ring"])
    ap.add_argument("--xla-overlap", action="store_true",
                    help="XLA's latency-hiding scheduler; no counterpart "
                         "on this path")
    ap.add_argument("--prefetch", action="store_true",
                    help="§V-A: build the next batch on a side stream")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="optimizer steps per chunk")
    ap.add_argument("--target-acc", type=float, default=None)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-every-epochs", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="steps between full-state checkpoints (0 = only "
                         "the final state)")
    ap.add_argument("--sync-ckpt", action="store_true",
                    help="block on mid-run checkpoint writes")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest TrainState in --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the RunLog + tracer span summary as JSON")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run")
    ap.add_argument("--device", default=None,
                    help="'cpu' for a rehearsal; the card by default")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.steps is not None and args.epochs is not None:
        raise SystemExit("--steps and --epochs are mutually exclusive")
    if args.epochs is None and args.steps is None:
        args.steps = 300
    if args.xla_overlap:
        raise ValueError(
            "--xla-overlap sets XLA scheduler flags, which have no "
            "counterpart here: the port overlaps with --overlap ring")
    if args.mmap_dir:
        raise NotImplementedError(
            "--mmap-dir: mmap shard ingestion is ROADMAP queue 1, "
            '"Locality sampling modes and ingestion"')
    device = resolve_device(args.device)
    use_full_f32_matmul()
    launched = "WORLD_SIZE" in os.environ        # under torchrun
    if launched:
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
    try:
        _train(args, device)
    finally:
        if launched:
            dist.destroy_process_group()


def _train(args, device):
    mesh = fourd.make_mesh_4d(args.gd, args.g, device)
    device = mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    ds = get_dataset(args.dataset, scale_vertices=args.vertices,
                     seed=args.seed)
    pg = build_partitioned_graph(ds, g=args.g, clusters=args.clusters)
    cfg = GM.GCNConfig(d_in=pg.feature_dim, d_hidden=args.d_hidden,
                       num_layers=args.layers, num_classes=pg.num_classes,
                       dropout=args.dropout)
    opts = fourd.TrainOptions(
        bf16_collectives=args.bf16_collectives,
        fused_elementwise=args.fused_elementwise,
        reshard_impl=args.reshard, overlap_impl=args.overlap,
        compress=args.compress, compress_schedule=args.compress_schedule,
        dropout=args.dropout, seed=args.seed,
        sample_mode=args.sample_mode, sample_kind=args.sample_kind,
        clusters=args.clusters, walk_len=args.walk_len, walk_k=args.walk_k)
    plan = fourd.build_plan(pg, cfg, mesh, batch=args.batch, opts=opts)
    graph = plan.shard_graph(pg)
    if args.epochs is not None:
        total_steps = args.epochs * plan.scfg.steps_per_epoch
        lr = linear_warmup_cosine_epochs(
            args.lr, warmup_epochs=min(1.0, 20 / plan.scfg.steps_per_epoch),
            epochs=args.epochs, steps_per_epoch=plan.scfg.steps_per_epoch)
    else:
        total_steps = args.steps
        lr = linear_warmup_cosine(args.lr, 20, total_steps)
    opt = AdamW(lr=lr, weight_decay=1e-4, grad_clip=1.0)
    loop = TrainLoopConfig(
        total_steps=None if args.epochs is not None else args.steps,
        epochs=args.epochs, chunk_size=args.chunk_size,
        prefetch=args.prefetch,
        eval_every=None if args.eval_every_epochs else args.eval_every,
        eval_every_epochs=args.eval_every_epochs,
        target_acc=args.target_acc, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, async_ckpt=not args.sync_ckpt)
    tracer = set_tracer(Tracer(enabled=True, trace_dir=args.trace_dir))
    trainer = Trainer(plan, opt, loop, tracer=tracer)

    params = GM.init_params(cfg, torch.Generator().manual_seed(args.seed),
                            device=device)
    state = trainer.init_state(plan.shard_params(params), graph)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        restored = trainer.restore(state, graph=graph)
        if restored is None:
            raise SystemExit(
                f"--resume: no TrainState checkpoint in {args.ckpt_dir}")
        state = restored
        say(f"resumed: step {int(state.step)} epoch {int(state.epoch)}")

    say(f"ScaleGNN (port): mesh {mesh.shape} on {device}  dataset "
        f"{ds.name} N={pg.n} E={ds.num_edges} batch={args.batch} "
        f"sample-kind={args.sample_kind} sample-mode={args.sample_mode} "
        f"steps={total_steps} (epochs={args.epochs}, "
        f"{plan.scfg.steps_per_epoch}/epoch) chunk={args.chunk_size}")
    t0 = time.time()

    def report(step, loss, acc):
        say(f"step {step:5d}  loss {loss:.4f}  "
            f"full-graph acc {acc:.4f}  t={time.time()-t0:.1f}s")

    tracer.start_profile()
    try:
        state, log = trainer.run(state, graph, report=report)
    finally:
        tracer.stop_profile()

    # reuse the boundary eval when it already covered the last step
    if log.evals and log.evals[-1][0] == int(state.step):
        acc = log.evals[-1][1]
    else:
        acc = float(trainer.eval_fn(state.params, graph))
    dt = time.time() - t0
    say(f"done: steps<= {total_steps}  time {dt:.1f}s  "
        f"full-graph accuracy {acc:.4f}")
    if log.final_ckpt:
        say("checkpoint:", log.final_ckpt)
    say(f"ms/step {log.ms_per_step:.2f}  eval_s {log.eval_s:.2f}  "
        f"ckpt_overlap_s {log.ckpt_overlap_s:.2f}")

    if args.metrics_json and mesh.rank == 0:
        doc = {
            "run": {"dataset": ds.name, "mesh": mesh.shape,
                    "device": str(device), "batch": args.batch,
                    "steps": total_steps, "sample_mode": args.sample_mode,
                    "sample_kind": args.sample_kind,
                    "chunk_size": args.chunk_size, "final_acc": acc,
                    "wall_s": dt},
            "runlog": dataclasses.asdict(log),
            "spans": tracer.summary(),
        }
        with open(args.metrics_json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        say("metrics:", args.metrics_json)


if __name__ == "__main__":
    main()
