#!/usr/bin/env python3
"""Hold the sharded dense LLM step on a mesh of several ranks against the
unsharded step of the same weights.

    torchrun --standalone --nproc_per_node 4 tools/check_llm_mesh.py
    torchrun --standalone --nproc_per_node 4 tools/check_llm_mesh.py \\
        --device cpu --smoke      # gloo ranks, tinyllama's smoke config

Every rank builds tinyllama-1.1b at its published width in float32
(``--layers`` cuts its depth, ``--smoke`` takes the reduced config) from
one seeded init, and takes the unsharded ``loss_and_grads`` of a
``TokenStream`` batch of ``--batch`` x ``--seq`` tokens on its own card.
Then, for each mesh (``--meshes``, default (1, 4) ``("data", "model")``
and (2, 2)), it cuts the weights to its blocks (FSDP), takes its rows of
the batch and runs the sharded ``loss_and_grads`` (``remat``, the sequence
over ``model``, NCCL on the cards, gloo on the CPU): the loss within 1e-5
and every ``unshard``ed gradient leaf within 1e-4 of its largest |.| of
the unsharded ones, on every rank. Rank 0 prints the card's name and power
limit, each mesh's ms/step (a second sharded step, timed), the collective
ledger's bytes a rank by kind and by scope, and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu for gloo ranks")
    ap.add_argument("--smoke", action="store_true",
                    help="tinyllama's reduced config")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--meshes", default="1x4,2x2",
                    help="comma-separated DATAxMODEL shapes")
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import TokenStream, shard_batch_for_mesh
    from repro_torch.device import use_full_f32_matmul
    from repro_torch.launch.train_transformer import loss_and_grads
    from repro_torch.models import sharded, sharding
    from repro_torch.models import transformer as TT
    from repro_torch.obs import comm
    from repro_torch.tree import leaves

    cpu = args.device == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cpu") if cpu else torch.device(
        "cuda", rank % torch.cuda.device_count())
    if not cpu:
        torch.cuda.set_device(dev)
    use_full_f32_matmul()
    cfg = get_smoke("tinyllama-1.1b") if args.smoke \
        else get_config("tinyllama-1.1b")
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              n_layers=args.layers or cfg.n_layers)
    if rank == 0 and not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], flush=True)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    toks, tgts = TokenStream(cfg.vocab, args.batch, args.seq, seed=0,
                             coherence=0.8).batch_at(0)
    fresh = lambda: TT.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                   dev, trainable=True)
    model = fresh()
    loss_u, grads_u = loss_and_grads(model, torch.from_numpy(toks).to(dev),
                                     torch.from_numpy(tgts).to(dev), cfg)
    grads_u = [g.detach() for g in leaves(grads_u)]
    del model
    results, ok = {}, True
    for name in args.meshes.split(","):
        shape = tuple(int(x) for x in name.split("x"))
        if shape[0] * shape[1] != world:
            raise SystemExit(f"mesh {name} needs {shape[0] * shape[1]} "
                             f"ranks, torchrun gave {world}")
        mesh = sharding.make_llm_mesh(shape, ("data", "model"),
                                      "cpu" if cpu else None)
        model = sharded.shard_model(fresh(), mesh, fsdp=True)
        tk, tg = shard_batch_for_mesh(mesh, toks, tgts)
        dp = sharding.batch_pspec(mesh, args.batch)[0]
        opts = dict(act_sharding=sharding.P(dp, "model", None), remat=True)
        with comm.recording() as led:
            with TT.run_options(**opts):
                loss, grads = loss_and_grads(model, tk, tg, cfg, mesh=mesh)
        full = [g for g in leaves(sharding.unshard(grads, model.mesh_specs,
                                                   mesh))]
        lrel = abs(loss.item() - loss_u.item()) / abs(loss_u.item())
        worst = max((g - w).abs().max().item()
                    / max(w.abs().max().item(), 1e-30)
                    for g, w in zip(full, grads_u))
        del grads, full
        sync()
        t0 = time.perf_counter()
        with TT.run_options(**opts):
            _, grads = loss_and_grads(model, tk, tg, cfg, mesh=mesh)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        del grads
        rep = led.report()
        scopes = {}
        for op in rep.sites:
            key = op.op_name.split("/")[-1] or "-"
            scopes[key] = scopes.get(key, 0) + op.bytes
        good = lrel <= LOSS_RTOL and worst <= GRAD_RTOL
        flags = [None] * world
        dist.all_gather_object(flags, (rank, good, lrel, worst))
        ok = ok and all(f[1] for f in flags)
        results[name] = {"ms_per_step": ms, "loss": loss.item(),
                         "loss_unsharded": loss_u.item(),
                         "ranks": [list(f) for f in flags],
                         "bytes_by_kind": {k: v for k, v in
                                           rep.bytes.items() if v},
                         "bytes_by_scope": scopes}
        if rank == 0:
            print(f"[llm-mesh] mesh {name} ({cfg.name}, {cfg.n_layers} "
                  f"layers, f32, {args.batch} x {args.seq}, remat, FSDP): "
                  f"loss {loss.item():.6f} against {loss_u.item():.6f}; "
                  f"every rank within the limits {all(f[1] for f in flags)} "
                  f"(worst loss {max(f[2] for f in flags):.3e}, gradient "
                  f"{max(f[3] for f in flags):.3e}); {ms:.1f} ms/step; "
                  f"ledger bytes a rank {results[name]['bytes_by_kind']}, "
                  f"by scope {scopes}", flush=True)
        del model
    if rank == 0:
        print(json.dumps({"ranks": world, "device": "cpu" if cpu else "cuda",
                          "arch": cfg.name, "layers": cfg.n_layers,
                          "ok": ok, "meshes": results}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
