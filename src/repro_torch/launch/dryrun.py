"""The production dry run of the 4D step: one rank of 256 or 512, with no
data and no card.

Counterpart of ``repro/launch/dryrun.py``'s ``run_gnn_dryrun``. The
reference lowers and compiles the step on 512 placeholder host devices;
the port runs its own step, eagerly, as rank ``r`` of a fake process group
(``"cpu:fake,meta:fake"``: every collective returns at once) over the
production mesh (``launch/mesh.py``) on the meta device, where tensors
have shapes and no storage and the step takes the card's routes
(``ForwardEngine.tail_draws``). The plan comes from
``fourd.build_plan``, which reads only the graph's scalars; this rank's
shards are made directly on the meta device with the shapes
``FourDPlan.shard_graph`` would give (the global arrays of
papers100M-like scale would not fit on the host). One ``value_and_grad``
and one clipped AdamW step run under the step walk
(``launch/roofline.py``), sampling under ``assert_no_collectives``.

Each record holds ``status``, ``n_devices``, ``params``, the walked
``flops_per_device`` and ``bytes_per_device``, the ledger's
``collective_bytes_per_device`` by kind, ``loop_aware`` (the walk's whole
result) and ``memory``: ``argument_bytes`` (this rank's params, optimizer
state and graph shards) and ``temp_bytes`` (the most storage the step
holds alive at once beyond them). They are counts on the meta device, not
times. Records go to ``experiments/dryrun/scalegnn_gcn_{single,multi}.json``.
Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --gnn \\
        [--mesh single|multi] [--rank R]

The LLM combinations need ``models/sharding.py`` and raise.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import MESH_4D, make_production_mesh_4d

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "experiments", "dryrun")

# the reference's production GNN (``run_gnn_dryrun``): papers100M-like
# dimensions on a cube of side 4
PAPERS100M = dict(n=111_060_992, edges=1_615_685_872, batch=131_072,
                  d_in=128, d_hidden=256, num_layers=3, num_classes=176,
                  dropout=0.1, avg_deg=16)

_LLM_TODO = ("the LLM dry run needs models/sharding.py, which is not ported "
             "yet: ROADMAP queue 1, \"The LLM stack beyond the dense serving "
             "path\"")


def run_one(arch: str, shape_name: str, multi_pod: bool, **_) -> None:
    raise NotImplementedError(_LLM_TODO)


def init_fake_group(rank: int, world: int) -> None:
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks (every collective a no-op; meta tensors included)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=world)


def _nbytes(ts) -> int:
    """Bytes of the distinct tensors among ``ts`` (a plane's block that
    several layers share counts once)."""
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in ts}.values())


def meta_graph(plan, n_local: int, e_pad: int, d_in: int) -> Dict[str, Any]:
    """This rank's graph shards on the meta device, in the shapes of
    ``plan.shard_graph``: the CSR block of each rotation plane
    (``plan.plane_blocks``, one triple per distinct block), the (n_local,
    d_in / g) feature slice and the labels of the final row axis's
    range."""
    meta = torch.device("meta")
    blocks = {ij: (torch.empty(n_local + 1, dtype=torch.int32, device=meta),
                   torch.empty(e_pad, dtype=torch.int32, device=meta),
                   torch.empty(e_pad, dtype=torch.float32, device=meta))
              for ij in set(plan.plane_blocks())}
    return {"adj": tuple(blocks[ij] for ij in plan.plane_blocks()),
            "features": torch.empty((n_local, d_in // plan.grid_side),
                                    device=meta),
            "labels": torch.empty(n_local, dtype=torch.int32, device=meta)}


def run_gnn_dryrun(multi_pod: bool = False, *, rank: int = 0,
                   mesh_shape: Optional[tuple] = None,
                   dims: Optional[Dict[str, int]] = None,
                   save: bool = True) -> Dict[str, Any]:
    """Dry-run the paper's 4D GNN train step as rank ``rank`` of the
    production mesh ((4, 4, 4, 4), or (8, 4, 4, 4) with ``multi_pod``), at
    papers100M-like dimensions (batch 131072, d_in 128, d_h 256, 3 layers);
    ``mesh_shape`` and ``dims`` (``PAPERS100M``'s keys, plus ``n_pad``,
    ``e_pad``, ``e_cap`` and ``max_row_nnz``) give a miniature."""
    from repro_torch import optim as O
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.graphs.partition import PartitionedGraph
    from repro_torch.launch.roofline import StepWalk
    from repro_torch.obs import comm
    from repro_torch.tree import leaves, tree_map

    shape = tuple(mesh_shape or MESH_4D[multi_pod])
    g_d, g = shape[0], shape[1]
    dm = dict(PAPERS100M, **(dims or {}))
    mesh_name = "multi" if multi_pod else "single"
    n_dev = g_d * g ** 3
    n_pad = dm.get("n_pad") or dm["n"] // (g * g) * (g * g)
    n_local = n_pad // g
    e_pad = dm.get("e_pad") or int(dm["edges"] / (g * g) * 1.5)
    max_row_nnz = dm.get("max_row_nnz") or dm["avg_deg"] * 4
    e_cap = dm.get("e_cap") or (dm["batch"] // g) * max_row_nnz
    cfg = M.GCNConfig(d_in=dm["d_in"], d_hidden=dm["d_hidden"],
                      num_layers=dm["num_layers"],
                      num_classes=dm["num_classes"] // g * g,
                      dropout=dm["dropout"])
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rec: Dict[str, Any] = {
        "arch": "scalegnn-gcn-papers100M", "shape": "minibatch_131k",
        "mesh": mesh_name, "mesh_shape": list(shape), "family": "gnn",
        "rank": rank, "device": "meta",
        "params": sum(t.numel() for t in leaves(params_cpu))}
    t0 = time.time()
    try:
        init_fake_group(rank, n_dev)
        mesh = (make_production_mesh_4d(multi_pod=multi_pod, device="meta")
                if mesh_shape is None else fourd.make_mesh_4d(g_d, g, "meta"))
        pg = PartitionedGraph(
            n=n_pad, n_pad=n_pad, g=g, n_local=n_local, e_pad=e_pad,
            block_rp=None, block_ci=None, block_val=None,
            max_block_row_nnz=max_row_nnz, features=None, labels=None,
            train_mask=None, num_classes=cfg.num_classes)
        plan = fourd.build_plan(
            pg, cfg, mesh, batch=dm["batch"],
            opts=fourd.TrainOptions(dropout=dm["dropout"],
                                    extract_impl="cuda"), e_cap=e_cap)
        graph = meta_graph(plan, n_local, e_pad, cfg.d_in)
        params = plan.shard_params(tree_map(lambda t: t.to("meta"),
                                            params_cpu))
        opt = O.AdamW(lr=1e-3, grad_clip=1.0)
        opt_state = opt.init(params)
        step = torch.zeros((), dtype=torch.int64, device="meta")
        loss_fn = fourd.make_loss_fn(plan, train=True)
        arg_bytes = _nbytes(leaves(params) + leaves(opt_state)
                            + leaves(graph))
        sampling = {}

        def train_step():
            with comm.recording() as led:
                mb = loss_fn.sample(graph, step)
            sampling["report"] = led.report().assert_no_collectives(
                "sampling")
            _, grads = fourd.value_and_grad(loss_fn, params, graph, step,
                                            mb=mb)
            opt.update(params, grads, opt_state, sumsq=plan.global_sumsq)

        with StepWalk() as walk:
            train_step()
        costs = walk.costs()
        rec.update({
            "status": "ok", "walk_s": round(time.time() - t0, 1),
            "n_devices": n_dev,
            "flops_per_device": costs["flops"],
            "bytes_per_device": costs["bytes"],
            "collective_bytes_per_device": dict(
                walk.ledger.report().bytes),
            "collective_counts_per_device": dict(
                walk.ledger.report().counts),
            "sampling_collectives": sampling["report"].total_count,
            "loop_aware": costs,
            "memory": {"argument_bytes": arg_bytes,
                       "temp_bytes": walk.peak_temp_bytes},
        })
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"scalegnn_gcn_{mesh_name}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh this process plays")
    ap.add_argument("--gnn", action="store_true",
                    help="dry-run the paper's 4D GNN step")
    args = ap.parse_args()
    if not args.gnn:
        raise NotImplementedError(_LLM_TODO)
    n_err = 0
    for m in ([args.mesh] if args.mesh else ["single", "multi"]):
        rec = run_gnn_dryrun(multi_pod=m == "multi", rank=args.rank)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}, indent=1, default=str))
        if rec["status"] != "ok":
            print(rec.get("traceback", ""))
            n_err += 1
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
