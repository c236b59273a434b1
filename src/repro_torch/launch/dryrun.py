"""The production dry run: one rank of 256 or 512, with no data and no
card, of the LLM combinations (the dense family) and of the 4D GNN step.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each (architecture x input shape x mesh) on 512 placeholder host
devices; the port runs its own step, eagerly, as rank ``r`` of a fake
process group (``"cpu:fake,meta:fake"``: every collective returns at once)
over the production mesh (``launch/mesh.py``) on the meta device, where
tensors have shapes and no storage and every kernel takes the card's route
(its meta route). The step runs under the step walk
(``launch/roofline.py``), which counts its FLOPs and bytes, the collective
ledger's bytes by kind and the storage it holds alive at once.

LLM (:func:`run_one`): the reference's ``build_step`` on this rank's
blocks (``models/sharding.py``, ``models/sharded.py``): ``train_4k`` is one
``loss_and_grads`` (8 micro-batches with float32 gradient accumulation
above 2e10 parameters) and one ``AdamW(lr=1e-4)`` update, under
``run_options(act_sharding=P(dp, "model", None), remat=True)``;
``prefill_32k`` a ``prefill`` of the batch; ``decode_32k`` one
``decode_step`` against a 32k cache in ``cache_pspecs``'s layout;
``long_500k`` is skipped for full-attention archs, with the reference's
reason. ``--optimized`` turns on the reference's knobs
(``set_optimized_knobs``: q-chunks of 2048, its attention layout) and
names the mesh ``{single,multi}_opt``. Only the dense family runs: any
other arch is recorded as ``error`` with its ROADMAP title. GNN
(:func:`run_gnn_dryrun`): the plan comes from ``fourd.build_plan``, which
reads only the graph's scalars; this rank's shards are made directly on
the meta device with the shapes ``FourDPlan.shard_graph`` would give. One
``value_and_grad`` and one clipped AdamW step, sampling under
``assert_no_collectives``.

Each record holds ``status``, ``n_devices``, ``params`` (and
``active_params``), the walked ``flops_per_device`` and
``bytes_per_device``, the ledger's ``collective_bytes_per_device`` by
kind, ``loop_aware`` (the walk's whole result) and ``memory``:
``argument_bytes`` (this rank's params, optimizer state and inputs) and
``temp_bytes`` (the most storage the step holds alive at once beyond
them). They are counts on the meta device, not times. Records go to
``experiments/dryrun/{arch}_{shape}_{mesh}.json`` and
``scalegnn_gcn_{single,multi}.json``. Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi] [--optimized] [--rank R]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --gnn \\
        [--mesh single|multi] [--rank R]

The LLM run exits 1 on any ``error``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config, shape_applicable)
from repro_torch.launch.mesh import (MESH_4D, MESH_LLM,
                                     make_production_mesh_4d)
from repro_torch.models.config import ModelConfig

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "experiments", "dryrun")

# the reference's production GNN (``run_gnn_dryrun``): papers100M-like
# dimensions on a cube of side 4
PAPERS100M = dict(n=111_060_992, edges=1_615_685_872, batch=131_072,
                  d_in=128, d_hidden=256, num_layers=3, num_classes=176,
                  dropout=0.1, avg_deg=16)

SKIP_REASON = ("full-attention arch: 524k dense KV decode is "
               "architecturally unsupported (DESIGN.md §6)")


# ---------------------------------------------------------------------------
# The LLM combinations
# ---------------------------------------------------------------------------

def memory_stub_spec(cfg: ModelConfig, batch: int
                     ) -> Optional[torch.Tensor]:
    """The modality-frontend stub on the meta device: precomputed
    embeddings (the vlm and audio families), else None."""
    if cfg.family == "vlm":
        n = cfg.n_image_tokens
    elif cfg.family == "audio":
        n = cfg.encoder.n_frames
    else:
        return None
    return torch.empty((batch, n, cfg.d_model), dtype=cfg.compute_dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """This rank's inputs of the shape on the meta device: its batch rows
    (the global batch over the DP axes) of ``tokens`` and ``targets``
    (train), ``tokens`` (prefill), or ONE new ``token`` and its block of a
    ``seq_len`` cache (decode)."""
    from repro_torch.models import sharded, sharding
    s = shape.seq_len
    dp = sharding.batch_pspec(mesh, shape.global_batch)[0]
    b = shape.global_batch // (mesh.index(dp)[1] if dp else 1)
    tok = lambda n: torch.empty((b, n), dtype=torch.int32, device="meta")
    if shape.kind == "train":
        out = {"tokens": tok(s), "targets": tok(s)}
    elif shape.kind == "prefill":
        out = {"tokens": tok(s)}
    else:
        out = {"token": tok(1), "cache": sharded.init_cache(cfg, b, s, mesh)}
    mem = memory_stub_spec(cfg, b)
    if mem is not None and shape.kind != "decode":
        out["memory"] = mem
    return out


def _nbytes(ts) -> int:
    """Bytes of the distinct tensors among ``ts`` (a plane's block that
    several layers share counts once)."""
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in ts}.values())


def build_step(cfg: ModelConfig, shape: InputShape, mesh
               ) -> Tuple[Callable[[], Any], int]:
    """``(step, argument bytes)``: the reference's step of the shape for
    this rank, on its blocks of the abstract params (FSDP above 3e9
    parameters) and its inputs, ready to walk."""
    from repro_torch.launch.train_transformer import loss_and_grads
    from repro_torch.models import sharded, sharding
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves, tree_map

    train = shape.kind == "train"
    params = sharded.shard_model(TT.abstract_params(cfg, trainable=train),
                                 mesh)
    tree = TT.param_tree(params)
    ins = input_specs(cfg, shape, mesh)
    dp = sharding.batch_pspec(mesh, shape.global_batch)[0]
    seq_par = sharding.P(dp, "model", None)
    arg = leaves(tree) + leaves(ins)

    if train:
        opt = AdamW(lr=1e-4)
        opt_state = opt.init(tree)
        arg += leaves(opt_state)
        n_micro = 8 if cfg.num_params() > 2e10 else 1
        tokens, targets = ins["tokens"], ins["targets"]

        def train_step():
            with TT.run_options(act_sharding=seq_par, remat=True,
                                head_sharding=sharding.P(None, "model")):
                if n_micro == 1:
                    _, grads = loss_and_grads(params, tokens, targets, cfg,
                                              mesh=mesh)
                else:
                    grads = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device), tree)
                    for tk, tg in zip(tokens.chunk(n_micro),
                                      targets.chunk(n_micro)):
                        _, g = loss_and_grads(params, tk, tg, cfg, mesh=mesh)
                        for acc, gi in zip(leaves(grads), leaves(g)):
                            acc += gi.float()
                    grads = tree_map(lambda a: a / n_micro, grads)
                opt.update(tree, grads, opt_state)
        return train_step, _nbytes(arg)

    if shape.kind == "prefill":
        def prefill_step():
            with TT.run_options(act_sharding=seq_par, remat=False):
                return TT.prefill(params, ins["tokens"], cfg,
                                  max_len=shape.seq_len, mesh=mesh)
        return prefill_step, _nbytes(arg)

    def serve_step():
        with TT.run_options(act_sharding=None, remat=False):
            return TT.decode_step(params, ins["token"], ins["cache"], cfg,
                                  mesh=mesh)
    return serve_step, _nbytes(arg)


def set_optimized_knobs(mesh, enable: bool = True) -> None:
    """The reference's beyond-paper attention knobs: causal q-chunks of
    2048 and its attention layout (q over the sequence, K/V whole; the
    port's sharded step always has it). Off = the paper-faithful path."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    if not enable:
        L.set_q_chunk(None)
        L.set_attn_sharding(None)
        return
    dp = sharding.dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    L.set_q_chunk(2048)
    L.set_attn_sharding((sharding.P(dp, "model", None, None),
                         sharding.P(dp, None, None, None)))


def _mesh_axes(mesh_shape) -> Tuple[str, ...]:
    return ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")


def run_one(arch: str, shape_name: str, multi_pod: bool,
            save: bool = True, optimized: bool = False, rank: int = 0, *,
            cfg: Optional[ModelConfig] = None,
            mesh_shape: Optional[tuple] = None,
            shape: Optional[InputShape] = None) -> Dict[str, Any]:
    """Dry-run one LLM combination as rank ``rank`` of the production mesh
    ((16, 16), or (2, 16, 16) with ``multi_pod``); ``cfg``, ``mesh_shape``
    and ``shape`` give a miniature."""
    from repro_torch.launch.roofline import StepWalk
    from repro_torch.models import sharding

    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    mesh_shape = tuple(mesh_shape or MESH_LLM[multi_pod])
    mesh_name = ("multi" if multi_pod else "single") + (
        "_opt" if optimized else "")
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": list(mesh_shape), "family": cfg.family,
        "source": cfg.source, "params": cfg.num_params(),
        "active_params": cfg.num_active_params(), "rank": rank,
        "device": "meta"}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        _save(rec, save)
        return rec
    t0 = time.time()
    try:
        init_fake_group(rank, n_dev)
        mesh = sharding.make_llm_mesh(mesh_shape, _mesh_axes(mesh_shape),
                                      "meta")
        set_optimized_knobs(mesh, optimized)
        step, arg_bytes = build_step(cfg, shape, mesh)
        with StepWalk() as walk:
            step()
        costs = walk.costs()
        report = walk.ledger.report()
        rec.update({
            "status": "ok", "walk_s": round(time.time() - t0, 1),
            "n_devices": n_dev,
            "flops_per_device": costs["flops"],
            "bytes_per_device": costs["bytes"],
            "collective_bytes_per_device": dict(report.bytes),
            "collective_counts_per_device": dict(report.counts),
            "collective_bytes_by_scope": _by_scope(report),
            "loop_aware": costs,
            "memory": {"argument_bytes": arg_bytes,
                       "temp_bytes": walk.peak_temp_bytes},
        })
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        set_optimized_knobs(None, False)
        if dist.is_initialized():
            dist.destroy_process_group()
    _save(rec, save)
    return rec


def _by_scope(report) -> Dict[str, int]:
    """The ledger's bytes by the first scope of each op's path."""
    out: Dict[str, int] = {}
    for op in report.sites:
        parts = op.op_name.split("/") if op.op_name else [""]
        key = "/".join(parts[:2] if parts[0] == "transpose" else parts[:1])
        out[key] = out.get(key, 0) + op.bytes
    return out


def _save(rec: Dict[str, Any], save: bool) -> None:
    if not save:
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(
            OUT_DIR, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"),
            "w") as f:
        json.dump(rec, f, indent=1, default=str)


def init_fake_group(rank: int, world: int) -> None:
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks (every collective a no-op; meta tensors included)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=world)


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
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh this process plays")
    ap.add_argument("--gnn", action="store_true",
                    help="dry-run the paper's 4D GNN step instead")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's beyond-paper attention knobs "
                         "(records saved with the _opt suffix)")
    args = ap.parse_args()
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    n_err = 0
    if args.gnn:
        for m in meshes:
            rec = run_gnn_dryrun(multi_pod=m == "multi", rank=args.rank)
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "traceback"}, indent=1, default=str))
            if rec["status"] != "ok":
                print(rec.get("traceback", ""))
                n_err += 1
        return 1 if n_err else 0
    n_ok = n_skip = 0
    for a in [args.arch] if args.arch else list(ARCH_IDS):
        for s in [args.shape] if args.shape else list(INPUT_SHAPES):
            for m in meshes:
                rec = run_one(a, s, multi_pod=m == "multi",
                              optimized=args.optimized, rank=args.rank)
                if rec["status"] == "ok":
                    n_ok += 1
                    mem = rec["memory"]
                    print(f"OK    {a:26s} {s:12s} {m:6s} "
                          f"walk={rec['walk_s']:6.1f}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                          f"temp={mem['temp_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP  {a:26s} {s:12s} {m:6s} "
                          f"({rec['reason'][:40]})", flush=True)
                else:
                    n_err += 1
                    print(f"ERROR {a:26s} {s:12s} {m:6s} "
                          f"{rec['error'][:160]}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
