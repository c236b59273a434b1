#!/usr/bin/env python3
"""Time the block-ELL SpMM and its dX against other trees' on one card in
one sitting, on all three routes, beside their bounds.

    python3 tools/time_spmm_ell.py                           # this tree
    python3 tools/time_spmm_ell.py --other old=OLD_TREE/src   # and another

This tree's kernels ("new") run through ``repro_torch.kernels.spmm_ell``.
Each other tree (``--other LABEL=SRC``, repeatable) has its
``repro_torch/kernels/csrc/spmm_ell.cu`` and ``spmm_ell_dx.cu`` built
alone with ``nvcc``, against its own headers, into a library of its own
under ``build/spmm_other/``, and is called through ``repro_spmm_ell`` and
``repro_spmm_ell_dx`` (the C signatures the trees share; the dX's scratch
is sized for either tree's layout) on the same tensors.

Cases (``--cases``): ``train``, the training batch of ``chip_smoke.py``'s
phase 3 (the ogbn-products stand-in at ``--vertices``, batch 8192, 64 row
blocks x 32 slots of 128 x 128 tiles, d 256); ``dense``, the same shape
with every element nonzero with probability 0.5. Routes (``--routes``):
``f32`` (all float32), ``bf16`` (all bfloat16) and ``bf16_f32`` (bfloat16
tiles, float32 x and g: ``block_dtype="bf16"``). For each case and route
it prints ``spmm_ell_work``'s counts, holds every tree's forward (1e-4 of
the largest output; bf16 5e-2) and dX (1e-5 of the largest |dX|; bf16
5e-2) to the plain versions, compares this tree's outputs with each other
tree's bit for bit (or reports the largest difference), then times each
kernel in turns (the others, new, new, the others in reverse: CUDA events,
ms a call) and each tree's kernels alone on the device (the profiler's
sum over the call's kernels, each kernel's mean beside it). It prints the
card's name and power limit first and one JSON object a case and route.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTES = {"f32": (0, "float32", "float32"), "bf16": (1, "bfloat16",
                                                     "bfloat16"),
          "bf16_f32": (2, "bfloat16", "float32")}


def build_other(src: Path) -> ctypes.CDLL:
    """Another tree's SpMM and dX, alone, as a library of their own."""
    from repro_torch.kernels import _build
    csrc = src / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    out_dir = ROOT / "build" / "spmm_other"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libspmm_{h.hexdigest()[:16]}.so"
    if not so.exists():
        subprocess.run([_build.nvcc_path(), *_build.CFLAGS, "-shared",
                        "-I", str(csrc), str(csrc / "spmm_ell.cu"),
                        str(csrc / "spmm_ell_dx.cu"), "-o", str(so)],
                       check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("repro_spmm_ell", "repro_spmm_ell_dx"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def kernels_ms(torch, fn, prefix: str, n: int = 30) -> tuple:
    """(the mean device time of one call, each kernel's mean) over ``n``
    calls of ``fn``: the profiler's kernels whose names hold ``prefix``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):    # a trace can miss its launches: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if prefix in e.key and n // 2 <= e.count <= n:
                name = e.key.split("::")[-1].split("<")[0].split("(")[0]
                parts[name] = parts.get(name, 0.0) + (
                    e.device_time_total / e.count / 1e3)
        if parts:
            return sum(parts.values()), parts
    raise AssertionError(f"no trace held a kernel named *{prefix}* x {n}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=SRC: another tree's src directory, labelled")
    ap.add_argument("--cases", default="train,dense",
                    help="comma-separated, of train and dense")
    ap.add_argument("--routes", default="f32,bf16,bf16_f32",
                    help=f"comma-separated, of {sorted(ROUTES)}")
    ap.add_argument("--vertices", type=int, default=2_449_029,
                    help="vertices of the stand-in graph (the train case)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import spmm_ell as sp
    if not torch.cuda.is_available():
        print("time_spmm_ell: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    from repro_torch.device import use_full_f32_matmul
    use_full_f32_matmul()
    dev = torch.device("cuda")
    others = [tuple(x.split("=", 1)) for x in args.other]
    with ThreadPoolExecutor() as pool:        # one nvcc a tree, together
        libs = dict(zip([n for n, _ in others], pool.map(
            lambda o: build_other(Path(o[1])), others)))

    cases = {}
    names = args.cases.split(",")
    if "train" in names:
        from repro_torch.graphs import get_dataset
        ds = get_dataset("ogbn-products", scale_vertices=args.vertices)
        plan, graph, _ = cs.train_setup(torch, ds, dev)
        mb = plan.builder.build(*graph["adj"][0], graph["features"],
                                graph["labels"], 0)
        cases["train"] = mb.adj[0]
        del plan, graph, ds, mb
    if "dense" in names:
        gen = torch.Generator(device=dev).manual_seed(5)
        shape = (cs.TRAIN_BATCH // 128, 32, 128, 128)
        t = torch.randn(shape, generator=gen, device=dev)
        t *= torch.rand(shape, generator=gen, device=dev) < 0.5
        c = torch.randint(0, shape[0], shape[:2], generator=gen, device=dev,
                          dtype=torch.int32)
        cases["dense"] = (t, c)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    for case in names:
        t32, colidx = cases[case]
        n_rb, n_slots, bm, bn = t32.shape
        n_rows, d = cs.TRAIN_BATCH, 256
        n_cb = n_rows // bn
        chunks = -(-bm // 32) * -(-bn // 32)
        work = sp.spmm_ell_work(t32, colidx, n_cb)
        gen = torch.Generator(device=dev).manual_seed(7)
        h32 = torch.randn((n_rows, d), generator=gen, device=dev)
        g32 = torch.randn((n_rb * bm, d), generator=gen, device=dev)
        scratch = torch.empty((16 * n_rb * n_slots * chunks
                               + 8 * (2 * n_cb + n_rb * n_slots),),
                              dtype=torch.uint8, device=dev)
        for route in args.routes.split(","):
            code, ta, tx = ROUTES[route]
            tiles = t32.to(getattr(torch, ta))
            h, g = h32.to(getattr(torch, tx)), g32.to(getattr(torch, tx))

            def other_fwd(lib):
                out = torch.empty((n_rb * bm, d), dtype=h.dtype, device=dev)
                _build.check(lib.repro_spmm_ell(
                    tiles.data_ptr(), colidx.data_ptr(), h.data_ptr(),
                    out.data_ptr(), n_rb, n_slots, bm, bn, n_cb, d, code,
                    stream()), "other spmm_ell")
                return out

            def other_dx(lib):
                out = torch.empty((n_rows, d), dtype=g.dtype, device=dev)
                _build.check(lib.repro_spmm_ell_dx(
                    tiles.data_ptr(), colidx.data_ptr(), g.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), n_rb, n_slots, bm,
                    bn, n_cb, d, code, stream()), "other spmm_ell_dx")
                return out

            fwd = {name: (lambda lib=lib: other_fwd(lib))
                   for name, lib in libs.items()}
            fwd["new"] = lambda: sp.spmm_ell(tiles, colidx, h)
            dxs = {name: (lambda lib=lib: other_dx(lib))
                   for name, lib in libs.items()}
            dxs["new"] = lambda: sp.spmm_ell_dx(tiles, colidx, g, n_rows)
            bf16 = tx == "bfloat16"
            ref_f = sp.spmm_ell_plain(tiles, colidx, h).float()
            ref_b = sp.spmm_ell_dx_plain(tiles, colidx, g, n_rows).float()
            lim_f = (5e-2 if bf16 else cs.SPMM_RTOL) * max(
                1.0, ref_f.abs().max().item())
            lim_b = (5e-2 if bf16 else cs.DX_RTOL) * ref_b.abs().max().item()
            row = {"case": case, "route": route, "work": work,
                   "limits": {"fwd": lim_f, "dx": lim_b}}
            outs = {}
            for kind, calls, ref, lim in (("fwd", fwd, ref_f, lim_f),
                                          ("dx", dxs, ref_b, lim_b)):
                got = {name: call() for name, call in calls.items()}
                torch.cuda.synchronize()
                err = {name: (o.float() - ref).abs().max().item()
                       for name, o in got.items()}
                bad = {k: v for k, v in err.items() if not v <= lim}
                if bad:
                    raise AssertionError(f"{case} {route} {kind}: {bad} "
                                         f"above {lim}")
                same = all(torch.equal(calls["new"](), got["new"])
                           for _ in range(3))
                vs = {name: (0.0 if torch.equal(o, got["new"]) else
                             (o.float() - got["new"].float()).abs().max()
                             .item())
                      for name, o in got.items() if name != "new"}
                outs[kind] = {"max_abs_err": err, "repeatable": same,
                              "max_diff_vs_new": vs}
                del got
            del ref_f, ref_b
            torch.cuda.empty_cache()
            costs = {"fwd": sp.spmm_ell_cost(tiles, colidx, h),
                     "dx": sp.spmm_ell_dx_cost(tiles, colidx, g, n_rows)}
            for kind, calls, prefix in (("fwd", fwd, "spmm_ell_kernel"),
                                        ("dx", dxs, "dx_")):
                n_ops, n_bytes = costs[kind]
                bound = cs.bound_ms(n_bytes, n_ops)
                order = [n for n in calls if n != "new"]
                order = order + ["new", "new"] + order[::-1]
                turns = [cs.time_ms(torch, calls[name], reps=9, inner=10)
                         for name in order]
                device = {name: kernels_ms(torch, call, prefix)
                          for name, call in calls.items()}
                outs[kind].update(
                    bound_ms=bound, bound_by=cs._bound_by(n_bytes, n_ops),
                    turns=list(zip(order, turns)),
                    device_ms={k: v[0] for k, v in device.items()},
                    device_parts={k: v[1] for k, v in device.items()},
                    share={k: bound / v[0] for k, v in device.items()})
            row.update(outs)
            print(json.dumps(row), flush=True)
        del cases[case]
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
