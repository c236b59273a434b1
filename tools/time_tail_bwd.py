#!/usr/bin/env python3
"""Time the fused tail's backward (``fused_layer_bwd``, vector route)
against other trees' on one card in one sitting, beside its bound.

    python3 tools/time_tail_bwd.py                           # this tree
    python3 tools/time_tail_bwd.py --other old=OLD_TREE/src   # and another

This tree's backward ("new") runs through
``repro_torch.kernels.fused_layer.fused_layer_bwd``. Each other tree
(``--other LABEL=SRC``, repeatable) has its
``repro_torch/kernels/csrc/fused_layer.cu`` built alone with ``nvcc``,
against its own headers, into a library of its own under
``build/tail_other/``, and is called through its ``repro_fused_layer_bwd``
on the same tensors with that tree's own launch plan (its ``bwd_grid``:
grid and rows a warp) and a partial of its own. The entry point must take
the arguments this tree's does. ``--unchecked LABEL,...`` times other
trees whose results are wrong on purpose (variants cut down to split a
kernel's time).

Shapes (``--shapes``): ``train``, (8192, 256), each call on a cold L2
(``chip_smoke.py``'s 256 MB write before it); ``serve``, (256, 256), calls
back to back. Keep sources (``--sources``): ``counter`` (the training
step's: the key drawn in the kernel), ``bytes`` (a bool mask) and
``none``; dropout 0.3, RMSNorm and ReLU on. For each shape and source it
holds every version to ``fused_layer_bwd_plain`` (dx and d_scale within
``TAIL_BWD_RTOL`` of the largest |plain|), compares every other
version's dx with this tree's bit for bit and reports d_scale's largest
difference, checks that this tree repeats its bits over 10 calls, then
times each version in turns (the others, new, new, the others in reverse:
CUDA events, ms a call) and on the device (the profiler's sum over the
call's kernels, each kernel's mean beside it), and, with ``--graph``, the
span of a call inside a captured CUDA graph of 20 calls (first kernel's
start to last kernel's end, and the gap between the call's kernels). It
prints the card's name and power limit first, the launch floor at the
serving grid, and one JSON object a shape and source.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": (8192, 256, True), "serve": (256, 256, False)}
RATE = 0.3


def _module(path: Path, name: str):
    """``path`` imported as a module of its own name (another tree's
    ``_build.py`` or ``fused_layer.py``; the latter's imports resolve to
    this tree's package, and only its pure launch-plan functions are
    used)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Other:
    """Another tree's backward entry point and launch plan."""

    def __init__(self, label: str, src: Path):
        from repro_torch.kernels import _build
        kern = src / "repro_torch" / "kernels"
        csrc = kern / "csrc"
        tag = hashlib.sha256(label.encode()).hexdigest()[:8]
        sigs = _module(kern / "_build.py", f"_other_build_{tag}").SIGNATURES
        self.plan_mod = _module(kern / "fused_layer.py",
                                f"_other_fused_layer_{tag}")
        self.argtypes = sigs["repro_fused_layer_bwd"]
        if self.argtypes != _build.SIGNATURES["repro_fused_layer_bwd"]:
            raise SystemExit(f"{label}: its repro_fused_layer_bwd takes "
                             f"other arguments than this tree's")
        h = hashlib.sha256()
        for f in sorted(csrc.glob("*.cu*")):
            h.update(f.name.encode() + f.read_bytes())
        out_dir = ROOT / "build" / "tail_other"
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"libtail_{h.hexdigest()[:16]}.so"
        if not so.exists():
            subprocess.run([_build.nvcc_path(), *_build.CFLAGS, "-shared",
                            "-I", str(csrc), str(csrc / "fused_layer.cu"),
                            "-o", str(so)], check=True)
        self.lib = ctypes.CDLL(str(so))
        self.lib.repro_fused_layer_bwd.argtypes = self.argtypes
        self.lib.repro_fused_layer_bwd.restype = ctypes.c_int
        self.label = label

    def plan(self, rows: int) -> tuple:
        return self.plan_mod.bwd_grid(rows)


def make_call(torch, lib, plan: tuple, g, x, s, m, key):
    """A call of a backward entry point on these tensors with this launch
    plan, ``(grid, rows_per_warp)``, and a row of the partial a CTA (the
    vector route)."""
    from repro_torch.kernels import counter_rng as crng
    from repro_torch.kernels import fused_layer as fl
    from repro_torch.kernels import _build
    b, d = x.shape
    dev = x.device
    chunks = fl.vector_chunks(d, [g.data_ptr(), x.data_ptr(), s.data_ptr()],
                              None if m is None else m.data_ptr())
    rate = RATE if (m is not None or key is not None) else 0.0
    threshold = crng.keep_threshold(rate) if key is not None else 0
    grid, rows_per_warp = plan
    partial = torch.empty((grid, d), dtype=torch.float32, device=dev)

    def call():
        dx = torch.empty_like(x)
        ds = torch.empty_like(s)
        args = [g.data_ptr(), x.data_ptr(), s.data_ptr(),
                None if m is None else m.data_ptr(),
                None if key is None else key.data_ptr(), dx.data_ptr(),
                partial.data_ptr(), ds.data_ptr(), b, d, 1e-6, 1.0 - rate,
                threshold, 1, 1, chunks, grid, rows_per_warp,
                torch.cuda.current_stream(dev).cuda_stream]
        _build.check(lib.repro_fused_layer_bwd(*args), "other bwd")
        return dx, ds
    return call


def kernels_ms(torch, fn, flush, n: int = 40) -> tuple:
    """(the mean device time of one call, each kernel's mean) over ``n``
    calls of ``fn`` (each after ``flush()`` when given): the profiler's
    kernels whose names hold ``fused_layer``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):    # a trace can miss its launches: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if "fused_layer" in e.key and n // 2 <= e.count <= n:
                name = re.search(r"fused_layer\w*(<[^>]*>)?", e.key)[0]
                parts[name] = parts.get(name, 0.0) + (
                    e.device_time_total / e.count / 1e3)
        if parts:
            return sum(parts.values()), parts
    raise AssertionError(f"no trace held a fused_layer kernel x {n}")


def graph_span(torch, fn, flush, n: int = 20) -> dict:
    """One replay of a CUDA graph that captured ``n`` calls (each after
    ``flush()`` when given), profiled: per call, the span from its first
    kernel's start to its last kernel's end, the kernels' own time, and the
    gap between them (medians over the calls, µs)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up on the capture stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    flat = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type.name == "CUDA" and "fused_layer" in e.name)
    k = len(flat) // n                     # kernels a call
    calls = [flat[i * k:(i + 1) * k] for i in range(n)] if k else []
    spans = [c[-1][1] - c[0][0] for c in calls if c]
    busy = [sum(e - s for s, e in c) for c in calls if c]
    graph.reset()
    del graph
    return {"calls": len(calls), "kernels_a_call": k,
            "span_us": statistics.median(spans) if spans else None,
            "kernels_us": statistics.median(busy) if busy else None,
            "gap_us": (statistics.median([a - b for a, b in
                                          zip(spans, busy)])
                       if spans else None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=SRC: another tree's src directory, labelled")
    ap.add_argument("--shapes", default="train,serve",
                    help=f"comma-separated, of {sorted(SHAPES)}")
    ap.add_argument("--sources", default="counter,bytes,none",
                    help="comma-separated, of counter, bytes and none")
    ap.add_argument("--graph", action="store_true",
                    help="also time a call inside a captured CUDA graph")
    ap.add_argument("--unchecked", default="",
                    help="LABEL,...: other trees timed whatever their "
                         "results (cut-down variants for a split)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.core import sampling as smp
    from repro_torch.kernels import fused_layer as fl
    if not torch.cuda.is_available():
        print("time_tail_bwd: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    others = [tuple(o.split("=", 1)) for o in args.other]
    with ThreadPoolExecutor() as pool:        # one nvcc a tree, together
        trees = list(pool.map(lambda o: Other(o[0], Path(o[1])), others))
    flush = cs.l2_flushers(torch, dev)["written"]
    grid = fl.bwd_grid(SHAPES["serve"][0])[0]
    floor = cs.launch_floor_ms(torch, grid, 32 * fl.ROWS_PER_CTA)
    print(json.dumps({"launch_floor_ms": floor, "serve_grid": grid}),
          flush=True)
    key = smp.key_tensor(smp.step_key(0, 7), dev)

    for shape in args.shapes.split(","):
        b, d, cold = SHAPES[shape]
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((b, d), generator=gen, device=dev) * 2.0
        s = torch.rand((d,), generator=gen, device=dev) + 0.5
        g = torch.randn((b, d), generator=gen, device=dev)
        mask = torch.rand((b, d), generator=gen, device=dev) < 1.0 - RATE
        fl_flush = flush if cold else None
        for source in args.sources.split(","):
            m = mask if source == "bytes" else None
            k = key if source == "counter" else None
            rate = 0.0 if source == "none" else RATE
            kw = dict(dropout_rate=rate, dropout_key=k)
            calls = {"new": lambda: fl.fused_layer_bwd(g, x, s, m, **kw)}
            for t in trees:
                calls[t.label] = make_call(torch, t.lib, t.plan(b), g, x, s,
                                           m, k)
            pdx, pds = fl.fused_layer_bwd_plain(g, x, s, m, **kw)
            lim = (cs.TAIL_BWD_RTOL * pdx.abs().max().item(),
                   cs.TAIL_BWD_RTOL * pds.abs().max().item())
            got = {name: c() for name, c in calls.items()}
            torch.cuda.synchronize()
            row = {"shape": [b, d], "source": source, "l2": (
                "written" if cold else "warm"), "limits": lim}
            err = {n: ((o[0] - pdx).abs().max().item(),
                       (o[1] - pds).abs().max().item())
                   for n, o in got.items()}
            bad = {n: e for n, e in err.items()
                   if not (e[0] <= lim[0] and e[1] <= lim[1])
                   and n not in args.unchecked.split(",")}
            if bad:
                raise AssertionError(f"{shape} {source}: {bad} above {lim}")
            repeat = [calls["new"]() for _ in range(10)]
            row["new_repeats"] = all(
                torch.equal(o[0], got["new"][0])
                and torch.equal(o[1], got["new"][1]) for o in repeat)
            row["max_abs_err"] = err
            row["dx_bits_equal_new"] = {
                n: torch.equal(o[0], got["new"][0])
                for n, o in got.items() if n != "new"}
            row["d_scale_max_diff_vs_new"] = {
                n: (o[1] - got["new"][1]).abs().max().item()
                for n, o in got.items() if n != "new"}
            del got, repeat
            n_ops, n_bytes = fl.fused_layer_bwd_cost(g, x, s, m, **kw)
            bound = cs.bound_ms(n_bytes, n_ops)
            order = [n for n in calls if n != "new"]
            order = order + ["new", "new"] + order[::-1]
            row["turns"] = [(n, cs.time_ms(torch, calls[n], flush=fl_flush))
                            for n in order]
            device = {n: kernels_ms(torch, c, fl_flush)
                      for n, c in calls.items()}
            row.update(bound_ms=bound, bytes=n_bytes,
                       device_ms={n: v[0] for n, v in device.items()},
                       device_parts={n: v[1] for n, v in device.items()},
                       share={n: bound / v[0] for n, v in device.items()})
            if args.graph:
                row["graph"] = {n: graph_span(torch, c, fl_flush)
                                for n, c in calls.items()}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
