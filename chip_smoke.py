#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # the full run, one card
    python3 chip_smoke.py --vertices 65536     # a quick run on a smaller graph

Phases, in order; any failure ends the script with a non-zero exit code:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compile ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``;
3. kernels — build the ogbn-products stand-in graph, then hold each CUDA
   kernel against its plain PyTorch version on the card at the serving
   shapes (extraction bit-identical on real sampled rows; fused tail within
   1e-5 relative); time both per call with CUDA events, and the kernel
   alone on the device with the profiler;
4. serve   — the main path: the port's ``InferenceEngine`` at the paper's
   width (d_hidden 256, 3 layers, seeded random weights) serves a Zipf(1.3)
   stream of single-vertex requests with both kernels on; every kernel's
   launch count is zeroed just before the stream and read just after, and
   every served logit row is recomputed by a second engine on the same card
   with the plain ``"torch"`` implementations and must match (atol 1e-4).

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``. Without a
card, the script exits non-zero before printing either.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TAIL_RTOL = 1e-5         # f32 sum of squares in another order
SERVE_ATOL = 1e-4        # two GCN forwards: fused vs plain tail and extraction


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 25, inner: int = 10,
            warmup: int = 5) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each, per
    call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, n: int = 50) -> float:
    """Mean device time of the CUDA kernel named ``kernel`` over ``n`` calls,
    from the profiler's CUPTI trace: the kernel alone, without the host
    time between launches that the event windows include."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    if len(hits) != 1 or hits[0].count != n:
        raise AssertionError(f"profiler found {[(e.key, e.count) for e in hits]}"
                             f" for {kernel} x {n}")
    return hits[0].device_time_total / n / 1e3


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """Least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch.cuda.get_device_name(0) = {name}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    so = _build.build()
    _build.load()
    log(f"[build] {so.relative_to(ROOT)} in {time.monotonic() - t0:.2f} s "
        f"({_build.nvcc_path()})")


def check_extraction(torch, A, plan, plan_b, dev) -> dict:
    """The extraction kernel against its plain version on real sampled rows
    (bit for bit), then both timed at the serving shape."""
    from repro_torch.kernels import extract_gather as eg
    csr = [torch.from_numpy(a).to(dev) for a in (A.indptr, A.indices,
                                                 A.data)]
    ids = torch.from_numpy(plan.batch_ids).to(dev)
    ids_b = torch.from_numpy(plan_b.batch_ids).to(dev)
    col_scale = torch.from_numpy(plan.col_scale).to(dev)
    col_scale_b = torch.from_numpy(plan_b.col_scale).to(dev)
    inv_p = float(plan.col_scale.max())
    max_deg = A.max_row_nnz()
    cases = [("per-column, diag", ids, ids, col_scale, True, max_deg),
             ("scalar, diag", ids, ids, inv_p, True, max_deg),
             ("per-column, off-diag", ids, ids_b, col_scale_b, False,
              max_deg),
             ("scalar, off-diag", ids, ids_b, inv_p, False, max_deg),
             ("per-column, diag, max_deg 8", ids, ids, col_scale, True, 8)]
    err = 0.0
    for name, rows, cols, scale, diag, md in cases:
        got = eg.extract_dense_fused(*csr, rows, cols, col_scale=scale,
                                     diag=diag, max_deg=md)
        torch.cuda.synchronize()
        ref = eg.extract_dense_plain(*csr, rows, cols, col_scale=scale,
                                     diag=diag, max_deg=md)
        case_err = (got - ref).abs().max().item()
        nnz = int(torch.count_nonzero(ref))
        log(f"[kernels] extract_dense_fused {name}: ({rows.shape[0]}, "
            f"{cols.shape[0]}) nnz {nnz}, max |kernel - plain| {case_err}, "
            f"bit-identical {torch.equal(got, ref)}")
        if not torch.equal(got, ref) or nnz == 0:
            raise AssertionError(f"extract_dense_fused {name}: kernel and "
                                 "plain version differ (or the block is "
                                 "empty)")
        err = max(err, case_err)

    kw = dict(col_scale=col_scale, diag=True, max_deg=max_deg)
    ms = time_ms(torch, lambda: eg.extract_dense_fused(*csr, ids, ids, **kw))
    plain_ms = time_ms(torch,
                       lambda: eg.extract_dense_plain(*csr, ids, ids, **kw))
    dev_ms = device_ms(torch,
                       lambda: eg.extract_dense_fused(*csr, ids, ids, **kw),
                       "extract_dense_kernel")
    b_r = b_c = ids.shape[0]
    deg = A.indptr[plan.batch_ids + 1] - A.indptr[plan.batch_ids]
    walked = int(deg.clip(max=max_deg).sum())
    n_bytes = (4 * b_r + 8 * b_r + 8 * walked + 8 * b_c + 4 * b_r * b_c)
    n_ops = walked * (math.ceil(math.log2(b_c)) + 1) + b_r * b_c
    bound = bound_ms(n_bytes, n_ops)
    log(f"[kernels] extract_dense_fused ({b_r}, {b_c}), {walked} edges, "
        f"{n_bytes} B: kernel {ms:.5f} ms per call ({dev_ms:.5f} ms on the "
        f"device), plain {plain_ms:.5f} ms, bound {bound:.6f} ms")
    return {"name": "extract_dense_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/extract_gather.cu",
            "replaces": "src/repro/kernels/extract_gather.py:101",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": ("bytes" if n_bytes /
                                            HBM_BYTES_PER_S >= n_ops /
                                            F32_OPS_PER_S else "operations"),
            "library_ms": None}


def check_fused_tail(torch, d_hidden: int, rows: int, dev) -> dict:
    """The fused-tail kernel against its plain version at the serving shape
    and at a ragged one, with and without mask and residual; then both
    timed at the serving shape (residual on, no dropout)."""
    from repro_torch.kernels import fused_layer as fl
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(b, d, mask, res):
        x = torch.randn((b, d), generator=gen, device=dev) * 2.0
        s = torch.rand((d,), generator=gen, device=dev) + 0.5
        m = (torch.rand((b, d), generator=gen, device=dev) < 0.7
             if mask else None)
        r = torch.randn((b, d), generator=gen, device=dev) if res else None
        return x, s, m, r

    err = 0.0
    for b, d in ((rows, d_hidden), (300, 33)):
        for mask, res, rms in ((False, False, True), (True, True, True),
                               (False, True, True), (True, True, False)):
            x, s, m, r = case(b, d, mask, res)
            kw = dict(dropout_rate=0.3 if mask else 0.0, eps=1e-6,
                      use_rmsnorm=rms, use_relu=True)
            got = fl.fused_layer(x, s, m, r, **kw)
            torch.cuda.synchronize()
            ref = fl.fused_layer_plain(x, s, m, r, **kw)
            case_err = (got - ref).abs().max().item()
            limit = TAIL_RTOL * max(1.0, ref.abs().max().item())
            log(f"[kernels] fused_layer ({b}, {d}) mask={mask} "
                f"residual={res} rmsnorm={rms}: max |kernel - plain| "
                f"{case_err:.3e} (limit {limit:.3e})")
            if not case_err <= limit:
                raise AssertionError(f"fused_layer ({b}, {d}): error "
                                     f"{case_err} above {limit}")
            err = max(err, case_err)

    x, s, _, r = case(rows, d_hidden, False, True)
    ms = time_ms(torch, lambda: fl.fused_layer(x, s, None, r))
    plain_ms = time_ms(torch, lambda: fl.fused_layer_plain(x, s, None, r))
    dev_ms = device_ms(torch, lambda: fl.fused_layer(x, s, None, r),
                       "fused_layer_kernel")
    n_el = rows * d_hidden
    n_bytes = 4 * n_el + 4 * d_hidden + 4 * n_el + 4 * n_el
    n_ops = 7 * n_el       # square-add, scale twice, relu, residual add
    bound = bound_ms(n_bytes, n_ops)
    log(f"[kernels] fused_layer ({rows}, {d_hidden}) residual, {n_bytes} B: "
        f"kernel {ms:.5f} ms per call ({dev_ms:.5f} ms on the device), "
        f"plain {plain_ms:.5f} ms, bound {bound:.6f} ms")
    return {"name": "fused_layer", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_layer.cu",
            "replaces": "src/repro/kernels/fused_layer.py:78",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": ("bytes" if n_bytes /
                                            HBM_BYTES_PER_S >= n_ops /
                                            F32_OPS_PER_S else "operations"),
            "library_ms": None}


def phase_serve(torch, np, ds, cfg, n_requests: int) -> dict:
    """The main path: live serving through both kernels, then every served
    row recomputed on the plain path. Returns the launch counts."""
    from repro_torch.core import gcn_model as M
    from repro_torch.kernels import extract_gather as eg
    from repro_torch.kernels import fused_layer as fl
    from repro_torch.serve import InferenceEngine, ServeOptions

    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                          ServeOptions(extract_impl="cuda"))
    ref_eng = InferenceEngine(
        params, dataclasses.replace(cfg, elementwise_impl="torch"),
        ds.adj_norm, ds.features, ServeOptions(extract_impl="torch"))
    eng.predict([0])                              # first-call warm-up
    eng.reset_stats()
    torch.cuda.synchronize()
    log(f"[serve] two engines built in {time.monotonic() - t0:.2f} s: "
        f"d_hidden {cfg.d_hidden}, {cfg.num_layers} layers, "
        f"{cfg.num_classes} classes, slots {eng.opts.slots} + support "
        f"{eng.opts.support}, e_cap {eng.spec.e_cap}")

    groups = []                                   # every micro-batch run
    execute = eng.backend.execute

    def recording_execute(group, now):
        groups.append(group)
        return execute(group, now)

    eng.backend.execute = recording_execute

    zipf = np.minimum(np.random.default_rng(7).zipf(1.3, size=n_requests),
                      ds.num_vertices) - 1
    eg.LAUNCHES = fl.LAUNCHES = 0
    t0 = time.monotonic()
    rids = []
    for v in zipf:
        rids.append(eng.submit([int(v)]))
        eng.pump()
    eng.drain()
    outs = {rid: eng.poll(rid) for rid in rids}
    dt = time.monotonic() - t0
    launches = {"extract_dense_fused": eg.LAUNCHES,
                "fused_layer": fl.LAUNCHES}
    st = eng.stats()
    log(f"[serve] {len(rids)} requests in {dt:.4f} s: "
        f"{len(rids) / dt:.1f} req/s, p50 {st['p50_ms']:.4f} ms, "
        f"p99 {st['p99_ms']:.4f} ms, {st['device_calls']} device calls, "
        f"occupancy {st['occupancy']:.4f}, launches {launches}")
    # one extraction and one tail per layer for every device call
    expect = {"extract_dense_fused": st["device_calls"],
              "fused_layer": cfg.num_layers * st["device_calls"]}
    if launches != expect or st["device_calls"] == 0:
        raise AssertionError(f"kernel launches {launches} on the main path, "
                             f"expected {expect}")
    if st["completed"] != len(rids):
        raise AssertionError(f"{st['completed']} of {len(rids)} completed")
    for rid, out in outs.items():
        if out is None or out.shape != (1, cfg.num_classes) \
                or not np.all(np.isfinite(out)):
            raise AssertionError(f"request {rid}: bad output {out}")

    # every served row, recomputed from the same micro-batches on the
    # plain path on the same card
    worst = 0.0
    rows = 0
    for group in groups:
        for c in ref_eng.backend.execute(group, 0.0):
            worst = max(worst, float(np.abs(outs[c.rid][c.pos]
                                            - c.value).max()))
            rows += 1
    log(f"[serve] {rows} served rows vs the plain path: max |diff| "
        f"{worst:.3e} (atol {SERVE_ATOL})")
    if not worst <= SERVE_ATOL:
        raise AssertionError(f"served logits differ from the plain path by "
                             f"{worst}")
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_stream(torch, eng, zipf)
    return launches


def profile_stream(torch, eng, zipf) -> None:
    """Where the time goes: the same stream again under the profiler (which
    slows the host), as the device's busy share and its top operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for v in zipf:
            eng.submit([int(v)])
            eng.pump()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] stream of {len(zipf)} requests: wall {wall_us:.1f} us, "
        f"device busy {busy_us:.1f} us ({100 * busy_us / wall_us:.2f} %), "
        f"{eng.stats()['device_calls']} device calls")
    for name, us in top:
        log(f"[profile]   {us:10.1f} us  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=2_449_029,
                    help="vertices of the ogbn-products stand-in "
                         "(default: the dataset's full count)")
    ap.add_argument("--requests", type=int, default=400)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.device import use_full_f32_matmul
    from repro_torch.graphs import get_dataset
    from repro_torch.serve import make_spec, make_support_pool, plan_batch

    use_full_f32_matmul()        # f32 GEMMs stay f32, as in the reference
    t_start = time.monotonic()
    device = phase_device(torch)
    phase_build()

    t0 = time.monotonic()
    ds = get_dataset("ogbn-products", scale_vertices=args.vertices)
    A = ds.adj_norm
    log(f"[kernels] graph {ds.name}: {A.n_rows} vertices, {A.nnz} nnz, "
        f"max_row_nnz {A.max_row_nnz()}, d_in {ds.feature_dim}, "
        f"{ds.num_classes} label classes, built in "
        f"{time.monotonic() - t0:.2f} s")
    cfg = dataclasses.replace(paper_model("ogbn-products"),
                              elementwise_impl="cuda")
    if cfg.d_in != ds.feature_dim:
        raise AssertionError(f"d_in {cfg.d_in} != {ds.feature_dim}")

    # real sampled rows: two micro-batch plans of the serving engine
    spec = make_spec(A, 64, 192)
    pool = make_support_pool(A.n_rows, 0)
    rng = np.random.default_rng(7)
    req = lambda: np.minimum(rng.zipf(1.3, size=spec.slots), A.n_rows) - 1
    plan, plan_b = plan_batch(req(), spec, pool), plan_batch(req(), spec,
                                                            pool)
    dev = torch.device("cuda")
    kernels = [check_extraction(torch, A, plan, plan_b, dev),
               check_fused_tail(torch, cfg.d_hidden, spec.total, dev)]

    launches = phase_serve(torch, np, ds, cfg, args.requests)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
