#!/usr/bin/env python3
"""Build the flash-attention backward with other dk/dv query blocks at one
head dim, and time each beside this tree's on one card in one sitting.

    python3 tools/time_flash_bwd_blocks.py --hd 80 \\
        --variant bf16:64 --variant bf16:32 --variant f32:32 --variant f32:16

Each variant (``ROUTE:ROWS``) is this tree's ``flash_attention_bwd.cu``
with the route's query block (``dkdv_q_block`` for bf16,
``dkdv_f32_q_block`` for f32) set to ROWS at head dim ``--hd`` and left as
it is at the others, built alone with ``nvcc -Xptxas -v`` into a library of
its own under ``build/flash_bwd_blocks/`` and called through its
``repro_flash_attention_bwd`` with the wrapper's arguments (the plan's
pairing and split do not depend on the block). At the shape (``--shape
B,S,H,KV``, causal, T = S; the default is zamba2-2.7b's shared attention
over 1 x 1024 tokens) it prints ptxas's registers, stack and spills of the
variant's dk/dv kernel, holds dq, dk and dv against the plain version (5e-2
in bf16, 1e-4 in f32, of each one's largest |plain|) and a second call's
bits against the first's, then times this tree's wrapper and the variants
of the route in turns (CUDA events, ms a call) and each alone on the device
(profiler). It prints the card's name and power limit first and one JSON
object a route.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK_FN = {"bf16": "dkdv_q_block", "f32": "dkdv_f32_q_block"}


def build_variant(route: str, rows: int, hd: int) -> tuple:
    """(library, ptxas's line of the variant's dk/dv kernel at hd)."""
    from repro_torch.kernels import _build
    src = (_build._CSRC / "flash_attention_bwd.cu").read_text()
    fn = BLOCK_FN[route]
    pat = re.compile(r"(constexpr int " + fn + r"\(\) \{\s*return )([^;]*);")
    if not pat.search(src):
        raise RuntimeError(f"no {fn}() in flash_attention_bwd.cu")
    src = pat.sub(lambda m: f"{m.group(1)}HD == {hd} ? {rows} : "
                            f"({m.group(2)});", src, count=1)
    out_dir = ROOT / "build" / "flash_bwd_blocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"bwd_{route}_{hd}_{rows}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    done = subprocess.run(
        [_build.nvcc_path(), *_build.CFLAGS, "-Xptxas", "-v", "-shared",
         "-I", str(_build._CSRC), str(cu), "-o", str(so)],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc {cu.name} failed:\n{done.stderr}")
    kernel = ("flash_bwd_dkdv_wgmma_kernel" if route == "bf16"
              else "flash_bwd_dkdv_f32_kernel")
    lines = (done.stdout + done.stderr).splitlines()
    report = ""
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line \
                and f"ILi{hd}E" in line:
            report = " ".join(x.strip() for x in lines[i + 1:i + 4])
    lib = ctypes.CDLL(str(so))
    lib.repro_flash_attention_bwd.argtypes = \
        _build.SIGNATURES["repro_flash_attention_bwd"]
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    return lib, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hd", type=int, default=80)
    ap.add_argument("--variant", action="append", default=[],
                    help="ROUTE:ROWS, ROUTE bf16 or f32 (repeatable)")
    ap.add_argument("--shape", default="1,1024,32,32",
                    help="B,S,H,KV (causal, T = S)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("time_flash_bwd_blocks: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    b, s, h, kv = map(int, args.shape.split(","))
    hd = args.hd
    variants = [(r, int(n)) for r, n in (v.split(":") for v in args.variant)]
    with ThreadPoolExecutor() as pool:        # one nvcc a variant, together
        built = dict(zip(variants, pool.map(
            lambda v: build_variant(v[0], v[1], hd), variants)))
    _build.load()
    rng = np.random.default_rng(5)
    for route in ("bf16", "f32"):
        mine = [v for v in variants if v[0] == route]
        if not mine:
            continue
        dtype = torch.bfloat16 if route == "bf16" else torch.float32
        mk = lambda *shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
        q, k, v, dout = mk(b, s, h, hd), mk(b, s, kv, hd), \
            mk(b, s, kv, hd), mk(b, s, h, hd)
        out, lse = fa.flash_attention(q, k, v, True)
        args6 = (q, k, v, out, lse, dout)
        plan = fa.bwd_plan(b, s, s, h, kv, hd, dtype, True)

        def variant_call(lib):
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            stats = torch.empty(plan.stats_floats, dtype=torch.float32,
                                device=dev)
            part = (torch.empty(plan.part_floats, dtype=torch.float32,
                                device=dev) if plan.part_floats else None)
            _build.check(lib.repro_flash_attention_bwd(
                *(x.data_ptr() for x in args6), stats.data_ptr(),
                None if part is None else part.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, s, h, kv, hd, 1, 0, 0,
                0, plan.pair_lo, plan.pair_hi, plan.split, float(hd ** -0.5),
                int(route == "bf16"),
                torch.cuda.current_stream().cuda_stream), "variant")
            return dq, dk, dv

        calls = {"this tree": lambda: fa.flash_attention_bwd(*args6, True)}
        for v_ in mine:
            calls[f"{route}:{v_[1]}"] = \
                lambda lib=built[v_][0]: variant_call(lib)
        ref = fa.flash_attention_bwd_plain(*args6, True)
        limit = cs.BF16_TOL if route == "bf16" else cs.FLASH_BWD_RTOL
        rel, same = {}, {}
        for name, call in calls.items():
            got, again = call(), call()
            torch.cuda.synchronize()
            rel[name] = max((a.float() - r.float()).abs().max().item()
                            / max(r.float().abs().max().item(), 1e-30)
                            for a, r in zip(got, ref))
            same[name] = all(torch.equal(x, y) for x, y in zip(got, again))
            if not (rel[name] <= limit and same[name]):
                raise AssertionError(f"{name}: {rel[name]}, {same[name]}")
        del ref
        torch.cuda.empty_cache()
        order = list(calls) + list(calls)[::-1]
        turns = [cs.time_ms(torch, calls[n], reps=5, inner=3, warmup=2)
                 for n in order]
        dev_ms = {n: cs.device_ms(torch, c, plan.kernels(), n=10)
                  for n, c in calls.items()}
        n_ops, n_bytes = fa.flash_attention_bwd_cost(*args6, True)
        peak = cs.BF16_TC_OPS_PER_S if route == "bf16" else cs.F32_OPS_PER_S
        print(json.dumps({
            "route": route, "q": [b, s, h, hd], "kv": [b, s, kv, hd],
            "tree_q_block": plan.q_block,
            "ptxas": {f"{r}:{n}": built[(r, n)][1] for r, n in mine},
            "rel_err": rel, "same_bits": same,
            "bound_ms": cs.bound_ms(n_bytes, n_ops, peak),
            "device_ms": dev_ms, "turns": list(zip(order, turns))}),
            flush=True)
        del q, k, v, dout, out, lse, args6
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
