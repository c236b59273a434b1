#!/usr/bin/env python3
"""Time the flash-attention forward's float32 route against other trees'
on one card in one sitting, beside its bound and SDPA.

    python3 tools/time_flash_fwd.py                          # this tree
    python3 tools/time_flash_fwd.py --other old=OLD_TREE/src  # and another

This tree's kernel ("new") runs through
``repro_torch.kernels.flash_attention``. Each other tree (``--other
LABEL=SRC``, repeatable) has its ``repro_torch/kernels/csrc/
flash_attention.cu`` built alone with ``nvcc``, against its own headers,
into a library of its own under ``build/flash_fwd_other/``, and is called
through its ``repro_flash_attention`` (a tree from before the query
offset takes the signature without ``q_offset``, every offset 0 here) on
the same tensors. At each shape (``--shapes``: the LLM training shape (2,
2048, 32/4 heads of 64, causal), the serving shape (1, 512, ...), hd 128
at internlm2's 16/8 heads over 2048 tokens) it holds each kernel's out and
lse against the plain version (``FLASH_ATOL``), checks that two calls of
this tree's kernel give the same bits, then times in turns: the others,
new, new, the others in reverse (CUDA events, ms a call), each kernel
alone on the device (profiler), and ``scaled_dot_product_attention`` in
float32 beside this tree's kernel in turns (new, SDPA, SDPA, new). It
prints the card's name and power limit first and one JSON object a shape.
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

# (label, b, sq, h, kv, hd): causal, T = Sq
SHAPES = {"train": (2, 2048, 32, 4, 64), "serving": (1, 512, 32, 4, 64),
          "hd128": (1, 2048, 16, 8, 128)}


def build_other(src: Path) -> ctypes.CDLL:
    """Another tree's flash forward, alone, as a library of its own."""
    from repro_torch.kernels import _build
    csrc = src / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    out_dir = ROOT / "build" / "flash_fwd_other"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libflash_fwd_{h.hexdigest()[:16]}.so"
    if not so.exists():
        subprocess.run([_build.nvcc_path(), *_build.CFLAGS, "-shared",
                        "-I", str(csrc), str(csrc / "flash_attention.cu"),
                        "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    sig = list(_build.SIGNATURES["repro_flash_attention"])
    lib.offset = "int q_offset" in (csrc / "flash_attention.cu").read_text()
    if not lib.offset:
        del sig[14]
    lib.repro_flash_attention.argtypes = sig
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=SRC: another tree's src directory, labelled")
    ap.add_argument("--shapes", default="train,serving,hd128",
                    help=f"comma-separated, of {sorted(SHAPES)}")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    others = [tuple(x.split("=", 1)) for x in args.other]
    with ThreadPoolExecutor() as pool:        # one nvcc a tree, together
        libs = dict(zip([n for n, _ in others], pool.map(
            lambda o: build_other(Path(o[1])), others)))
    rng = np.random.default_rng(3)

    def other_call(lib, q, k, v):
        b, sq, h, hd = q.shape
        t, kv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        _build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, t, h, kv, hd, 1, 0, 0,
            *((0,) if lib.offset else ()), float(hd ** -0.5),
            0, torch.cuda.current_stream().cuda_stream), "other flash")
        return out, lse

    for label in args.shapes.split(","):
        b, s, h, kv, hd = SHAPES[label]
        mk = lambda *shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)
        q, k, v = mk(b, s, h, hd), mk(b, s, kv, hd), mk(b, s, kv, hd)
        new_call = lambda: fa.flash_attention(q, k, v, True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, True)
        calls = {name: (lambda lib=lib: other_call(lib, q, k, v))
                 for name, lib in libs.items()}
        calls["new"] = new_call
        err = {}
        for name, call in calls.items():
            out, lse = call()
            torch.cuda.synchronize()
            err[name] = max((out - ref).abs().max().item(),
                            (lse - ref_lse).abs().max().item())
            if err[name] > cs.FLASH_ATOL:
                raise AssertionError(f"{label} {name}: {err[name]}")
        a, b2 = new_call(), new_call()
        same = all(torch.equal(x, y) for x, y in zip(a, b2))
        del ref, ref_lse, a, b2
        torch.cuda.empty_cache()
        order = list(calls) + list(calls)[::-1]
        turns = [cs.time_ms(torch, calls[name], reps=5, inner=4)
                 for name in order]
        dev_ms = {name: cs.device_ms(torch, call, "flash_attention_kernel<",
                                     n=20)
                  for name, call in calls.items()}
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
        sdpa_turns = [cs.time_ms(torch, fn, reps=5, inner=4)
                      for fn in (new_call, sdpa, sdpa, new_call)]
        n_ops, n_bytes = fa.flash_attention_cost(q, k, v, True, None)
        bound = cs.bound_ms(n_bytes, n_ops)
        row = {"shape": label, "q": [b, s, h, hd], "kv": [b, s, kv, hd],
               "max_abs_err": err, "same_bits": same, "bound_ms": bound,
               "device_ms": dev_ms,
               "share": {n: bound / t for n, t in dev_ms.items()},
               "turns": list(zip(order, turns)),
               "sdpa_turns": list(zip(("new", "sdpa", "sdpa", "new"),
                                      sdpa_turns))}
        print(json.dumps(row), flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
