"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` — one
``nvcc`` per source, all started together — and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so a stale build is
never loaded. It lands in ``build/repro_torch/`` at the root of the
checkout, at first use; nothing is built when a module is imported.

``nvcc`` comes from ``PATH`` or ``/usr/local/cuda/bin/nvcc``; without it,
:func:`load` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# every exported function: name -> argtypes (pointers and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints); all return an int
SIGNATURES = {
    # rp, ci, val, rows, cols, col_scale|null, scalar_scale, diag,
    # b_r, b_c, max_deg, grid, rows_per_cta, staged, bf16_out, out, stream
    "repro_extract_dense_fused": [_P, _P, _P, _P, _P, _P, _F, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # x, scale, mask|null, key|null, res|null, out, rows, d, eps,
    # keep_prob, threshold, use_rmsnorm, use_relu, chunks, stream
    "repro_fused_layer": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I,
                          _I, _I, _P],
    # g, x, scale, mask|null, key|null, dx, partial|null, d_scale, rows, d,
    # eps, keep_prob, threshold, use_rmsnorm, use_relu, chunks, grid,
    # rows_per_warp, stream
    "repro_fused_layer_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                              _F, _I, _I, _I, _I, _I, _I, _P],
    # tiles, colidx, x, out, n_rb, n_slots, bm, bn, n_cb, d, route, stream
    "repro_spmm_ell": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # tiles, colidx, g, out, work, n_rb, n_slots, bm, bn, n_cb, d, route,
    # stream
    "repro_spmm_ell_dx": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # q, k, v, out, lse, b, sq, t, h, kv, hd, causal, use_window, window,
    # q_offset, scale, bf16, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _F, _I, _P],
    # hd, bf16, &bytes, &CTAs an SM: the forward's dynamic shared memory
    "repro_flash_attention_smem": [_I, _I, _P, _P],
    # q, k, v, out, lse, dout, stats, part|null, dq, dk, dv, b, sq, t, h,
    # kv, hd, causal, use_window, window, q_offset, pair_lo, pair_hi,
    # split, scale, bf16, stream
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _I, _P],
    # hd, bf16, &dq bytes, &dk/dv bytes: the kernels' dynamic shared memory
    "repro_flash_attention_bwd_smem": [_I, _I, _P, _P],
    # key, n, out, stream
    "repro_hash_keys": [_P, _L, _P, _P],
    # key, n, threshold, out, stream
    "repro_keep_mask": [_P, _L, _I, _P, _P],
    # grid, threads, stream: an empty kernel, the launch floor (measurement)
    "repro_empty_kernel": [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin: "
                       "the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the compiler's output if
    any fails. Every process started is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, _) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n"
                               f"{out}")


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the
    library's path."""
    so = _library_path()
    if so.exists():
        return so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    _run_all([[nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(_sources(), objs)])
    tmp = BUILD_DIR / f"{tag}.so"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, so)                  # atomic: concurrent builds are safe
    for obj in objs:
        obj.unlink()
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
