"""The roofline of one step, walked op by op.

Counterpart of ``repro/launch/roofline.py``, with its names and its keys.
The reference re-derives a compiled program's costs from its HLO text,
multiplying loop bodies by their trip counts. The port runs eagerly, so
:func:`analyze_step` runs the step once under one ``TorchDispatchMode``
and counts each op as it is dispatched (a Python loop is unrolled by
construction, no trip count is needed):

  * FLOPs  — every aten matmul (``mm``, ``addmm``, ``bmm``, ...) by
             ``torch.utils.flop_counter``'s registered formulas, and each
             kernel wrapper by its cost function (``kernels/_observe.py``:
             the products its inputs need); the aten ops a wrapper
             dispatches (its plain version on the CPU) are not counted
             again. Element-wise FLOPs outside the kernels are not counted,
             as in the reference.
  * bytes  — the reference's traffic proxy: operands + result of each
             matmul, the result of every other op that writes memory
             (views, which alias, and ``empty``, which writes nothing,
             apart), each kernel's bytes from its cost function, and the
             collectives' bytes. Copies (``clone``, ``copy_``, a same-type
             ``to``) are kept apart in ``bytes_copy``.
  * collective bytes — from the collective ledger (``obs/comm.py``): the
             per-rank result bytes of each all-reduce, all-gather and hop.

A kernel whose work depends on the data (the SpMM and its dX, the
extraction) counts what this run's data needs, read on the host; on the
meta device no value is known, so it counts every slot and the result says
so (``"upper_bound": True``). The walk is a diagnostic eager step, never a
captured one.

The terms use one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
full 700 W power limit): 3.35e12 B/s of HBM3, 67e12 FLOP/s in float32
outside the tensor cores, 989e12 in bf16 on them, and NVLink 4 at 450e9
B/s per direction per GPU. A mesh of 256 ranks spans nodes, whose links
are slower than NVLink: there the collective term is a lower bound.
"""
from __future__ import annotations

import json
import os
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _observe
from repro_torch.obs import comm

# --- NVIDIA H100 SXM constants (per card) ---
HBM_BW = 3.35e12             # bytes/s
PEAK_FLOPS_F32 = 67e12       # float32, outside the tensor cores
PEAK_FLOPS_BF16 = 989e12     # bf16 (and f16), dense, on the tensor cores
NVLINK_BW = 450e9            # bytes/s per direction per GPU (NVLink 4)

_COLLECTIVES = comm.COLLECTIVES

_aten = torch.ops.aten
# the matmuls whose operands count as traffic besides their result
_MATMULS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                      _aten._scaled_mm))
_COPIES = frozenset((_aten.copy_, _aten.clone, _aten.lift_fresh_copy))
# allocations that write nothing
_EMPTY = frozenset((_aten.empty, _aten.empty_like, _aten.empty_strided,
                    _aten.new_empty, _aten.new_empty_strided))
# kernel wrappers whose cost depends on the data
_DATA_DEPENDENT = frozenset(("spmm_ell", "spmm_ell_dx",
                             "extract_dense_fused"))


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _writes(func) -> bool:
    """Whether the op's outputs are memory it writes: not a view (an
    output that aliases an input without writing it)."""
    for ret in func._schema.returns:
        info = ret.alias_info
        if info is not None and not info.is_write:
            return False
    return True


def _fresh(func) -> bool:
    """Whether the op's outputs are new storage (no view, no in-place or
    ``out=`` write into an input)."""
    return all(ret.alias_info is None for ret in func._schema.returns)


class StepWalk(TorchDispatchMode, _observe.KernelObserver):
    """One walk of a step: ``with StepWalk() as walk: step()`` (the
    collective ledger and the kernel hook included), then
    :meth:`costs`. It also follows the storage the step allocates:
    ``peak_temp_bytes`` is the most of it alive at once (on the meta
    device, what the step would hold beyond its arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_copy = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.upper_bound = False
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._seen: Dict[int, int] = {}
        self._recording = comm.recording()
        self._observing = _observe.observing(self)

    def __enter__(self):
        self.ledger = self._recording.__enter__()
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observing.__exit__(*exc)
            self._recording.__exit__(*exc)

    # -- aten ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":        # c10d: the ledger counts them
            return out
        outs = _tensors(out)
        if _fresh(func):
            self._track(outs)
        if self.depth:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _MATMULS:
            self.bytes += _nbytes(_tensors(args)) + _nbytes(outs)
        elif packet in _COPIES or (packet is _aten._to_copy and all(
                o.dtype == i.dtype for o, i in zip(outs, _tensors(args)))):
            self.bytes_copy += _nbytes(outs)
        elif packet not in _EMPTY and _writes(func):
            self.bytes += _nbytes(outs)
        return out

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = n = st.nbytes()
            self.live_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes,
                                       self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key)

    # -- kernel wrappers -------------------------------------------------------

    def kernel_done(self, name, cost, args, kwargs, out) -> None:
        if name in _DATA_DEPENDENT and any(
                t.device.type == "meta" for t in _tensors(args)):
            self.upper_bound = True
        self.depth += 1                  # the count's own ops are not
        try:                             # the step's
            fl, by = cost(*args, out=out, **kwargs)
        finally:
            self.depth -= 1
        ent = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                             "bytes": 0.0})
        ent["launches"] += 1
        ent["flops"] += fl
        ent["bytes"] += by
        self.flops += fl
        self.bytes += by

    # -- the result ------------------------------------------------------------

    def costs(self) -> Dict[str, object]:
        """The reference's ``analyze_hlo`` keys (``flops``, ``bytes``,
        ``bytes_copy``, ``coll_<kind>``, ``coll_total``), plus
        ``upper_bound`` and the per-kernel ``kernels`` counts."""
        rep = self.ledger.report()
        coll = {f"coll_{k}": float(rep.bytes[k]) for k in _COLLECTIVES}
        return {"flops": float(self.flops),
                "bytes": float(self.bytes + rep.total_bytes),
                "bytes_copy": float(self.bytes_copy), **coll,
                "coll_total": float(rep.total_bytes),
                "upper_bound": self.upper_bound,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def analyze_step(fn, *args, **kwargs) -> Dict[str, object]:
    """Per-rank costs of one eager run of ``fn(*args, **kwargs)`` (see the
    module docstring)."""
    with StepWalk() as walk:
        fn(*args, **kwargs)
    return walk.costs()


# ---------------------------------------------------------------------------
# Roofline terms + model FLOPs
# ---------------------------------------------------------------------------

def peak_flops(dtype: torch.dtype = torch.float32) -> float:
    """The card's peak rate for arithmetic in ``dtype``."""
    return (PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16)
            else PEAK_FLOPS_F32)


def roofline_terms(costs: Dict[str, float],
                   dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The three terms in seconds, the dominant one, and the bound (the
    largest term: the least time the card could take)."""
    t_compute = costs["flops"] / peak_flops(dtype)
    t_memory = costs["bytes"] / HBM_BW
    t_coll = costs["coll_total"] / NVLINK_BW
    dominant, bound = max(("compute", t_compute), ("memory", t_memory),
                          ("collective", t_coll), key=lambda kv: kv[1])
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "t_bound_s": bound}


def model_flops(cfg, shape, n_devices: int) -> float:
    """Analytic MODEL_FLOPS per device: 6*N*D for training (N the active
    parameters), 2*N*D forward-only for prefill, 2*N per sequence for
    decode (one token each)."""
    n_active = cfg.num_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        total = 2.0 * n_active * tokens
    else:
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def load_dryrun_records(dirpath: str) -> List[dict]:
    recs = []
    if not os.path.isdir(dirpath):
        return recs
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".json"):
            with open(os.path.join(dirpath, fn)) as f:
                recs.append(json.load(f))
    return recs
