"""The collective ledger: what the port's own collectives send, counted
where they are called.

Counterpart of ``repro/obs/hlo.py``, with its names and its byte
convention. The reference lowers a function and parses the compiled HLO
for collective instructions; the port's collectives are explicit
``torch.distributed`` calls, so each call site reports itself
(``precision.AllReduce``, ``pmm3d``'s ``pmax``, gathers and point-to-point
hops, ``fourd``'s gradient all-reduces). With no ledger recording, a report
costs one check of a module-level list: no allocation and no host read,
so a captured step and its replays are untouched. A captured graph
records once, at its capture (its replays make no Python call), so
:func:`comm_report` runs ``fn`` eagerly.

Byte convention (``hlo.py``'s): the bytes of the RESULT on one rank. An
all-reduce counts the local shape, an all-gather the gathered one; a
point-to-point hop counts as one ``collective-permute`` of what this rank
sends, once per hop (not once for the send and again for the receive),
with the bytes split by element type (a quantized hop sends an s8 payload
and f32 row scales). Kind and dtype names are the reference's, so one
report compares with the other key for key.

Scopes. Each record carries the stack of enclosing scopes, joined by
``/``: the ``obs.phase`` names (``sample``, ``extract``, ``reshard``,
``spmm``, ``gemm``, ``tail``, ``rotate``) and the rings' own
(``ring_rs``, ``ring_ag``, ``ring_rs_q``, ``ring_ag_q``: the reference's
``named_scope`` names). A collective in an autograd backward records
under the scope its forward ran in, as XLA's transposed ops keep the
forward's ``named_scope`` (prefixed ``transpose``, as there); so
``bytes_for_scope("reshard")`` means the same in both packages. The
pipelined reduce + GEMM (``ring_psum_gemm`` and its quantized form) adds
the scope ``ring_gemm`` around its forward ring, whose all-gather hops
each have a chunk's GEMM between their post and their wait.

What the call sites cannot see. A recording also watches the dispatcher:
every ``c10d`` op dispatched inside it (``allreduce_``, ``allgather_``,
``send``, ``recv_``, ...) is counted in :attr:`CommReport.dispatched`,
whether or not its call site reports itself, and
:meth:`CommReport.assert_no_collectives` fails on any of them. So a
``torch.distributed`` call that bypasses the port's collectives still
breaks the communication-free claim.

Overlap (``hlo.py``'s ``overlap_report``). The port's counterpart of the
reference's ``slack`` is the number of compute launches dispatched
between a hop's post (``pmm3d._post``) and its wait (``pmm3d._wait``):
GEMMs, plus the port's kernel launches. The ring posts each all-gather
hop before the chunk's GEMM and waits after it, so every such hop scores
at least one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the kinds only the port's serving over a mesh sends, which XLA has no
# instruction for (the reference's controller places the plan on every
# device and reads the logits back): rank 0's plan broadcast and its
# gather of the logits (``serve/distributed.py``); a report lists them
# only where they occur, so every other report keys as the reference's
SERVE_KINDS = ("broadcast", "gather")
KINDS = COLLECTIVES + SERVE_KINDS

# the namespaces of the dispatcher's collective ops, and the kind of each
# op the port's collectives dispatch (a hop is a send and a receive)
_C10D_NAMESPACES = frozenset(("c10d", "_c10d_functional"))
C10D_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
              "_allgather_base_": "all-gather",
              "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter",
              "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
              "send": "collective-permute", "recv_": "collective-permute",
              "broadcast_": "broadcast", "gather_": "gather"}

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.float16: "f16", torch.bfloat16: "bf16",
                torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
                torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def dtype_name(dtype: torch.dtype) -> str:
    """The HLO element-type name of a torch dtype (``f32``, ``s8``, ...)."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One collective: kind, the scope path it ran in, its bytes and their
    split by element type."""

    kind: str                                  # e.g. "all-gather"
    op_name: str                               # scope path, or ""
    bytes: int
    dtype_bytes: Tuple[Tuple[str, int], ...]   # ((dtype, bytes), ...)


@dataclasses.dataclass(frozen=True)
class CommReport:
    """Per-collective counts and per-rank byte totals of one run."""

    counts: Dict[str, int]
    bytes: Dict[str, int]
    sites: Tuple[CommOp, ...] = ()
    # c10d ops dispatched during the run, by op name, reported or not
    dispatched: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def kinds(self) -> Tuple[str, ...]:
        """Collective kinds that appear, in canonical order."""
        return tuple(k for k in KINDS if self.counts.get(k, 0) > 0)

    def for_scope(self, *substrings: str) -> Tuple[CommOp, ...]:
        """Collectives whose scope path contains ALL the substrings."""
        return tuple(op for op in self.sites
                     if all(sub in op.op_name for sub in substrings))

    def bytes_for_scope(self, *substrings: str) -> int:
        """Per-rank bytes of the collectives in a scope."""
        return sum(op.bytes for op in self.for_scope(*substrings))

    def bytes_by_dtype(self) -> Dict[str, int]:
        """Collective bytes split by element type: a quantized wire shows
        up as ``s8`` (int4 packs two values per s8 byte)."""
        per: Dict[str, int] = {}
        for op in self.sites:
            for dt, b in op.dtype_bytes:
                per[dt] = per.get(dt, 0) + b
        return per

    def dispatched_kinds(self) -> Tuple[str, ...]:
        """The kinds of the c10d ops dispatched, in :meth:`kinds`'s order
        (an op ``C10D_KINDS`` does not know keeps its own name, after
        them)."""
        seen = {C10D_KINDS.get(op, op) for op in self.dispatched}
        return tuple(k for k in KINDS if k in seen) + tuple(
            sorted(seen - set(KINDS)))

    def assert_no_collectives(self, what: str = "program") -> "CommReport":
        """The paper's central invariant, as one assert: nothing reported,
        and no c10d op dispatched."""
        assert self.total_count == 0 and not self.dispatched, (
            f"{what} is NOT communication-free: "
            f"{ {k: v for k, v in self.counts.items() if v} }, c10d ops "
            f"dispatched {self.dispatched}")
        return self

    def __str__(self) -> str:
        rows = [f"  {k:20s} count={self.counts[k]:4d} "
                f"bytes={self.bytes[k]}" for k in KINDS
                if self.counts.get(k, 0)]
        return ("CommReport(no collectives)" if not rows
                else "CommReport(\n" + "\n".join(rows) + "\n)")


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One point-to-point hop (a ``collective-permute``), overlap-scored:
    ``slack`` is the compute launches dispatched between its post and its
    wait."""

    op_name: str
    slack: int

    @property
    def concurrent(self) -> int:
        """The reference's in-flight count: the slack (eager PyTorch runs
        what it dispatched, in that order)."""
        return self.slack


@dataclasses.dataclass(frozen=True)
class OverlapReport:
    """Overlap scores of every hop of one run."""

    sites: Tuple[CollectiveSite, ...]

    def for_scope(self, *substrings: str) -> Tuple[CollectiveSite, ...]:
        return tuple(s for s in self.sites
                     if all(sub in s.op_name for sub in substrings))

    @property
    def n_collectives(self) -> int:
        return len(self.sites)

    @property
    def n_overlapped(self) -> int:
        """Hops with at least one compute launch in flight."""
        return sum(1 for s in self.sites if s.concurrent >= 1)

    def assert_overlapped(self, *scope: str, min_compute: int = 1,
                          what: str = "program") -> "OverlapReport":
        """Assert every hop in ``scope`` (all when empty) has at least
        ``min_compute`` compute launches between its post and its wait."""
        sites = self.for_scope(*scope) if scope else self.sites
        assert sites, (f"{what}: no collectives match scope {scope} — "
                       "nothing to assert overlap on")
        bad = [s for s in sites if s.concurrent < min_compute]
        assert not bad, (
            f"{what}: {len(bad)}/{len(sites)} collectives in scope {scope} "
            f"have < {min_compute} overlappable compute ops: "
            + ", ".join(f"{s.op_name}({s.concurrent})" for s in bad[:8]))
        return self

    def __str__(self) -> str:
        if not self.sites:
            return "OverlapReport(no collectives)"
        rows = [f"  collective-permute   {s.op_name:28s} "
                f"slack={s.slack:3d}" for s in self.sites]
        return "OverlapReport(\n" + "\n".join(rows) + "\n)"


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

class Ledger:
    """The collectives of one recording, in call order; ``compute`` counts
    compute launches while :func:`overlap_report` watches."""

    def __init__(self):
        self.ops: List[CommOp] = []
        self.hops: List[list] = []      # [op_name, compute at post, slack]
        self.compute = 0
        self.dispatched: Dict[str, int] = {}

    def report(self) -> CommReport:
        counts = dict.fromkeys(COLLECTIVES, 0)
        byts = dict.fromkeys(COLLECTIVES, 0)
        for op in self.ops:
            counts[op.kind] = counts.get(op.kind, 0) + 1
            byts[op.kind] = byts.get(op.kind, 0) + op.bytes
        return CommReport(counts=counts, bytes=byts, sites=tuple(self.ops),
                          dispatched=dict(self.dispatched))

    def overlap(self) -> OverlapReport:
        return OverlapReport(sites=tuple(
            CollectiveSite(op_name=name, slack=slack)
            for name, _, slack in self.hops))


class _Dispatched(TorchDispatchMode):
    """Counts into ``ledger`` each c10d op the dispatcher runs (one mode a
    recording: a nested recording's op passes through every enclosing
    mode, so each ledger counts it once)."""

    def __init__(self, ledger: Ledger):
        super().__init__()
        self.ledger = ledger

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in _C10D_NAMESPACES:
            seen = self.ledger.dispatched
            seen[func._opname] = seen.get(func._opname, 0) + 1
        return func(*args, **(kwargs or {}))


# the ledgers recording now (innermost last); a report goes to each
_LEDGERS: List[Ledger] = []
# the scope stack the records are attributed to
_SCOPE: List[str] = []


def _dtype_bytes(tensors: Sequence[torch.Tensor],
                 times: int = 1) -> Tuple[Tuple[str, int], ...]:
    per: Dict[str, int] = {}
    for t in tensors:
        name = dtype_name(t.dtype)
        per[name] = per.get(name, 0) + t.numel() * t.element_size() * times
    return tuple(sorted(per.items()))


def _add(kind: str, tensors: Sequence[torch.Tensor], times: int) -> None:
    split = _dtype_bytes(tensors, times)
    op = CommOp(kind=kind, op_name="/".join(_SCOPE),
                bytes=sum(b for _, b in split), dtype_bytes=split)
    for led in _LEDGERS:
        led.ops.append(op)


def record(kind: str, *tensors: torch.Tensor, times: int = 1) -> None:
    """Report one collective of ``kind`` whose per-rank result is
    ``tensors`` (``times`` copies of them: an all-gather's parts); a no-op
    unless a ledger is recording."""
    if not _LEDGERS:
        return
    _add(kind, tensors, times)


def record_hop(tensors: Sequence[torch.Tensor]) -> Optional[list]:
    """Report one point-to-point hop that sends ``tensors``; returns the
    handle :func:`hop_done` takes at the hop's wait (None unless a ledger
    is recording)."""
    if not _LEDGERS:
        return None
    _add("collective-permute", tensors, 1)
    led = _LEDGERS[-1]
    hop = ["/".join(_SCOPE), led.compute, 0]
    led.hops.append(hop)
    return hop


def hop_done(hop: Optional[list]) -> None:
    """The hop's wait: its slack is the compute launched since its post."""
    if hop is not None and _LEDGERS:
        hop[2] = _LEDGERS[-1].compute - hop[1]


def note_compute() -> None:
    """One compute launch (a GEMM or a kernel), for the overlap scores."""
    if _LEDGERS:
        _LEDGERS[-1].compute += 1


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullContext()


class _Scope:
    __slots__ = ("_path", "_saved")

    def __init__(self, path: Tuple[str, ...]):
        self._path = path

    def __enter__(self):
        self._saved = list(_SCOPE)
        _SCOPE[:] = self._path
        return self

    def __exit__(self, *exc) -> bool:
        _SCOPE[:] = self._saved
        return False


def scope(name: str):
    """Attribute the collectives inside to scope ``name`` (nested in the
    enclosing ones); a shared no-op unless a ledger is recording."""
    if not _LEDGERS:
        return _NULL
    return _Scope(tuple(_SCOPE) + (name,))


def current_scope() -> Optional[Tuple[str, ...]]:
    """The scope path now (for an autograd forward to hand its backward),
    None unless a ledger is recording."""
    return tuple(_SCOPE) if _LEDGERS else None


def restore(path: Optional[Tuple[str, ...]]):
    """Run an autograd backward under the scope path its forward saved
    (:func:`current_scope`), marked ``transpose`` as XLA marks a
    transposed op's name."""
    if path is None or not _LEDGERS:
        return _NULL
    return _Scope(("transpose",) + path)


class recording:
    """``with recording() as ledger:`` records every collective inside
    into ``ledger`` (and into any enclosing recording), and counts the
    c10d ops dispatched inside."""

    def __enter__(self) -> Ledger:
        self._ledger = Ledger()
        _LEDGERS.append(self._ledger)
        self._mode = _Dispatched(self._ledger)
        self._mode.__enter__()
        return self._ledger

    def __exit__(self, *exc) -> bool:
        try:
            self._mode.__exit__(*exc)
        finally:
            _LEDGERS.remove(self._ledger)
            if not _LEDGERS:
                _SCOPE.clear()
        return False


def comm_report(fn, *args, **kwargs) -> CommReport:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and account the
    collectives it issues on this rank. A CUDA graph replay makes no
    Python call: run the step itself, not a replay of it."""
    with recording() as led:
        fn(*args, **kwargs)
    return led.report()


def assert_no_collectives(fn, *args, what: str = "program",
                          **kwargs) -> CommReport:
    """Run ``fn`` and assert it issues ZERO collectives."""
    return comm_report(fn, *args, **kwargs).assert_no_collectives(what)


def overlap_report(fn, *args, **kwargs) -> OverlapReport:
    """Run ``fn`` once, eagerly, and score each point-to-point hop by the
    compute launches (GEMMs and the port's kernels) dispatched between its
    post and its wait."""
    from repro_torch.kernels import _observe

    gemms = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm}

    class _Compute(TorchDispatchMode, _observe.KernelObserver):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.depth == 0 and func.overloadpacket in gemms:
                note_compute()
            return func(*args, **(kwargs or {}))

        def kernel_done(self, name, cost, args, kwargs, out) -> None:
            note_compute()

    counter = _Compute()
    with recording() as led, counter, _observe.observing(counter):
        fn(*args, **kwargs)
    return led.overlap()
