"""Communication-free uniform vertex sampling and induced-subgraph
extraction (ScaleGNN Alg. 1 and Alg. 2 phases 2-4) in PyTorch.

Counterpart of ``repro/core/sampling.py``. The sample is a pure function
of ``(seed, step or epoch, dp_index)``: :func:`step_key` /
:func:`epoch_key` mix those into one 64-bit key (splitmix64), and the
samplers draw from the key with counters: the permutation of ``n`` is the
argsort of ``fold_in(key, i)`` over ``i < n`` (``kernels/counter_rng.py``,
a CUDA kernel on the card). Where the step is a device tensor, the key is
derived on the device and the draw reads it there, so the host never
waits and a CUDA graph of the step draws each replay's own sample; the
bits are the same on the CPU and on the card. The port cannot reproduce
``jax.random.permutation``'s bits, so it is held to the reference's
properties instead: sorted distinct in-range ids, each vertex once per
epoch when ``batch | n``, epoch slice 0 equal to the step sampler.

Four modes, as in the reference: ``exact`` (Eq. 20,
``sort(perm(N)[:B])``), ``stratified`` (``b = B/g`` vertices per
contiguous range, with the range-dependent rescale constants of
:func:`rescale_constants`), and the locality modes: ``partition`` (q whole
contiguous clusters per range, after the graph's locality reordering;
:func:`sample_partition_epoch`) and ``walk`` (random walks over a
replicated in-range neighbor table; :func:`sample_walk_stratified`), whose
rescales are per pair of vertices (:func:`partition_col_scale`,
:func:`walk_col_scale`). Two schedules: per-step and per-epoch (without
replacement). Every DP group draws its own sample: its index is folded
into the key, except under partition + epoch with ``dp_groups > 1``,
where the groups share one cluster permutation and take disjoint slices.
Every draw of every mode is a counter draw from the key, so each is a pure
function of the key on the CPU and on the card alike.

Extraction (the port's ``"torch"`` backend, and what the fused CUDA kernel
of ``kernels/extract_gather.py`` is held against): phase 2 is the
prefix-sum vectorized CSR row gather, phase 3 the binary-search column
membership filter + compact remap, phase 4 the rescale/assembly into a
dense ``(b_r, b_c)`` block (:func:`extract_dense_block`) or straight into
block-ELL (:func:`extract_block_ell`, bit-identical to the reference for
the same ids); its rescale is a scalar, a per-column vector or, for the
locality modes, a per-pair matrix. Static shapes throughout: ``e_cap`` bounds the extracted
edges, as in the JAX version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import counter_rng as crng


class SampleConfig(NamedTuple):
    """Static sampling parameters. The locality fields default to "off":

    * ``clusters``  — partition mode: equal contiguous clusters PER VERTEX
      RANGE; a step samples ``clusters_per_step`` whole clusters per range
      instead of scattered vertices. 0 = off;
    * ``dp_groups`` — partition + epoch schedule only: DP groups sharing one
      (un-dp-folded) epoch cluster permutation and taking disjoint slices
      of it, so that together they cover every cluster once per epoch;
      the other modes fold the DP index into the key, so any number of DP
      groups runs with ``dp_groups = 1``;
    * ``walk_len``  — walk mode: random-walk steps per root; each root
      contributes its ``walk_len + 1`` visited vertices. 0 = off;
    * ``walk_k``    — the width of the replicated in-range neighbor table
      the walks traverse.
    """

    n_pad: int          # padded vertex count (multiple of g)
    g: int              # grid side; 1 for single-device
    batch: int          # total mini-batch size B (multiple of g)
    e_cap: int          # static bound on extracted nnz per block
    clusters: int = 0   # partition mode: clusters per vertex range (0 = off)
    dp_groups: int = 1  # partition+epoch: DP groups slicing one permutation
    walk_len: int = 0   # walk mode: steps per random walk (0 = off)
    walk_k: int = 0     # walk mode: neighbor-table width

    @property
    def n_local(self) -> int:
        return self.n_pad // self.g

    @property
    def b_local(self) -> int:
        return self.batch // self.g

    @property
    def cluster_size(self) -> int:
        """Vertices per cluster (partition mode)."""
        return self.n_local // self.clusters

    @property
    def clusters_per_step(self) -> int:
        """q: whole clusters sampled per range per step (partition mode)."""
        return self.b_local // self.cluster_size

    @property
    def walk_roots(self) -> int:
        """Roots per range per step (walk mode): each contributes its
        ``walk_len + 1`` visited vertices, filling the per-range batch."""
        return self.b_local // (self.walk_len + 1)

    @property
    def steps_per_epoch(self) -> int:
        """Full without-replacement slices one epoch permutation yields
        (``batch | n_pad`` covers every vertex exactly once per epoch; a
        remainder < batch is dropped). Under partition + ``dp_groups > 1``
        the groups take disjoint slices of one permutation, so an epoch is
        covered in ``1/dp_groups`` of the steps."""
        return self.n_pad // (self.batch * self.dp_groups)

    def validate(self) -> "SampleConfig":
        """Reject what would mis-sample instead of failing, each as the
        reference's assertion does: a batch larger than the vertex set
        (it under-fills the sample and biases the Eq. 23 rescale); a
        cluster count that does not tile the range, the batch or the DP
        slices (slices would overlap or skip clusters); DP-sliced
        permutations outside partition mode; a walk that does not tile the
        per-range batch, or an ``e_cap`` below it."""
        if self.batch > self.n_pad:
            raise ValueError(f"batch={self.batch} exceeds the vertex count "
                             f"n_pad={self.n_pad}")
        if self.b_local > self.n_local:
            raise ValueError(f"per-range batch {self.b_local} exceeds the "
                             f"range size {self.n_local}")
        if self.clusters:
            if self.n_local % self.clusters:
                raise ValueError(
                    f"clusters={self.clusters} does not divide the range "
                    f"size n_local={self.n_local}: clusters must be "
                    "equal-size contiguous spans")
            if self.b_local % self.cluster_size:
                raise ValueError(
                    f"per-range batch {self.b_local} is not a whole number "
                    f"of clusters (cluster_size={self.cluster_size}): "
                    "partition mode samples whole clusters")
            if self.clusters % (self.clusters_per_step * self.dp_groups):
                raise ValueError(
                    f"clusters={self.clusters} is not divisible by "
                    f"clusters_per_step*dp_groups="
                    f"{self.clusters_per_step * self.dp_groups}: the epoch "
                    "permutation would leave a partial slice")
        elif self.dp_groups != 1:
            raise ValueError(
                f"dp_groups={self.dp_groups} > 1 requires partition mode "
                "(clusters > 0): only the cluster permutation is sliced "
                "across DP groups; the other modes fold the DP index into "
                "the key")
        if self.walk_len:
            if self.clusters:
                raise ValueError("walk and partition modes are mutually "
                                 "exclusive: set clusters=0 for walk mode")
            if self.walk_k < 1:
                raise ValueError(f"walk mode needs a neighbor table "
                                 f"(walk_k={self.walk_k}); set walk_k >= 1")
            if self.walk_len + 1 > self.b_local:
                raise ValueError(
                    f"walk_len={self.walk_len}: one walk visits "
                    f"{self.walk_len + 1} vertices, more than the per-range "
                    f"batch {self.b_local}")
            if self.b_local % (self.walk_len + 1):
                raise ValueError(
                    f"walk_len={self.walk_len}: walks of "
                    f"{self.walk_len + 1} vertices do not tile the "
                    f"per-range batch {self.b_local}; pick walk_len + 1 "
                    "dividing batch // g")
            if self.e_cap < self.b_local:
                raise ValueError(
                    f"e_cap={self.e_cap} is below the per-range batch "
                    f"{self.b_local}: the walk's extraction would truncate "
                    "edges")
        return self


# ---------------------------------------------------------------------------
# Keys and vertex sampling (Eq. 20)
# ---------------------------------------------------------------------------

_MASK64 = crng.MASK64
Key = Union[int, torch.Tensor]


def _splitmix64(x: int) -> int:
    """One step of splitmix64: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: Key, data: Key) -> Key:
    """Fold an integer into a 64-bit key (the ``jax.random.fold_in`` of
    the port: fixed, so a key is the same on every host and device).
    Python ints give a Python int in [0, 2^64); where either is a tensor
    (a step counter on the device) the result is an int64 tensor holding
    the same bits, computed on the tensor's device without reading it."""
    if not isinstance(key, torch.Tensor) and \
            not isinstance(data, torch.Tensor):
        return _splitmix64(_splitmix64(int(key) & _MASK64)
                           ^ (int(data) & _MASK64))
    if isinstance(key, torch.Tensor):
        mixed = crng.splitmix64(key.long())
    else:
        mixed = crng.signed64(_splitmix64(int(key) & _MASK64))
    if isinstance(data, torch.Tensor):
        data = data.long()
    else:
        data = crng.signed64(data)
    return crng.splitmix64(data ^ mixed)


def step_key(seed: int, step: Key, dp_index: int = 0) -> Key:
    """The shared per-step key: (dp_group, step) folded into the seed. All
    devices of one DP group derive the same key, hence the same sample.
    The step is folded last, so a device counter costs one fold there."""
    return fold_in(fold_in(seed, dp_index), step)


def epoch_key(seed: int, epoch: Key, dp_index: int = 0) -> Key:
    """The shared per-epoch key: (dp_group, epoch) folded into the seed;
    one key -> one epoch permutation, sliced by the steps of the epoch."""
    return fold_in(fold_in(seed, dp_index), epoch)


def key_tensor(key: Key, device: Union[str, torch.device, None] = None
               ) -> torch.Tensor:
    """``key`` as the 0-d int64 tensor the draws read (a Python key is
    written on ``device`` by a fill, which a CUDA graph can capture)."""
    if isinstance(key, torch.Tensor):
        return key.long().reshape(())
    return torch.full((), crng.signed64(key), dtype=torch.int64,
                      device=device)


def _perm(key: torch.Tensor, n: int, rows: int = 1) -> torch.Tensor:
    """``rows`` permutations of ``n // rows`` each, int64 (rows, n // rows):
    row r orders ``r * n / rows + j`` by ``fold_in(key, .)``, a bijection,
    so the keys are distinct and the argsort exact."""
    return torch.argsort(crng.hash_keys(key, n).view(rows, n // rows), dim=1)


def _slice_sorted(perm: torch.Tensor, t: Key, b: int) -> torch.Tensor:
    """Sorted slice ``t`` of width ``b`` of each row of ``perm`` (the start
    clamped into range, as the reference's dynamic slice clamps it); ``t``
    may be a device tensor. A Python ``t`` is written on the device by a
    fill, which a CUDA graph can capture."""
    m = perm.shape[-1]
    if not isinstance(t, torch.Tensor):
        t = torch.full((), int(t), dtype=torch.int64, device=perm.device)
    start = torch.clamp(t.long() * b, 0, m - b)
    part = perm.index_select(-1, start + torch.arange(b, device=perm.device))
    return torch.sort(part, dim=-1).values


def sample_uniform_exact(key: torch.Tensor, n: int,
                         batch: int) -> torch.Tensor:
    """Paper Eq. 20: B distinct vertices uniformly, sorted ascending
    (int32, on the key's device)."""
    return sample_epoch_exact(key, n, batch, 0)


def sample_epoch_exact(key: torch.Tensor, n: int, batch: int,
                       t: Key) -> torch.Tensor:
    """Without-replacement epoch schedule, exact mode: step ``t`` of the
    epoch is slice ``t`` of the one permutation of the epoch key, sorted;
    slice 0 equals :func:`sample_uniform_exact` under the same key."""
    if batch > n:
        raise ValueError(f"batch={batch} > n={n}: perm[:batch] would return "
                         f"only {n} vertices and corrupt the Eq. 23 rescale")
    return _slice_sorted(_perm(key, n), t, batch)[0].to(torch.int32)


def sample_stratified(key: torch.Tensor,
                      cfg: SampleConfig) -> torch.Tensor:
    """b = B/g distinct vertices per contiguous range: (g, b) global ids,
    sorted within each range (one permutation per range)."""
    return sample_epoch_stratified(key, cfg, 0)


def _global(local: torch.Tensor, n_local: int) -> torch.Tensor:
    """(g, b) range-local ids -> int32 global ids (row i + i * n_local)."""
    base = torch.arange(local.shape[0], device=local.device)[:, None]
    return (local + base * n_local).to(torch.int32)


def sample_epoch_stratified(key: torch.Tensor, cfg: SampleConfig,
                            t: Key) -> torch.Tensor:
    """Without-replacement epoch schedule, stratified mode: one permutation
    per range, step ``t`` takes slice ``t`` of each; (g, b) global ids."""
    local = _slice_sorted(_perm(key, cfg.n_pad, cfg.g), t, cfg.b_local)
    return _global(local, cfg.n_local)


# ---------------------------------------------------------------------------
# Locality-aware sampling: partition (Cluster-GCN-style) and walk (SAINT)
# ---------------------------------------------------------------------------
#
# Both keep the paper's invariant: the sample is a pure function of (seed,
# epoch, step, dp_index), so every rank of a DP group derives the same
# (g, b) vertex set with no communication. Partition mode picks q whole
# contiguous clusters per range (after the locality reordering a cluster's
# neighborhood is concentrated, so e_cap tightens to q *
# max_cluster_block_nnz); walk mode grows the batch from random-walk roots
# over a replicated in-range neighbor table (its gathers read replicated
# tensors: no communication either).

def sample_partition_stratified(key: torch.Tensor,
                                cfg: SampleConfig) -> torch.Tensor:
    """Partition mode, per-step schedule: q = b / cluster_size whole
    clusters per range, the head of a per-range cluster permutation.
    Returns (g, b) global ids, sorted within each range."""
    return sample_partition_epoch(key, cfg, 0)


def sample_partition_epoch(key: torch.Tensor, cfg: SampleConfig, t: Key,
                           dp_slot: int = 0) -> torch.Tensor:
    """Partition mode, epoch schedule: one cluster permutation per range
    and (seed, epoch); step ``t`` of DP slot ``dp_slot`` takes slice ``t *
    dp_groups + dp_slot`` of q clusters, so the slots share the un-folded
    epoch key and jointly cover every cluster once per epoch, disjointly.
    Slice 0 is :func:`sample_partition_stratified`. The permutation is the
    argsort of the clusters' counter hashes, as the uniform sampler's is:
    the reference ranks clusters by O(C^2) pairwise compares only to keep
    XLA's partitioner from mis-sharding a sort, a problem PyTorch does not
    have. The chosen clusters, ascending, expand to their contiguous id
    spans, so the ids come out sorted."""
    q, cs = cfg.clusters_per_step, cfg.cluster_size
    if isinstance(t, torch.Tensor):
        slot = t.long() * cfg.dp_groups + dp_slot
    else:
        slot = int(t) * cfg.dp_groups + dp_slot
    chosen = _slice_sorted(_perm(key, cfg.g * cfg.clusters, cfg.g), slot, q)
    span = torch.arange(cs, device=chosen.device)
    local = (chosen[:, :, None] * cs + span).reshape(cfg.g, q * cs)
    return _global(local, cfg.n_local)


def partition_rescale_constants(cfg: SampleConfig) -> Tuple[float, float]:
    """(1/p_cross_cluster, 1/p_cross_range): the Eq. 23 pair inclusions of
    partition sampling. Within a chosen cluster both endpoints always
    co-occur (no rescale); across clusters of a range p = (q-1)/(C-1);
    across ranges p = q/C. At q = 1 cross-cluster pairs never co-occur
    (Cluster-GCN's regime) and the rescale is 0."""
    C, q = cfg.clusters, cfg.clusters_per_step
    inv_cc = (C - 1) / (q - 1) if q > 1 else 0.0
    return inv_cc, C / q


def partition_col_scale(ids_r: torch.Tensor, ids_c: torch.Tensor,
                        row_range: int, col_range: int, cfg: SampleConfig,
                        inv_cc: float, inv_cr: float) -> torch.Tensor:
    """The (b_r, b_c) float32 per-pair rescale of partition mode: 1 within
    a cluster, ``inv_cc`` across clusters of one range, ``inv_cr`` across
    ranges. ``ids_*`` are global ids; a cluster is positional (``local id
    // cluster_size``)."""
    shape = (ids_r.shape[0], ids_c.shape[0])
    if row_range != col_range:
        return torch.full(shape, inv_cr, dtype=torch.float32,
                          device=ids_r.device)
    cs = cfg.cluster_size
    cl_r = (ids_r.long() % cfg.n_local) // cs
    cl_c = (ids_c.long() % cfg.n_local) // cs
    one = torch.ones((), dtype=torch.float32, device=ids_r.device)
    return torch.where(cl_r[:, None] == cl_c[None, :], one,
                       torch.full((), inv_cc, dtype=torch.float32,
                                  device=ids_r.device))


def sample_walk_stratified(key: torch.Tensor, cfg: SampleConfig,
                           walk_nbr: torch.Tensor,
                           t: Optional[Key] = None) -> torch.Tensor:
    """Walk mode: per range, ``walk_roots`` roots (the head of a per-range
    permutation, or slice ``t`` of it under the epoch schedule) each walk
    ``walk_len`` steps over ``walk_nbr``, the replicated (n_pad, walk_k)
    table of in-range neighbor ids (``graphs.partition.build_walk_tables``).
    The roots come from ``fold_in(key, 0)``, the neighbor choice of step
    s from ``fold_in(key, 1 + s)`` (its counter hash mod ``walk_k``). The
    visited multiset is deduplicated to exactly ``b`` distinct ids with a
    random fill, as the reference does: visited ids score their first
    visit's position (< b; a ``scatter_reduce_`` "amin", deterministic on
    the card), unvisited ids n_local + their permutation rank, and the b
    smallest scores win (every score is distinct). Returns (g, b) global
    ids, sorted within each range."""
    g, n_loc, b = cfg.g, cfg.n_local, cfg.b_local
    n_roots = cfg.walk_roots
    dev = key.device
    perm = _perm(fold_in(key, 0), cfg.n_pad, g)           # (g, n_loc)
    if t is None:
        roots = perm[:, :n_roots]
    else:
        if not isinstance(t, torch.Tensor):
            t = torch.full((), int(t), dtype=torch.int64, device=dev)
        start = torch.clamp(t.long() * n_roots, 0, n_loc - n_roots)
        roots = perm.index_select(1, start + torch.arange(n_roots,
                                                          device=dev))
    base = torch.arange(g, device=dev)[:, None] * n_loc
    cur = roots + base                                    # global, (g, R)
    visited = [cur]
    for s in range(cfg.walk_len):
        choice = torch.remainder(crng.hash_keys(fold_in(key, 1 + s),
                                                g * n_roots),
                                 cfg.walk_k).view(g, n_roots)
        cur = walk_nbr[cur, choice].long()
        visited.append(cur)
    vis = torch.stack(visited, 1).reshape(g, b) - base    # local, visit order
    order = torch.arange(n_loc, device=dev).expand(g, n_loc)
    score = torch.empty_like(perm).scatter_(1, perm, order) + n_loc
    score.scatter_reduce_(1, vis, order[:, :b], reduce="amin")
    ids = torch.topk(score, b, dim=1, largest=False).indices
    return _global(torch.sort(ids, dim=1).values, n_loc)


def walk_col_scale(ids_r: torch.Tensor, ids_c: torch.Tensor,
                   p_incl: torch.Tensor) -> torch.Tensor:
    """The (b_r, b_c) SAINT edge rescale 1/q_uv, q_uv = p_u + p_v - p_u p_v
    (Zeng et al. 2019, Eq. 6), from ``p_incl``, the replicated (n_pad,)
    inclusion estimate ``min(1, b * p_tilde)``. Self-loops are exempted
    by the extraction's diagonal rule (Eq. 24)."""
    pr = p_incl[ids_r.long()][:, None]
    pc = p_incl[ids_c.long()][None, :]
    return 1.0 / torch.clamp(pr + pc - pr * pc, min=1e-6)


# ---------------------------------------------------------------------------
# Induced-subgraph extraction (Alg. 2 phases 2-4), vectorized, static shapes
# ---------------------------------------------------------------------------

def _extract_triples(rp, ci, val, rows_local, cols_local, e_cap):
    """Alg. 2 phases 2-3 (shared core): prefix-sum vectorized CSR row
    extraction + binary-search column membership filter.

    Returns (own, pos, member, v, col), each ``(e_cap,)``:
      own    — compact row index of each extracted slot
      pos    — compact column index (membership position)
      member — bool, slot is a real edge whose target is sampled
      v      — edge value
      col    — raw column id of each slot (local to the shard)
    """
    b_r = rows_local.shape[0]
    b_c = cols_local.shape[0]
    rows = rows_local.long()
    rp = rp.long()

    # Phase 2: per-row nnz -> prefix sum -> searchsorted back-map -> one
    # coalesced gather (paper Alg. 2 lines 6-10).
    r_cnt = rp[rows + 1] - rp[rows]
    pfx = torch.cumsum(r_cnt, 0)
    total = pfx[-1]
    slot = torch.arange(e_cap, dtype=torch.int64, device=rp.device)
    own = torch.searchsorted(pfx, slot, right=True)
    own = torch.clamp(own, 0, b_r - 1)
    row_start = pfx[own] - r_cnt[own]
    offset = slot - row_start
    src = rp[rows[own]] + offset
    valid = slot < total
    src = torch.where(valid, src, torch.zeros_like(src))
    col = ci[src]
    v = val[src]

    # Phase 3: membership + compact remap via one binary search
    # (paper Alg. 2 lines 11-14).
    pos = torch.searchsorted(cols_local, col.to(cols_local.dtype))
    pos = torch.clamp(pos, 0, b_c - 1)
    member = (cols_local[pos] == col) & valid
    return own, pos, member, v, col


def _edge_scale(rows_local, own, pos, col, rescale_offdiag, is_diag_block):
    """Phase-4 rescale factor per extracted slot (Eq. 24).

    ``rescale_offdiag`` is a scalar (one inclusion probability, Eq. 23),
    a (b_c,) per-column tensor (serving: requested at p=1, support at
    p_support) or a (b_r, b_c) per-pair matrix (partition mode's cluster
    constants, walk mode's SAINT 1/q_uv; indexed at ``[own, pos]``).
    ``is_diag_block`` marks that the row/column vertex sets coincide, so
    self-loops (local ids equal) stay unrescaled.
    """
    resc = torch.as_tensor(rescale_offdiag, dtype=torch.float32,
                           device=col.device)
    if resc.dim() == 2:
        offdiag = resc[own, pos]
    elif resc.dim() == 1:
        offdiag = resc[pos]
    else:
        offdiag = resc.expand(col.shape)
    diag = bool(is_diag_block) & (rows_local.long()[own] == col)
    return torch.where(diag, torch.ones_like(offdiag), offdiag)


def _scatter_sum(shape: Tuple[int, ...], index: Tuple[torch.Tensor, ...],
                 values: torch.Tensor, keep: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A zero ``dtype`` tensor of ``shape`` with ``values`` added at
    ``index`` over the slots where ``keep``, as one deterministic sorted
    accumulation (``index_put_`` with ``accumulate``) in float32, rounded
    once to ``dtype`` at the end. The slots not kept
    go to distinct spare cells past the end of the flat buffer instead of
    adding zeros to one clamped cell: on the card the accumulation
    serializes each run of one index, and tens of thousands of padding
    slots on one cell took milliseconds. The kept cells get the same
    sums."""
    n = 1
    for dim in shape:
        n *= dim
    lin = torch.zeros_like(index[0])
    for idx, dim in zip(index, shape):
        lin = lin * dim + idx
    spare = n + torch.arange(lin.shape[0], device=lin.device)
    flat = torch.zeros((n + lin.shape[0],), dtype=torch.float32,
                       device=lin.device)
    flat.index_put_((torch.where(keep, lin, spare),),
                    torch.where(keep, values, torch.zeros_like(values)).to(
                        torch.float32), accumulate=True)
    return flat[:n].view(shape).to(dtype)


def extract_dense_block(
    rp: torch.Tensor,            # (n_local + 1,) int32 local row pointer
    ci: torch.Tensor,            # (e_pad,) int32 local col ids
    val: torch.Tensor,           # (e_pad,) float32
    rows_local: torch.Tensor,    # (b_r,) sorted local sampled row ids
    cols_local: torch.Tensor,    # (b_c,) sorted local sampled col ids
    e_cap: int,
    *,
    rescale_offdiag: Union[torch.Tensor, float] = 1.0,
    is_diag_block: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Extract the dense (b_r, b_c) sampled block of a CSR shard, summed in
    float32 and rounded once to ``dtype``.

    ``e_cap`` must bound the total nnz of the sampled rows; entries beyond it
    are dropped (choose ``e_cap = b_r * max_row_nnz`` for exactness).
    Rescale semantics are in ``_edge_scale``.
    """
    b_r, b_c = rows_local.shape[0], cols_local.shape[0]
    if ci.shape[0] == 0:                     # empty graph shard
        return torch.zeros((b_r, b_c), dtype=dtype,
                           device=rows_local.device)
    own, pos, member, v, col = _extract_triples(
        rp, ci, val, rows_local, cols_local, e_cap)
    scale = _edge_scale(rows_local, own, pos, col, rescale_offdiag,
                        is_diag_block)
    return _scatter_sum((b_r, b_c), (own, pos), v * scale, member, dtype)


def stratified_col_scale(row_range: int, col_range: int, inv_same: float,
                         inv_cross: float) -> float:
    """The stratified rescale as a scalar column factor: within a vertex
    range 1/p_same, across ranges 1/p_cross."""
    return inv_same if row_range == col_range else inv_cross


def extract_dense_block_stratified(
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    rows_local: torch.Tensor, cols_local: torch.Tensor, e_cap: int, *,
    row_range: int, col_range: int, inv_same: float, inv_cross: float,
) -> torch.Tensor:
    """Stratified-sampling extraction: one pairwise constant per block;
    self-loops (possible only when ``row_range == col_range``) stay
    unrescaled (Eq. 24)."""
    return extract_dense_block(
        rp, ci, val, rows_local, cols_local, e_cap,
        rescale_offdiag=stratified_col_scale(row_range, col_range, inv_same,
                                             inv_cross),
        is_diag_block=row_range == col_range)


def rescale_constants(cfg: SampleConfig) -> Tuple[float, float]:
    """(1/p_same, 1/p_cross) for the stratified sampler; Eq. 23 at g = 1."""
    n_loc, b = cfg.n_local, cfg.b_local
    p_same = (b - 1) / (n_loc - 1) if n_loc > 1 else 1.0
    p_cross = b / n_loc
    inv_same = 1.0 / p_same if p_same > 0 else 0.0
    return inv_same, 1.0 / p_cross


def extract_block_ell(
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    rows_local: torch.Tensor, cols_local: torch.Tensor, e_cap: int, *,
    rescale_offdiag: Union[torch.Tensor, float] = 1.0,
    is_diag_block: bool = False,
    bm: int, bn: int, n_slots: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract the sampled block straight into the block-ELL format of
    ``kernels/spmm_ell.py``: each nonzero is routed to its (row-block,
    col-block) tile; the distinct tiles of a row-block are ranked by one
    sort + unique pass and scattered into ``n_slots`` slots — slot s holds
    the s-th smallest nonzero column-block; tiles past ``n_slots`` are
    dropped. Rescale semantics are in ``_edge_scale``.

    Returns (tiles (n_rb, n_slots, bm, bn), colidx (n_rb, n_slots) int32),
    bit-identical to the reference for the same ids."""
    b_r, b_c = rows_local.shape[0], cols_local.shape[0]
    if b_r % bm or b_c % bn:
        raise ValueError(f"a ({b_r}, {b_c}) block does not tile into "
                         f"({bm}, {bn})")
    n_rb, n_cb = b_r // bm, b_c // bn
    dev = rows_local.device
    colidx = torch.zeros((n_rb, n_slots), dtype=torch.int32, device=dev)
    if ci.shape[0] == 0:
        return (torch.zeros((n_rb, n_slots, bm, bn), dtype=dtype,
                            device=dev), colidx)

    own, pos, member, v, col = _extract_triples(
        rp, ci, val, rows_local, cols_local, e_cap)
    scale = _edge_scale(rows_local, own, pos, col, rescale_offdiag,
                        is_diag_block)
    contrib = torch.where(member, v * scale, torch.zeros_like(v))

    rb = own // bm
    cb = pos // bn
    # rank distinct (rb, cb) tiles: sort keys, count uniques, rank within rb
    big = n_rb * n_cb
    key = torch.where(member, rb * n_cb + cb, torch.full_like(rb, big))
    skey = torch.sort(key).values
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      skey[1:] != skey[:-1]]) & (skey < big)
    grank = torch.cumsum(uniq.long(), 0) - 1               # global tile rank
    # first global rank of each row-block = #uniques before its first key
    rb_first_pos = torch.searchsorted(
        skey, torch.arange(n_rb, device=dev) * n_cb)
    cum_uniq = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(uniq.long(), 0)])
    rb_first_rank = cum_uniq[rb_first_pos]
    entry_pos = torch.searchsorted(skey, key)
    entry_rank = grank[entry_pos.clamp(0, e_cap - 1)]
    slot = entry_rank - rb_first_rank[rb.clamp(0, n_rb - 1)]
    ok = member & (slot >= 0) & (slot < n_slots)
    slot_c = slot.clamp(0, n_slots - 1)

    tiles = _scatter_sum((n_rb, n_slots, bm, bn),
                         (rb, slot_c, own % bm, pos % bn), contrib, ok,
                         dtype)
    colidx.view(-1).scatter_reduce_(
        0, rb * n_slots + slot_c,
        torch.where(ok, cb, torch.zeros_like(cb)).to(torch.int32),
        reduce="amax")
    return tiles, colidx


def extract_block_ell_stratified(
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    rows_local: torch.Tensor, cols_local: torch.Tensor, e_cap: int, *,
    row_range: int, col_range: int, inv_same: float, inv_cross: float,
    bm: int, bn: int, n_slots: int, dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified-rescale variant of :func:`extract_block_ell`."""
    return extract_block_ell(
        rp, ci, val, rows_local, cols_local, e_cap,
        rescale_offdiag=stratified_col_scale(row_range, col_range, inv_same,
                                             inv_cross),
        is_diag_block=row_range == col_range,
        bm=bm, bn=bn, n_slots=n_slots, dtype=dtype)


# ---------------------------------------------------------------------------
# Single-device mini-batch (Alg. 1) — oracles and ablations
# ---------------------------------------------------------------------------

class MiniBatch(NamedTuple):
    adj: torch.Tensor         # (B, B) dense rescaled \tilde{A}_S
    feats: torch.Tensor       # (B, d_in)
    labels: torch.Tensor      # (B,)
    vertex_ids: torch.Tensor  # (B,) global ids (the sorted sample S)


def make_minibatch_exact(
    key: torch.Tensor,
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    features: torch.Tensor, labels: torch.Tensor,
    n: int, batch: int, e_cap: int,
) -> MiniBatch:
    """Paper Alg. 1 on one device: sample S, build the dense rescaled A_S,
    slice features/labels (Eq. 26)."""
    s = sample_uniform_exact(key, n, batch)
    inv_p = (n - 1) / (batch - 1)          # 1/p, Eq. 23
    adj = extract_dense_block(rp, ci, val, s, s, e_cap,
                              rescale_offdiag=inv_p, is_diag_block=True)
    return MiniBatch(adj=adj, feats=features[s.long()],
                     labels=labels[s.long()], vertex_ids=s)


def make_minibatch_stratified(
    key: Optional[torch.Tensor],
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    features: torch.Tensor, labels: torch.Tensor,
    cfg: SampleConfig, *, ids: Optional[torch.Tensor] = None,
) -> MiniBatch:
    """Single-device reference of the stratified sampler (g ranges, one
    device), assembled block by block so each block uses its pairwise
    constant. ``ids`` injects a (g, b) sample in place of drawing one from
    ``key``."""
    s2d = sample_stratified(key, cfg) if ids is None else ids
    s = s2d.reshape(-1)                                  # sorted globally
    inv_same, inv_cross = rescale_constants(cfg)
    rows_of = [torch.cat([extract_dense_block(
        rp, ci, val, s2d[i], s2d[j], cfg.e_cap,
        rescale_offdiag=inv_same if i == j else inv_cross,
        is_diag_block=i == j) for j in range(cfg.g)], dim=1)
        for i in range(cfg.g)]
    return MiniBatch(adj=torch.cat(rows_of, dim=0),
                     feats=features[s.long()], labels=labels[s.long()],
                     vertex_ids=s)
