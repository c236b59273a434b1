"""Communication-free uniform vertex sampling and induced-subgraph
extraction (ScaleGNN Alg. 1 and Alg. 2 phases 2-4) in PyTorch.

Counterpart of ``repro/core/sampling.py``. The sample is a pure function
of ``(seed, step or epoch, dp_index)``: :func:`step_key` /
:func:`epoch_key` mix those into one 64-bit key (splitmix64), and the key
seeds a ``torch.Generator`` on the sampling device (:func:`make_generator`)
that the samplers draw their ``torch.randperm`` from. The port cannot
reproduce ``jax.random.permutation``'s bits, so it is held to the
reference's properties instead: sorted distinct in-range ids, each vertex
once per epoch when ``batch | n``, epoch slice 0 equal to the step sampler.

Two modes, as in the reference: ``exact`` (Eq. 20, ``sort(perm(N)[:B])``)
and ``stratified`` (``b = B/g`` vertices per contiguous range, with the
range-dependent rescale constants of :func:`rescale_constants`); two
schedules: per-step and per-epoch (without replacement). Every DP group
draws its own sample: its index is folded into the key. The locality
modes (partition, walk) are ROADMAP queue 1, "Locality sampling modes and
ingestion": their ``SampleConfig`` fields must stay 0.

Extraction (the port's ``"torch"`` backend, and what the fused CUDA kernel
of ``kernels/extract_gather.py`` is held against): phase 2 is the
prefix-sum vectorized CSR row gather, phase 3 the binary-search column
membership filter + compact remap, phase 4 the rescale/assembly into a
dense ``(b_r, b_c)`` block (:func:`extract_dense_block`) or straight into
block-ELL (:func:`extract_block_ell`, bit-identical to the reference for
the same ids). Static shapes throughout: ``e_cap`` bounds the extracted
edges, as in the JAX version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

_LOCALITY = 'ROADMAP queue 1, "Locality sampling modes and ingestion"'


class SampleConfig(NamedTuple):
    """Static sampling parameters. The locality-aware fields (``clusters``,
    ``dp_groups``, ``walk_len``, ``walk_k``) are kept for the reference's
    layout and must stay at their defaults until their modes are ported:
    ``dp_groups > 1`` slices one cluster permutation across the DP groups
    (partition mode and the epoch schedule only); the other modes fold the
    DP index into the key, so any number of DP groups runs with
    ``dp_groups = 1``."""

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
    def steps_per_epoch(self) -> int:
        """Full without-replacement slices one epoch permutation yields
        (``batch | n_pad`` covers every vertex exactly once per epoch; a
        remainder < batch is dropped)."""
        return self.n_pad // (self.batch * self.dp_groups)

    def validate(self) -> "SampleConfig":
        """Reject a batch larger than the vertex set (it would under-fill
        the sample and bias the Eq. 23 rescale), DP-sliced permutations
        outside partition mode (as the reference does), and the locality
        modes, which are not ported yet."""
        if self.clusters or self.walk_len or self.walk_k:
            raise NotImplementedError(
                f"clusters={self.clusters}, walk_len={self.walk_len}, "
                f"walk_k={self.walk_k}: the partition and walk sampling "
                f"modes are {_LOCALITY}")
        if self.dp_groups != 1:
            raise ValueError(
                f"dp_groups={self.dp_groups} > 1 requires partition mode "
                "(clusters > 0): only the cluster permutation is sliced "
                "across DP groups; the other modes fold the DP index into "
                "the key")
        if self.batch > self.n_pad:
            raise ValueError(f"batch={self.batch} exceeds the vertex count "
                             f"n_pad={self.n_pad}")
        if self.b_local > self.n_local:
            raise ValueError(f"per-range batch {self.b_local} exceeds the "
                             f"range size {self.n_local}")
        return self


# ---------------------------------------------------------------------------
# Keys and vertex sampling (Eq. 20)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One step of splitmix64: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """Fold an integer into a 64-bit key (the ``jax.random.fold_in`` of
    the port: fixed, so a key is the same on every host and device)."""
    return _splitmix64(_splitmix64(int(key) & _MASK64)
                       ^ (int(data) & _MASK64))


def step_key(seed: int, step: int, dp_index: int = 0) -> int:
    """The shared per-step key: (step, dp_group) folded into the seed. All
    devices of one DP group derive the same key, hence the same sample."""
    return fold_in(fold_in(seed, step), dp_index)


def epoch_key(seed: int, epoch: int, dp_index: int = 0) -> int:
    """The shared per-epoch key: (epoch, dp_group) folded into the seed; one
    key -> one epoch permutation, sliced by the steps of the epoch."""
    return fold_in(fold_in(seed, epoch), dp_index)


def make_generator(key: int, device: Union[str, torch.device]
                   ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return gen


def _perm(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randperm(n, generator=gen, device=gen.device,
                          dtype=torch.int32)


def _slice_sorted(perm: torch.Tensor, t: int, b: int) -> torch.Tensor:
    """Sorted slice ``t`` of width ``b`` (the start clamped into range, as
    the reference's dynamic slice clamps it)."""
    start = min(max(int(t) * b, 0), perm.shape[0] - b)
    return torch.sort(perm[start:start + b]).values


def sample_uniform_exact(gen: torch.Generator, n: int,
                         batch: int) -> torch.Tensor:
    """Paper Eq. 20: B distinct vertices uniformly, sorted ascending
    (int32, on the generator's device)."""
    if batch > n:
        raise ValueError(f"batch={batch} > n={n}: perm[:batch] would return "
                         f"only {n} vertices and corrupt the Eq. 23 rescale")
    return _slice_sorted(_perm(gen, n), 0, batch)


def sample_epoch_exact(gen: torch.Generator, n: int, batch: int,
                       t: int) -> torch.Tensor:
    """Without-replacement epoch schedule, exact mode: step ``t`` of the
    epoch is slice ``t`` of the one permutation drawn from the epoch
    generator, sorted; slice 0 equals :func:`sample_uniform_exact` under
    the same seed."""
    if batch > n:
        raise ValueError(f"batch={batch} > n={n}")
    return _slice_sorted(_perm(gen, n), t, batch)


def sample_stratified(gen: torch.Generator,
                      cfg: SampleConfig) -> torch.Tensor:
    """b = B/g distinct vertices per contiguous range: (g, b) global ids,
    sorted within each range (one permutation per range, drawn in range
    order from ``gen``)."""
    n_loc, b = cfg.n_local, cfg.b_local
    return torch.stack([_slice_sorted(_perm(gen, n_loc), 0, b) + i * n_loc
                        for i in range(cfg.g)])


def sample_epoch_stratified(gen: torch.Generator, cfg: SampleConfig,
                            t: int) -> torch.Tensor:
    """Without-replacement epoch schedule, stratified mode: one permutation
    per range, step ``t`` takes slice ``t`` of each; (g, b) global ids."""
    n_loc, b = cfg.n_local, cfg.b_local
    return torch.stack([_slice_sorted(_perm(gen, n_loc), t, b) + i * n_loc
                        for i in range(cfg.g)])


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

    ``rescale_offdiag`` is a scalar (one inclusion probability, Eq. 23) or
    a (b_c,) per-column tensor (serving: requested at p=1, support at
    p_support). ``is_diag_block`` marks that the row/column vertex sets
    coincide, so self-loops (local ids equal) stay unrescaled.
    """
    resc = torch.as_tensor(rescale_offdiag, dtype=torch.float32,
                           device=col.device)
    offdiag = resc[pos] if resc.dim() == 1 else resc.expand(col.shape)
    diag = bool(is_diag_block) & (rows_local.long()[own] == col)
    return torch.where(diag, torch.ones_like(offdiag), offdiag)


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
) -> torch.Tensor:
    """Extract the dense (b_r, b_c) float32 sampled block of a CSR shard.

    ``e_cap`` must bound the total nnz of the sampled rows; entries beyond it
    are dropped (choose ``e_cap = b_r * max_row_nnz`` for exactness).
    Rescale semantics are in ``_edge_scale``.
    """
    b_r, b_c = rows_local.shape[0], cols_local.shape[0]
    out = torch.zeros((b_r, b_c), dtype=torch.float32,
                      device=rows_local.device)
    if ci.shape[0] == 0:                     # empty graph shard
        return out
    own, pos, member, v, col = _extract_triples(
        rp, ci, val, rows_local, cols_local, e_cap)
    scale = _edge_scale(rows_local, own, pos, col, rescale_offdiag,
                        is_diag_block)
    contrib = torch.where(member, v * scale, torch.zeros_like(v))
    return out.index_put_((own, pos), contrib, accumulate=True)


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
    tiles = torch.zeros((n_rb, n_slots, bm, bn), dtype=dtype, device=dev)
    colidx = torch.zeros((n_rb, n_slots), dtype=torch.int32, device=dev)
    if ci.shape[0] == 0:
        return tiles, colidx

    own, pos, member, v, col = _extract_triples(
        rp, ci, val, rows_local, cols_local, e_cap)
    scale = _edge_scale(rows_local, own, pos, col, rescale_offdiag,
                        is_diag_block)
    contrib = torch.where(member, v * scale, torch.zeros_like(v)).to(dtype)

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

    tiles.index_put_((rb, slot_c, own % bm, pos % bn),
                     torch.where(ok, contrib, torch.zeros_like(contrib)),
                     accumulate=True)
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
    gen: torch.Generator,
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    features: torch.Tensor, labels: torch.Tensor,
    n: int, batch: int, e_cap: int,
) -> MiniBatch:
    """Paper Alg. 1 on one device: sample S, build the dense rescaled A_S,
    slice features/labels (Eq. 26)."""
    s = sample_uniform_exact(gen, n, batch)
    inv_p = (n - 1) / (batch - 1)          # 1/p, Eq. 23
    adj = extract_dense_block(rp, ci, val, s, s, e_cap,
                              rescale_offdiag=inv_p, is_diag_block=True)
    return MiniBatch(adj=adj, feats=features[s.long()],
                     labels=labels[s.long()], vertex_ids=s)


def make_minibatch_stratified(
    gen: Optional[torch.Generator],
    rp: torch.Tensor, ci: torch.Tensor, val: torch.Tensor,
    features: torch.Tensor, labels: torch.Tensor,
    cfg: SampleConfig, *, ids: Optional[torch.Tensor] = None,
) -> MiniBatch:
    """Single-device reference of the stratified sampler (g ranges, one
    device), assembled block by block so each block uses its pairwise
    constant. ``ids`` injects a (g, b) sample in place of drawing one from
    ``gen``."""
    s2d = sample_stratified(gen, cfg) if ids is None else ids
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
