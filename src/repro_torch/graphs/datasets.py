"""Dataset registry: the paper's datasets and their synthetic stand-ins.

A copy of the registry half of ``repro/graphs/datasets.py``. The five paper
datasets are registered with their true metadata (vertex / edge counts,
feature dims, class counts — paper §VI-C); actual runs use synthetic
stand-ins at a configurable scale, built by the same numpy generator as the
JAX package, so both packages see the identical graph for the same
arguments.

``MmapShardedCSR`` is the paper-scale ingestion path, a copy of the
reference's: the g x g padded-CSR block partition lives as raw binary
files on disk, read through ``np.memmap``, so a graph never has to fit one
host's memory. ``write_mmap_shards`` streams a synthetic locality-clustered
graph to disk in two passes over block rows with a deterministic per-chunk
generator (pass 2 regenerates pass 1's edges instead of holding them):
only O(n) host vectors are ever in memory, never the O(E) edge stream.
The same seed writes the reference's files byte for byte. ``open()`` +
``to_partitioned_graph()`` give a ``PartitionedGraph`` whose block arrays
ARE the memmaps; bytes reach host memory when ``FourDPlan.shard_graph``
copies the rank's blocks to its device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.graphs.partition import PartitionedGraph
from repro_torch.graphs.synthetic import (SyntheticDataset,
                                          make_synthetic_dataset)


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    name: str
    num_vertices: int
    num_edges: int
    feature_dim: int
    num_classes: int
    kind: str                 # generator family used for the stand-in
    target_accuracy: Optional[float] = None  # paper's time-to-accuracy target
    note: str = ""


DATASETS: Dict[str, DatasetMeta] = {
    "ogbn-products": DatasetMeta(
        "ogbn-products", 2_449_029, 61_859_140, 100, 47, "sbm",
        target_accuracy=0.79,
        note="product co-purchase; paper end-to-end target 79%"),
    "reddit": DatasetMeta(
        "reddit", 232_965, 114_615_892, 602, 41, "sbm",
        target_accuracy=0.95,
        note="community classification; paper end-to-end target 95%"),
    "isolate-3-8m": DatasetMeta(
        "isolate-3-8m", 3_800_000, 68_000_000, 128, 32, "rmat",
        note="protein similarity subgraph; synthetic features in the paper too"),
    "products-14m": DatasetMeta(
        "products-14m", 14_000_000, 115_000_000, 128, 32, "rmat",
        note="Amazon product network; synthetic features in the paper too"),
    "ogbn-papers100M": DatasetMeta(
        "ogbn-papers100M", 111_059_956, 1_615_685_872, 128, 172, "sbm",
        note="citation network"),
}


def get_dataset(name: str, *, scale_vertices: Optional[int] = None,
                avg_degree: int = 16, seed: int = 0) -> SyntheticDataset:
    """Instantiate a synthetic stand-in for a registered dataset.

    ``scale_vertices`` overrides the vertex count; defaults to 8192.
    """
    meta = DATASETS[name]
    n = scale_vertices or 8192
    return make_synthetic_dataset(
        name=f"{meta.name}-synthetic-{n}",
        n=n,
        num_classes=min(meta.num_classes, 16),
        d_in=min(meta.feature_dim, 128),
        kind=meta.kind,
        avg_degree=avg_degree,
        seed=seed,
    )


# ---------------------------------------------------------------------------
# Memory-mapped shard ingestion
# ---------------------------------------------------------------------------

MMAP_SCHEMA = 1
_META = "meta.json"
# component files; shapes come from meta.json
_FILES = {
    "rp": ("rp.bin", np.int32),        # (g, g, n_local + 1)
    "ci": ("ci.bin", np.int32),        # (g, g, e_pad), local cols, pad n_loc
    "val": ("val.bin", np.float32),    # (g, g, e_pad)
    "feats": ("feats.bin", np.float32),   # (n_pad, d_in)
    "labels": ("labels.bin", np.int32),   # (n_pad,), ghosts -1
    "mask": ("mask.bin", np.bool_),       # (n_pad,), ghosts False
}


def _gen_chunk(seed: int, chunk_idx: int, r0: int, r1: int, *,
               n: int, n_local: int, cluster_size: int,
               avg_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """The DETERMINISTIC edge stream of global rows [r0, r1): returns
    (rows, cols) sorted by (row, col), self-loop included, columns
    deduplicated per row and clipped to real vertices. Both writer passes
    call this — pass 2 regenerates pass 1's edges bit-for-bit instead of
    holding the O(E) stream in memory.

    Columns are locality-biased: ~60% inside the row's cluster span, ~30%
    inside its vertex range, the rest uniform (with ``cluster_size == 0``
    the cluster share folds into the range) — so the shards are born with
    the positional cluster structure partition sampling keys on
    (cluster of id = local_id // cluster_size), no reordering pass needed.
    """
    rng = np.random.default_rng([seed, 7, chunk_idx])
    rows_n = r1 - r0
    deg = rng.poisson(avg_degree, rows_n).clip(0, 4 * avg_degree + 1)
    rows = np.repeat(np.arange(r0, r1, dtype=np.int64), deg)
    m = rows.shape[0]
    u = rng.random(m)
    range_lo = (rows // n_local) * n_local
    c_range = range_lo + rng.integers(0, n_local, m)
    c_unif = rng.integers(0, n, m)
    if cluster_size > 0:
        cluster_lo = range_lo + ((rows - range_lo) // cluster_size) \
            * cluster_size
        c_cluster = cluster_lo + rng.integers(0, cluster_size, m)
        cols = np.where(u < 0.6, c_cluster,
                        np.where(u < 0.9, c_range, c_unif))
    else:
        cols = np.where(u < 0.9, c_range, c_unif)
    cols = np.minimum(cols, n - 1)       # cluster/range spans may overhang
    keep = cols != rows                  # self-loops re-added uniformly below
    rows, cols = rows[keep], cols[keep]
    # dedup within row (np.unique sorts -> (row, col) order)
    key = rows * np.int64(n) + cols
    key = np.unique(key)
    rows, cols = key // n, key % n
    # one self-loop per row, then back to (row, col) order
    rows = np.concatenate([rows, np.arange(r0, r1, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(r0, r1, dtype=np.int64)])
    order = np.argsort(rows * np.int64(n) + cols, kind="stable")
    return rows[order], cols[order]


def write_mmap_shards(directory: str, *, n: int, g: int, d_in: int = 16,
                      num_classes: int = 16, avg_degree: int = 8,
                      clusters: int = 0, seed: int = 0,
                      chunk_rows: int = 1 << 16,
                      name: str = "mmap-synthetic") -> str:
    """Stream a papers100M-shaped synthetic graph to per-block shard files.

    Two passes over block rows, ``chunk_rows`` rows at a time:

    * pass 1 counts — per-(block, local row) nnz (the row pointers), the
      per-row total degree (for the symmetric normalization), and the
      static extraction bounds (``max_block_row_nnz``,
      ``max_cluster_block_nnz``);
    * pass 2 regenerates each chunk's edges (same per-chunk RNG) and
      writes the (ci, val) slots — per chunk and block the slot range is
      CONTIGUOUS (whole rows per chunk, rows ascending), so every write is
      one ``seek`` + one buffer, never a scattered memmap dirty-page pass.

    Memory: O(n) host vectors (row pointers, degrees) — the O(E) edge
    stream only ever exists ``chunk_rows`` rows at a time. Values carry
    the symmetric normalization ``1/sqrt(d_r * d_c)`` with the self-loop
    counted (out-degree based — the stand-in convention; real-dataset
    ingestion would stream true in-degrees the same way).
    """
    os.makedirs(directory, exist_ok=True)
    n_local = -(-n // g)
    if clusters > 0:
        n_local = -(-n_local // clusters) * clusters
    n_pad = n_local * g
    cs = n_local // clusters if clusters > 0 else 0

    # ---- pass 1: counts ---------------------------------------------------
    rp_counts = np.zeros((g, g, n_local), dtype=np.int64)
    deg_all = np.zeros(n, dtype=np.int32)
    chunks = [(c, lo, min(lo + chunk_rows, n))
              for c, lo in enumerate(range(0, n, chunk_rows))]
    for c, r0, r1 in chunks:
        rows, cols = _gen_chunk(seed, c, r0, r1, n=n, n_local=n_local,
                                cluster_size=cs, avg_degree=avg_degree)
        bi, bj = rows // n_local, cols // n_local
        lr = rows - bi * n_local
        np.add.at(rp_counts, (bi, bj, lr), 1)
        deg_all[r0:r1] = np.bincount(rows - r0, minlength=r1 - r0)

    block_nnz = rp_counts.sum(axis=2)
    e_pad = max(int(block_nnz.max(initial=0)), 1)
    max_row_nnz = int(rp_counts.max(initial=0))
    mx_cluster = 0
    if clusters > 0:
        mx_cluster = int(rp_counts.reshape(g, g, clusters, cs)
                         .sum(axis=3).max(initial=0))
    rp_full = np.zeros((g, g, n_local + 1), dtype=np.int64)
    np.cumsum(rp_counts, axis=2, out=rp_full[:, :, 1:])
    if rp_full.max(initial=0) >= 2**31:
        raise ValueError("a block's nnz overflows int32")
    rp_full = rp_full.astype(np.int32)
    del rp_counts

    # ---- create files (val/feats tails are holes -> zeros for free) ------
    paths = {k: os.path.join(directory, f) for k, (f, _) in _FILES.items()}
    with open(paths["rp"], "wb") as f:
        f.write(rp_full.tobytes())
    itemsize = 4
    for k, shape_bytes in (("ci", g * g * e_pad * itemsize),
                           ("val", g * g * e_pad * itemsize),
                           ("feats", n_pad * d_in * itemsize),
                           ("labels", n_pad * itemsize),
                           ("mask", n_pad)):
        with open(paths[k], "wb") as f:
            f.truncate(shape_bytes)

    # ci padding slots hold n_local (the extraction's "no vertex" id) —
    # they live in each block's [nnz, e_pad) tail; write them chunked
    pad_buf = np.full(min(e_pad, 1 << 20), n_local, dtype=np.int32)
    with open(paths["ci"], "r+b") as f:
        for i in range(g):
            for j in range(g):
                lo, hi = int(block_nnz[i, j]), e_pad
                base = (i * g + j) * e_pad
                while lo < hi:
                    span = min(hi - lo, pad_buf.shape[0])
                    f.seek((base + lo) * itemsize)
                    f.write(pad_buf[:span].tobytes())
                    lo += span
    # ghost labels are -1 (masked from the loss)
    with open(paths["labels"], "r+b") as f:
        f.seek(n * itemsize)
        ghost = np.full(n_pad - n, -1, dtype=np.int32)
        f.write(ghost.tobytes())

    # ---- pass 2: fill ci/val + feature/label stream -----------------------
    label_dirs = np.random.default_rng([seed, 11]).normal(
        size=(num_classes, d_in)).astype(np.float32)
    f_ci = open(paths["ci"], "r+b")
    f_val = open(paths["val"], "r+b")
    f_feat = open(paths["feats"], "r+b")
    f_lab = open(paths["labels"], "r+b")
    f_msk = open(paths["mask"], "r+b")
    try:
        for c, r0, r1 in chunks:
            rows, cols = _gen_chunk(seed, c, r0, r1, n=n, n_local=n_local,
                                    cluster_size=cs, avg_degree=avg_degree)
            bi, bj = rows // n_local, cols // n_local
            lr = rows - bi * n_local
            lc = (cols - bj * n_local).astype(np.int32)
            val = (1.0 / np.sqrt(deg_all[rows].astype(np.float64)
                                 * deg_all[cols])).astype(np.float32)
            # within-chunk: group by block; each group's slots are one
            # contiguous run (whole rows per chunk, (row, col)-sorted)
            bkey = bi * g + bj
            order = np.argsort(bkey, kind="stable")
            bkey_s = bkey[order]
            starts = np.searchsorted(bkey_s, np.arange(g * g))
            ends = np.searchsorted(bkey_s, np.arange(g * g), side="right")
            for fb in range(g * g):
                s, e = int(starts[fb]), int(ends[fb])
                if s == e:
                    continue
                i, j = fb // g, fb % g
                sel = order[s:e]
                pos0 = int(rp_full[i, j, lr[sel[0]]])
                base = (i * g + j) * e_pad
                f_ci.seek((base + pos0) * itemsize)
                f_ci.write(lc[sel].tobytes())
                f_val.seek((base + pos0) * itemsize)
                f_val.write(val[sel].tobytes())
            # features/labels/mask for these rows (deterministic per chunk)
            rng = np.random.default_rng([seed, 13, c])
            m = r1 - r0
            if clusters > 0:
                gcl = (np.arange(r0, r1) % n_local) // cs \
                    + (np.arange(r0, r1) // n_local) * clusters
                labels = (gcl % num_classes).astype(np.int32)
            else:
                labels = rng.integers(0, num_classes, m).astype(np.int32)
            flip = rng.random(m) < 0.1
            labels[flip] = rng.integers(0, num_classes, int(flip.sum()))
            feats = (rng.normal(size=(m, d_in)).astype(np.float32)
                     + label_dirs[labels])
            f_feat.seek(r0 * d_in * itemsize)
            f_feat.write(feats.tobytes())
            f_lab.seek(r0 * itemsize)
            f_lab.write(labels.tobytes())
            f_msk.seek(r0)
            f_msk.write(np.ones(m, dtype=np.bool_).tobytes())
    finally:
        for f in (f_ci, f_val, f_feat, f_lab, f_msk):
            f.close()

    meta = {
        "schema": MMAP_SCHEMA, "name": name, "n": n, "n_pad": n_pad,
        "g": g, "n_local": n_local, "e_pad": e_pad, "d_in": d_in,
        "num_classes": num_classes, "clusters": clusters,
        "max_block_row_nnz": max_row_nnz,
        "max_cluster_block_nnz": mx_cluster,
        "avg_degree": avg_degree, "seed": seed,
        "nnz": int(block_nnz.sum()),
    }
    # meta lands LAST: its presence marks a complete shard set
    tmp = os.path.join(directory, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    os.replace(tmp, os.path.join(directory, _META))
    return directory


@dataclasses.dataclass
class MmapShardedCSR:
    """A shard set opened read-only: every array is an ``np.memmap``, so
    RSS is bounded by the pages actually touched, not the graph size."""

    directory: str
    meta: Dict
    rp: np.memmap        # (g, g, n_local + 1) int32
    ci: np.memmap        # (g, g, e_pad) int32
    val: np.memmap       # (g, g, e_pad) float32
    feats: np.memmap     # (n_pad, d_in) float32
    labels: np.memmap    # (n_pad,) int32
    mask: np.memmap      # (n_pad,) bool

    @classmethod
    def open(cls, directory: str) -> "MmapShardedCSR":
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        if meta.get("schema") != MMAP_SCHEMA:
            raise ValueError(f"{directory}: unknown mmap shard schema "
                             f"{meta.get('schema')!r}")
        g, nl, ep = meta["g"], meta["n_local"], meta["e_pad"]
        np_, d = meta["n_pad"], meta["d_in"]
        shapes = {"rp": (g, g, nl + 1), "ci": (g, g, ep), "val": (g, g, ep),
                  "feats": (np_, d), "labels": (np_,), "mask": (np_,)}
        arrays = {}
        for k, (fname, dtype) in _FILES.items():
            arrays[k] = np.memmap(os.path.join(directory, fname), mode="r",
                                  dtype=dtype, shape=shapes[k])
        return cls(directory=directory, meta=meta, **arrays)

    def to_partitioned_graph(self) -> PartitionedGraph:
        """The ``PartitionedGraph`` view — block arrays ARE the memmaps
        (``np.memmap`` is an ``np.ndarray``), so ``build_plan`` consumes
        shards without materialization; bytes reach host memory only when
        a consumer touches them (``FourDPlan.shard_graph``'s copy of the
        rank's blocks to its device is that moment for training)."""
        m = self.meta
        return PartitionedGraph(
            n=m["n"], n_pad=m["n_pad"], g=m["g"], n_local=m["n_local"],
            e_pad=m["e_pad"], block_rp=self.rp, block_ci=self.ci,
            block_val=self.val, max_block_row_nnz=m["max_block_row_nnz"],
            features=self.feats, labels=self.labels, train_mask=self.mask,
            num_classes=m["num_classes"], clusters=m["clusters"],
            max_cluster_block_nnz=m["max_cluster_block_nnz"])
