"""Dataset registry: the paper's datasets and their synthetic stand-ins.

A copy of the registry half of ``repro/graphs/datasets.py``. The five paper
datasets are registered with their true metadata (vertex / edge counts,
feature dims, class counts — paper §VI-C); actual runs use synthetic
stand-ins at a configurable scale, built by the same numpy generator as the
JAX package, so both packages see the identical graph for the same
arguments. The memory-mapped shard ingestion is still to be ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
