"""Graph data substrate: CSR utilities, synthetic generators, the dataset
registry and the 2D block partitioner (numpy; copies of ``repro/graphs``)."""
from repro_torch.graphs.csr import (
    CSRMatrix,
    add_self_loops,
    coo_to_csr,
    csr_to_dense,
    csr_transpose,
    make_undirected,
    sym_normalize,
)
from repro_torch.graphs.datasets import DATASETS, DatasetMeta, get_dataset
from repro_torch.graphs.partition import (PartitionedGraph,
                                          build_partitioned_graph,
                                          partition_csr_2d)
from repro_torch.graphs.synthetic import (
    SyntheticDataset,
    make_rmat_graph,
    make_sbm_graph,
    make_synthetic_dataset,
)

__all__ = [
    "CSRMatrix", "coo_to_csr", "csr_to_dense", "add_self_loops",
    "sym_normalize", "csr_transpose", "make_undirected",
    "make_sbm_graph", "make_rmat_graph", "make_synthetic_dataset",
    "SyntheticDataset", "DATASETS", "DatasetMeta", "get_dataset",
    "PartitionedGraph", "build_partitioned_graph", "partition_csr_2d",
]
