"""The paper's own GCN configs (ScaleGNN §III / §VI-C).

``paper_model(dataset)`` returns the GCNConfig used by the accuracy and
scaling experiments; dataset-scale metadata comes from
``repro_torch.graphs.datasets``.
"""
from repro_torch.core.gcn_model import GCNConfig
from repro_torch.graphs.datasets import DATASETS


def paper_model(dataset: str = "ogbn-products", d_hidden: int = 256,
                num_layers: int = 3, dropout: float = 0.3) -> GCNConfig:
    meta = DATASETS[dataset]
    return GCNConfig(
        d_in=meta.feature_dim, d_hidden=d_hidden, num_layers=num_layers,
        num_classes=meta.num_classes, dropout=dropout,
    )


def smoke_model(num_classes: int = 8, d_in: int = 64) -> GCNConfig:
    return GCNConfig(d_in=d_in, d_hidden=64, num_layers=3,
                     num_classes=num_classes, dropout=0.1)
