"""Online GNN inference on one GPU: the model-agnostic serving core over
the GCN classification backend (counterpart of ``repro/serve``)::

    engine = InferenceEngine(params, cfg, dataset.adj_norm,
                             dataset.features, ServeOptions())
    logits = engine.predict([17, 42, 1001])
"""
from repro_torch.serve.assembler import (AssemblySpec, BatchPlan,
                                         ShardedBatchPlan, make_builder,
                                         make_spec, make_support_pool,
                                         make_support_pools, plan_batch,
                                         plan_batch_ranges)
from repro_torch.serve.batcher import MicroBatch, MicroBatcher, WorkItem
from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.core import ServingCore
from repro_torch.serve.engine import GNNBackend, InferenceEngine, ServeOptions
from repro_torch.serve.protocol import (Completion, EngineBackend,
                                        Overloaded)

__all__ = [
    "MicroBatch", "MicroBatcher", "WorkItem",
    "AssemblySpec", "BatchPlan", "ShardedBatchPlan", "make_builder",
    "make_spec", "make_support_pool", "make_support_pools", "plan_batch",
    "plan_batch_ranges",
    "EmbeddingCache", "Overloaded", "ServingCore", "Completion",
    "EngineBackend", "GNNBackend", "InferenceEngine", "ServeOptions",
]
