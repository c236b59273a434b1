"""Online inference: the model-agnostic serving core over the GCN
classification backend (one GPU, or the 4D mesh) and the LLM backend, and
the threaded driver in front of either (counterpart of ``repro/serve``)::

    engine = InferenceEngine(params, cfg, dataset.adj_norm,
                             dataset.features, ServeOptions())
    logits = engine.predict([17, 42, 1001])

    llm = LLMEngine(model, cfg, LLMServeOptions(slots=8))
    tokens = llm.generate([[1, 17, 42]])

    with ServingDriver(engine) as drv:        # from any thread
        logits = drv.submit([17, 42]).result(timeout=5)
"""
from repro_torch.serve.assembler import (AssemblySpec, BatchPlan,
                                         ShardedBatchPlan, make_builder,
                                         make_spec, make_support_pool,
                                         make_support_pools, plan_batch,
                                         plan_batch_ranges)
from repro_torch.serve.batcher import (MicroBatch, MicroBatcher,
                                       RequestQueue, WorkItem)
from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.core import ServingCore
from repro_torch.serve.distributed import (DistributedServePlan,
                                           build_serve_plan, make_serve_mesh,
                                           partition_for_serving,
                                           serve_worker)
from repro_torch.serve.driver import ServingDriver
from repro_torch.serve.engine import GNNBackend, InferenceEngine, ServeOptions
from repro_torch.serve.llm_engine import LLMBackend, LLMEngine, LLMServeOptions
from repro_torch.serve.protocol import (Completion, EngineBackend,
                                        Overloaded)

__all__ = [
    "MicroBatch", "MicroBatcher", "RequestQueue", "WorkItem",
    "AssemblySpec", "BatchPlan", "ShardedBatchPlan", "make_builder",
    "make_spec", "make_support_pool", "make_support_pools", "plan_batch",
    "plan_batch_ranges",
    "EmbeddingCache", "Overloaded", "ServingCore", "Completion",
    "EngineBackend", "GNNBackend", "InferenceEngine", "ServeOptions",
    "LLMBackend", "LLMEngine", "LLMServeOptions", "ServingDriver",
    "DistributedServePlan", "build_serve_plan", "make_serve_mesh",
    "partition_for_serving", "serve_worker",
]
