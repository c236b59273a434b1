"""Token data for the transformer training path (counterpart of
``repro/data``)."""
from repro_torch.data.pipeline import (TokenStream, make_lm_batches,
                                       shard_batch_for_mesh)

__all__ = ["TokenStream", "make_lm_batches", "shard_batch_for_mesh"]
