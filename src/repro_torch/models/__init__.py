"""Transformer models (counterpart of ``repro/models``): the config
(``config``), the building blocks (``layers``), the MoE layer (``moe``)
and the dense and MoE decoders with their slot-indexed KV cache
(``transformer``)."""
