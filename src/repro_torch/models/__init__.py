"""Transformer models (counterpart of ``repro/models``): the config
(``config``), the building blocks (``layers``) and the dense decoder with
its slot-indexed KV cache (``transformer``)."""
