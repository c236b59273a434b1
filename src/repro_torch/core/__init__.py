"""Model and mini-batch core: the GCN (``gcn_model``), Alg.-2 extraction
(``sampling``, ``minibatch``) and the cache quantizers (``precision``)."""
