"""Model and mini-batch core: the GCN (``gcn_model``), Alg.-1 sampling and
Alg.-2 extraction (``sampling``, ``minibatch``), the training options and
steps at g = 1 (``forward``, ``fourd``, ``pmm3d``) and the cache quantizers
(``precision``)."""
