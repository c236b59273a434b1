"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: the fused Alg.-2 extraction (``extract_gather``), the
fused layer tail (``fused_layer``), the block-ELL SpMM (``spmm_ell``),
the flash-attention forward and backward (``flash_attention``) and the
training step's counter-based draws (``counter_rng``: the sampler's
permutation keys and the dropout keep-mask); ``ops`` gives the SpMM, the
tail and attention their autograd rules.
``_build`` compiles them at first use."""
