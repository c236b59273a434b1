"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: the fused Alg.-2 extraction (``extract_gather``), the
fused layer tail (``fused_layer``) and the block-ELL SpMM (``spmm_ell``);
``ops`` gives the last two their autograd rules. ``_build`` compiles them
at first use."""
