"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: the fused Alg.-2 extraction (``extract_gather``) and the
fused layer tail (``fused_layer``). ``_build`` compiles them at first use."""
