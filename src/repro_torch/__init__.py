"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors the JAX package (``graphs/``, ``configs/``, ``core/``,
``kernels/``, ``obs/``, ``serve/``); each module names its JAX counterpart.
The port imports nothing of ``repro`` and nothing of ``jax``. The TPU
kernels become hand-written CUDA kernels for ``sm_90a`` under
``kernels/csrc/``, built with ``nvcc`` at first use; each sits beside a
plain PyTorch version that CPU tensors go through.
"""
