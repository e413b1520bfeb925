"""PyTorch/CUDA port of octcubem_tpu for NVIDIA Hopper (sm_90a).

The layout mirrors the JAX package so that each module's counterpart is
found at the same path.  The port imports torch, numpy and the standard
library only; the attention kernels are hand-written CUDA under csrc/,
built with nvcc at first use (ops/_cuda.py).  Entry points run on the
card unless the caller passes ``device="cpu"`` (core/device.py).
"""
