"""cap2det_tpu_torch: the PyTorch/CUDA port of cap2det_tpu.

Mirrors the layout and module names of ``cap2det_tpu/`` so each module's
counterpart is easy to find. It imports torch, numpy and the standard
library only; the JAX package is the reference it is tested against and
is never imported here.

Kernels written by hand for Hopper live in ``csrc/`` and are bound in
``kernels/``; each wrapper launches its CUDA kernel for a CUDA tensor and
runs the kernel's plain PyTorch version only for a CPU tensor.
"""
