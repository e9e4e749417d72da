"""Wrappers of the port's hand-written CUDA kernels.

Each wrapper launches its kernel (``csrc/``) for a CUDA tensor, and raises
on anything the kernel does not take; it runs the kernel's plain PyTorch
version only for a CPU tensor. Each keeps a plain integer count of its
launches (``roi_pool.launches``, ``pool_grad.launches``), so a run can
show that a path went through the kernel.
"""
