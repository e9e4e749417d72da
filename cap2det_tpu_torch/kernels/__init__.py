"""Wrappers of the port's hand-written CUDA kernels.

Each wrapper launches its kernel (``csrc/``) for a CUDA tensor, and raises
on anything the kernel does not take; it runs the kernel's plain PyTorch
version only for a CPU tensor. Each keeps a plain integer count of its
launches (``roi_pool.launches``, ``pool_grad.launches``,
``fused_optimizer.launches``, ``nms.launches``, ``bn_fold.launches``), so
a run can show that a path went through the kernel.
"""


def launch_counts():
    """{kernel: its wrapper's launches so far in this process}."""
    from cap2det_tpu_torch.kernels import (bn_fold, fused_optimizer, nms,
                                           pool_grad, roi_pool)

    return {"roi_crop_maxpool": roi_pool.launches,
            "pool_fwd": pool_grad.launches,
            "roi_crop_maxpool_grad": roi_pool.grad_launches,
            "maxpool_grad": pool_grad.maxpool_grad_launches,
            "avgpool_grad": pool_grad.avgpool_grad_launches,
            "fused_optimizer": fused_optimizer.launches,
            "nms": nms.launches,
            "bn_fold": bn_fold.launches,
            "bn_fold_grad": bn_fold.grad_launches}
