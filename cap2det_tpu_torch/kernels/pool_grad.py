"""SAME-padded pool forward (port of ``cap2det_tpu/kernels/pool_grad.py``,
``pool_fwd``).

``pool_fwd`` launches ``csrc/pool.cu`` for CUDA tensors and runs the plain
version (``pool_same_plain``) for CPU tensors. The model uses it for every
second-stage pool. The backward kernels (max-pool and avg-pool gradients)
arrive with the training step.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cap2det_tpu_torch.kernels import build

KINDS = ("pool_max", "pool_avg")

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def same_pads(size, kernel, stride):
    """(out, pad_before, pad_after) of TF SAME padding along one axis."""
    out = -(-size // stride)
    pad_total = max((out - 1) * stride + kernel - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError("pool kind must be one of %s, got %r" % (KINDS, kind))


def pool_same_plain(x, kind, kernel, stride):
    """Plain SAME pool of [N, H, W, C]: explicit pad (-inf for max, 0 for
    avg) and shifted strided slices; avg sums in float32 and divides by
    the count of in-bounds taps. Returns x's dtype."""
    _check_kind(kind)
    _, h, w, _ = x.shape
    out_h, pad_t, pad_b = same_pads(h, kernel, stride)
    out_w, pad_l, pad_r = same_pads(w, kernel, stride)
    is_max = kind == "pool_max"
    xf = x if is_max else x.float()
    xp = F.pad(xf, (0, 0, pad_l, pad_r, pad_t, pad_b),
               value=-float("inf") if is_max else 0.0)

    def taps(t):
        acc = None
        for i in range(kernel):
            for j in range(kernel):
                view = t[:, i:i + (out_h - 1) * stride + 1:stride,
                         j:j + (out_w - 1) * stride + 1:stride, :]
                if acc is None:
                    acc = view
                elif is_max:
                    acc = torch.maximum(acc, view)
                else:
                    acc = acc + view
        return acc

    acc = taps(xp)
    if is_max:
        return acc
    ones = F.pad(torch.ones((1, h, w, 1), device=x.device),
                 (0, 0, pad_l, pad_r, pad_t, pad_b))
    return (acc / taps(ones)).to(x.dtype)


def _launch(x, kind, kernel, stride):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("pool_fwd: x must be float32 or bfloat16, got %s"
                        % x.dtype)
    if not x.is_contiguous():
        raise ValueError("pool_fwd: x must be a contiguous NHWC tensor")
    n, h, w, c = x.shape
    out_h, pad_t, _ = same_pads(h, kernel, stride)
    out_w, pad_l, _ = same_pads(w, kernel, stride)
    out = torch.empty((n, out_h, out_w, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("cap2det_pool_same_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), n, h, w, c, out_h, out_w, kernel,
            stride, pad_t, pad_l, int(kind == "pool_max"),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(rc, "pool_fwd")
    launches += 1
    return out


def pool_fwd(x, kind, kernel, stride):
    """SAME k x k / stride pool forward of x [N, H, W, C]; kind is
    "pool_max" or "pool_avg"."""
    _check_kind(kind)
    if x.dim() != 4 or kernel < 1 or stride < 1:
        raise ValueError("pool_fwd: [N,H,W,C] input and kernel, stride >= 1 "
                         "expected; got %s, %d, %d"
                         % (tuple(x.shape), kernel, stride))
    if x.is_cuda:
        return _launch(x, kind, kernel, stride)
    return pool_same_plain(x, kind, kernel, stride)
