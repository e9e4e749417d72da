"""SAME-padded pool forward and backward (port of
``cap2det_tpu/kernels/pool_grad.py``: ``pool_fwd``, ``maxpool_grad``,
``avgpool_grad``).

Each function launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors: ``pool_fwd`` (K4, ``csrc/pool.cu``),
``maxpool_grad`` (K5) and ``avgpool_grad`` (K6, both ``csrc/pool_grad.cu``).
``pool_same`` is the differentiable pool the model uses for every
second-stage pool (``pool_dense``, plain PyTorch, pools the first stage's
large maps): a ``torch.autograd.Function`` whose forward is K4 and
whose backward is K5 or K6. Max-pool gradients route first-tie, as TF
MaxPoolGrad and the Pallas kernels do: the whole gradient of a window goes
to its first maximal tap in row-major order. K5 and K6 each have a tiled
kernel (a block per ROI and channel tile, the windows' work once in shared
memory) and an untiled one for maps too large to tile; ``_tiled`` picks
one on the host.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.utils.spans import span

KINDS = ("pool_max", "pool_avg")

# The tiled kernels' limits (csrc/pool_common.cuh, csrc/pool_grad.cu):
# shared memory a block may take, lanes per channel tile (16-byte lanes on
# the vector path, one channel each on the scalar path), and the largest
# max-pool kernel whose tap index fits a byte.
SMEM_BUDGET = 48 * 1024
VEC_LANES = 8
SCALAR_LANES = 32
MAX_TILED_MAX_KERNEL = 16

# Launch counts of K4 (pool_fwd), K5 (maxpool_grad) and K6 (avgpool_grad),
# and of K5 and K6 by kernel.
launches = 0
maxpool_grad_launches = 0
avgpool_grad_launches = 0
maxpool_grad_tiled_launches = 0
maxpool_grad_untiled_launches = 0
avgpool_grad_tiled_launches = 0
avgpool_grad_untiled_launches = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_GRAD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                  + [ctypes.c_void_p])


def same_pads(size, kernel, stride):
    """(out, pad_before, pad_after) of TF SAME padding along one axis."""
    out = -(-size // stride)
    pad_total = max((out - 1) * stride + kernel - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def pool_dense(x, kind, kernel, stride):
    """SAME pool of a large NCHW map (a first stage's): the explicit
    -inf-padded max-pool, or the in-bounds-count avg-pool, in plain
    PyTorch. Every avg pool the backbones run is 3x3/s1, whose SAME
    padding is symmetric."""
    _, pt, pb = same_pads(x.shape[2], kernel, stride)
    _, pl, pr = same_pads(x.shape[3], kernel, stride)
    if kind == "pool_max":
        x = F.pad(x, (pl, pr, pt, pb), value=-float("inf"))
        return F.max_pool2d(x, kernel, stride)
    if pt != pb or pl != pr:
        raise ValueError("asymmetric SAME avg-pool padding (kernel %d, "
                         "stride %d) is not supported" % (kernel, stride))
    return F.avg_pool2d(x, kernel, stride, padding=(pt, pl),
                        count_include_pad=False)


def in_bounds_taps(h, w, kernel, stride):
    """In-bounds taps summed over the windows of a SAME pool of one
    H x W map (a window at the border reads fewer than kernel^2)."""
    taps = 1
    for size in (h, w):
        out, pad_lo, _ = same_pads(size, kernel, stride)
        taps *= sum(min(o * stride - pad_lo + kernel, size)
                    - max(o * stride - pad_lo, 0) for o in range(out))
    return taps


def pool_fwd_flops(shape, kind, kernel, stride):
    """Floating-point operations of the function K4 computes on x of
    `shape` [N, H, W, C]: one max or add per in-bounds tap of every
    window and channel, and for the avg-pool one divide per output:

        N * C * (taps + (OH * OW if avg)).
    """
    n, h, w, c = shape
    out_h, out_w, _ = _geometry(h, w, kernel, stride)
    divides = out_h * out_w if kind == "pool_avg" else 0
    return n * c * (in_bounds_taps(h, w, kernel, stride) + divides)


def maxpool_grad_flops(shape, kernel, stride):
    """Floating-point operations of K5's function for x of `shape`: one
    compare per in-bounds tap to find each window's first maximum, and
    one add of the window's gradient into dx: N * C * (taps + OH * OW)."""
    n, h, w, c = shape
    out_h, out_w, _ = _geometry(h, w, kernel, stride)
    return n * c * (in_bounds_taps(h, w, kernel, stride) + out_h * out_w)


def avgpool_grad_flops(shape, kernel, stride):
    """Floating-point operations of K6's function for x of `shape`: one
    divide of each window's gradient by its count, and one add into dx
    per in-bounds tap: N * C * (OH * OW + taps)."""
    return maxpool_grad_flops(shape, kernel, stride)


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError("pool kind must be one of %s, got %r" % (KINDS, kind))


def _geometry(h, w, kernel, stride):
    out_h, pad_t, pad_b = same_pads(h, kernel, stride)
    out_w, pad_l, pad_r = same_pads(w, kernel, stride)
    return out_h, out_w, (0, 0, pad_l, pad_r, pad_t, pad_b)


def _tap_slices(kernel, stride, out_h, out_w):
    """(ky, kx) in row-major order -> the [N, out_h, out_w, C] strided
    slice of a padded map that tap covers."""
    return [
        (slice(None), slice(i, i + (out_h - 1) * stride + 1, stride),
         slice(j, j + (out_w - 1) * stride + 1, stride))
        for i in range(kernel) for j in range(kernel)
    ]


def _counts(h, w, kernel, stride, device):
    """[1, out_h, out_w, 1] float32 count of in-bounds taps per window."""
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    ones = F.pad(torch.ones((1, h, w, 1), device=device), pads)
    return sum(ones[t] for t in _tap_slices(kernel, stride, out_h, out_w))


def pool_same_plain(x, kind, kernel, stride):
    """Plain SAME pool of [N, H, W, C]: explicit pad (-inf for max, 0 for
    avg) and shifted strided slices; avg sums in float32 and divides by
    the count of in-bounds taps. Returns x's dtype."""
    _check_kind(kind)
    _, h, w, _ = x.shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    taps = _tap_slices(kernel, stride, out_h, out_w)
    if kind == "pool_max":
        xp = F.pad(x, pads, value=-float("inf"))
        acc = xp[taps[0]]
        for t in taps[1:]:
            acc = torch.maximum(acc, xp[t])
        return acc
    xp = F.pad(x.float(), pads)
    acc = sum(xp[t] for t in taps)
    return (acc / _counts(h, w, kernel, stride, x.device)).to(x.dtype)


def maxpool_grad_plain(x, g, kernel, stride):
    """Plain first-tie SAME max-pool backward (the taken-mask scan of the
    JAX package's ``_routed_taps``): each window's gradient goes to the
    first tap, in row-major order, that equals the window's maximum;
    accumulated tap by tap in float32, returned in x's dtype."""
    _, h, w, _ = x.shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    taps = _tap_slices(kernel, stride, out_h, out_w)
    xp = F.pad(x.float(), pads, value=-float("inf"))
    views = [xp[t] for t in taps]
    out = views[0]
    for v in views[1:]:
        out = torch.maximum(out, v)
    gf = g.float()
    taken = torch.zeros(out.shape, dtype=torch.bool, device=x.device)
    acc = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for t, view in zip(taps, views):
        hit = (view >= out) & ~taken
        taken |= hit
        acc[t] += gf * hit
    _, _, pad_l, _, pad_t, _ = pads
    return acc[:, pad_t:pad_t + h, pad_l:pad_l + w].to(x.dtype)


def avgpool_grad_plain(x_shape, dtype, g, kernel, stride):
    """Plain SAME avg-pool backward: g / count spread over each window's
    taps, tap by tap in float32, returned in `dtype`. Needs only x's
    shape."""
    n, h, w, c = x_shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    gt = g.float() / _counts(h, w, kernel, stride, g.device)
    _, _, pad_l, pad_r, pad_t, pad_b = pads
    acc = torch.zeros((n, h + pad_t + pad_b, w + pad_l + pad_r, c),
                      dtype=torch.float32, device=g.device)
    for t in _tap_slices(kernel, stride, out_h, out_w):
        acc[t] += gt
    return acc[:, pad_t:pad_t + h, pad_l:pad_l + w].to(dtype)


def _tiling(channels, dtype, aligned=True):
    """(vector, channels per tile) of a launch, as `tiling_for` in
    csrc/pool_common.cuh: 16-byte lanes when a row of C channels is a
    multiple of 16 bytes and every pointer is 16-byte aligned, else one
    channel per lane."""
    vector = aligned and (channels * dtype.itemsize) % 16 == 0
    return vector, (16 // dtype.itemsize * VEC_LANES if vector
                    else SCALAR_LANES)


def _tiled(shape, dtype, kernel, stride, kind, aligned=True):
    """Which kernel K5 (kind "pool_max") or K6 ("pool_avg") launches for x
    of `shape`: the tiled one when its shared memory fits SMEM_BUDGET (max:
    the x and g tiles and a winner byte per window and channel; avg: g /
    count per window and channel in float32), a max kernel is at most
    MAX_TILED_MAX_KERNEL and the indices fit 32 bits; else the untiled
    one. The same rule as `tiled_fits` in csrc/pool_grad.cu, which
    refuses a tiled launch that breaks it."""
    n, h, w, c = shape
    itemsize = dtype.itemsize
    _, ct = _tiling(c, dtype, aligned)
    out_h, out_w, _ = _geometry(h, w, kernel, stride)
    windows = out_h * out_w * ct
    if kind == "pool_max":
        smem = (h * w * ct + windows) * itemsize + windows
    else:
        smem = windows * 4
    return ((kind != "pool_max" or kernel <= MAX_TILED_MAX_KERNEL)
            and smem <= SMEM_BUDGET and h * w * c < 2 ** 31
            and n * -(-c // ct) < 2 ** 31)


def _check_nhwc(name, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: tensors must be float32 or bfloat16, got %s"
                        % (name, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s: tensors must be contiguous NHWC" % name)


def _launch_fwd(x, kind, kernel, stride):
    global launches
    _check_nhwc("pool_fwd", x)
    n, h, w, c = x.shape
    out_h, pad_t, _ = same_pads(h, kernel, stride)
    out_w, pad_l, _ = same_pads(w, kernel, stride)
    out = torch.empty((n, out_h, out_w, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("cap2det_pool_same_fwd", _FWD_ARGTYPES)
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


def _launch_grad(x, g, x_shape, dtype, kind, kernel, stride):
    """K5 (x given) or K6 (x None) on the card; returns dx and whether the
    tiled kernel ran (None when dx is empty and nothing launched)."""
    name = "maxpool_grad" if x is not None else "avgpool_grad"
    _check_nhwc(name, g)
    if g.dtype != dtype:
        raise TypeError("%s: g is %s, x is %s" % (name, g.dtype, dtype))
    if x is not None:
        _check_nhwc(name, x)
        if x.device != g.device:
            raise ValueError("%s: x on %s, g on %s"
                             % (name, x.device, g.device))
    n, h, w, c = x_shape
    out_h, pad_t, _ = same_pads(h, kernel, stride)
    out_w, pad_l, _ = same_pads(w, kernel, stride)
    dx = torch.empty(x_shape, dtype=dtype, device=g.device)
    if dx.numel() == 0:
        return dx, None
    tiled = _tiled(x_shape, dtype, kernel, stride, kind,
                   build.aligned(g, dx, *([x] if x is not None else [])))
    fn = build.function("cap2det_pool_same_grad", _GRAD_ARGTYPES)
    with torch.cuda.device(g.device):
        rc = fn(
            x.data_ptr() if x is not None else None, g.data_ptr(),
            dx.data_ptr(), n, h, w, c, out_h, out_w, kernel, stride, pad_t,
            pad_l, int(kind == "pool_max"), int(tiled),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(rc, name)
    return dx, tiled


def _check_args(name, shape, kernel, stride):
    if len(shape) != 4 or kernel < 1 or stride < 1:
        raise ValueError("%s: [N,H,W,C] input and kernel, stride >= 1 "
                         "expected; got %s, %d, %d"
                         % (name, tuple(shape), kernel, stride))


def _check_g(name, x_shape, g, kernel, stride):
    n, h, w, c = x_shape
    want = (n, same_pads(h, kernel, stride)[0],
            same_pads(w, kernel, stride)[0], c)
    if tuple(g.shape) != want:
        raise ValueError("%s: g must be %s for x %s, got %s"
                         % (name, want, tuple(x_shape), tuple(g.shape)))


def pool_fwd(x, kind, kernel, stride):
    """SAME k x k / stride pool forward of x [N, H, W, C] (K4); kind is
    "pool_max" or "pool_avg". Not differentiable: see ``pool_same``."""
    _check_kind(kind)
    _check_args("pool_fwd", x.shape, kernel, stride)
    with span("cap2det/kernel/pool_fwd"):
        if x.is_cuda:
            return _launch_fwd(x, kind, kernel, stride)
        return pool_same_plain(x, kind, kernel, stride)


def maxpool_grad(x, g, kernel, stride):
    """dx of y = SAME max-pool(x) given upstream g [N, OH, OW, C] (K5),
    first-tie routing, in x's dtype."""
    global maxpool_grad_launches, maxpool_grad_tiled_launches
    global maxpool_grad_untiled_launches
    _check_args("maxpool_grad", x.shape, kernel, stride)
    _check_g("maxpool_grad", x.shape, g, kernel, stride)
    with span("cap2det/kernel/maxpool_grad"):
        if x.is_cuda or g.is_cuda:
            dx, tiled = _launch_grad(x, g, tuple(x.shape), x.dtype,
                                     "pool_max", kernel, stride)
            if tiled is not None:
                maxpool_grad_launches += 1
                maxpool_grad_tiled_launches += tiled
                maxpool_grad_untiled_launches += not tiled
            return dx
        return maxpool_grad_plain(x, g, kernel, stride)


def avgpool_grad(x_shape, dtype, g, kernel, stride):
    """dx of y = SAME avg-pool(x) given upstream g (K6): linear, so only
    x's shape and dtype are needed."""
    global avgpool_grad_launches, avgpool_grad_tiled_launches
    global avgpool_grad_untiled_launches
    x_shape = tuple(x_shape)
    _check_args("avgpool_grad", x_shape, kernel, stride)
    _check_g("avgpool_grad", x_shape, g, kernel, stride)
    with span("cap2det/kernel/avgpool_grad"):
        if g.is_cuda:
            dx, tiled = _launch_grad(None, g, x_shape, dtype, "pool_avg",
                                     kernel, stride)
            if tiled is not None:
                avgpool_grad_launches += 1
                avgpool_grad_tiled_launches += tiled
                avgpool_grad_untiled_launches += not tiled
            return dx
        return avgpool_grad_plain(x_shape, dtype, g, kernel, stride)


class _PoolSame(torch.autograd.Function):
    """K4 forward; K5 (max) or K6 (avg) backward."""

    @staticmethod
    def forward(ctx, x, kind, kernel, stride):
        ctx.conf = (kind, kernel, stride)
        if kind == "pool_max":
            ctx.save_for_backward(x)
        ctx.x_shape, ctx.x_dtype = tuple(x.shape), x.dtype
        return pool_fwd(x, kind, kernel, stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        kind, kernel, stride = ctx.conf
        # The incoming gradient is often a channel slice of a concat's
        # backward; the kernels take contiguous NHWC only.
        g = g.contiguous()
        if kind == "pool_max":
            (x,) = ctx.saved_tensors
            dx = maxpool_grad(x, g, kernel, stride)
        else:
            dx = avgpool_grad(ctx.x_shape, ctx.x_dtype, g, kernel, stride)
        return dx, None, None, None


def pool_same(x, kind, kernel, stride):
    """Differentiable SAME pool of x [N, H, W, C]: K4 forward, K5/K6
    backward (their plain versions for CPU tensors)."""
    _check_kind(kind)
    _check_args("pool_same", x.shape, kernel, stride)
    return _PoolSame.apply(x, kind, kernel, stride)
