"""The frozen-BatchNorm fold of a prepared tree's convolutions in one launch
(the port's counterpart of the fold in ``cap2det_tpu/models/
inception_v2.py`` ``_fold_bn``, which XLA fuses into the TPU program).

``fold`` takes each convolution's float32 OIHW ``weights``, its
BatchNorm's ``beta``, ``moving_mean`` and ``moving_variance`` and, where
the BatchNorm has one (ResNet's), its scale ``gamma``, with the
backbone's epsilon; it returns each weight and bias in the compute
dtype, as ``fold_reference`` computes them:

    inv    = rsqrt(moving_variance + eps)
    scale  = gamma * inv, or inv where there is no gamma
    weight = (weights * scale[o]).to(dtype), channels-last
    bias   = (beta - moving_mean * scale).to(dtype)

For CUDA tensors one launch of ``csrc/bn_fold.cu`` writes every weight
and bias, each a view of one fresh buffer. While autograd records and a
leaf requires a gradient, the outputs that depend on a leaf that
requires one (a weight on its ``weights`` or ``gamma``, a bias on its
``beta`` or ``gamma``) come out of a ``torch.autograd.Function``, whose
backward is one more launch (``fold_grad_reference``'s formulas, gamma's
gradient a sum over each output channel in ``channel_sum``'s order) into
one float32 buffer, each gradient a contiguous view of it; the frozen
convolutions' outputs are plain views, no part of the graph. The moving
statistics are frozen there: a fold that would differentiate them
raises. On a CUDA tensor the wrapper launches or raises; it never falls
back. For CPU tensors ``fold_reference`` runs, differentiable in every
leaf of a convolution without gamma (the port's former chain), and
through ``fold_grad_reference`` where there is one.

A ``FoldPlan`` lays out the buffers and the chunk tables the kernels'
blocks walk (no chunk crosses a convolution) for one tree structure (the
weights' shapes and strides, which convolutions have a gamma, which
leaves train); it is made once per structure and uploaded once per
device. Pointers go to each launch by value, so nothing keyed on an
address is kept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.utils.spans import span

BN_EPSILON = 0.001
MAX_CONVS = 128  # convolutions per launch (kMaxConvs in the source)
VEC = 8  # outputs a thread writes together (kVec)
CHUNK = 8192  # elements per block at most, a multiple of VEC
GAMMA_CHUNK = 64  # output channels per block of gamma's gradient
LANES = 32  # channel_sum's partial sums: a warp's lanes
# Every view starts a multiple of ALIGN elements into its buffer: 512
# bytes or more, as an allocation of its own would.
ALIGN = 256
WEIGHT, BIAS, GAMMA = 0, 1, 2  # a chunk's kind
GRAD_CHANNELS_LAST = 1  # GradArgs::flags
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The kernel's structs, as numpy records (the C entries copy an Args from
# host memory into the launch; the Conv table is uploaded once).
CONV_DTYPE = np.dtype([
    ("out_channels", "<i4"), ("in_channels", "<i4"), ("taps", "<i4"),
    ("pad", "<i4"), ("w_stride_o", "<i8"), ("w_stride_i", "<i8"),
    ("out_w", "<i8"), ("out_b", "<i8"), ("scale", "<i8"), ("inv", "<i8"),
    ("grad_w", "<i8"), ("grad_b", "<i8"), ("grad_g", "<i8")], align=True)
FOLD_ARGS_DTYPE = np.dtype([
    ("w", "<u8", (MAX_CONVS,)), ("beta", "<u8", (MAX_CONVS,)),
    ("mean", "<u8", (MAX_CONVS,)), ("var", "<u8", (MAX_CONVS,)),
    ("gamma", "<u8", (MAX_CONVS,)), ("convs", "<u8"), ("chunks", "<u8"),
    ("out", "<u8"), ("scale", "<u8"), ("eps", "<f4"), ("n_chunks", "<i4")],
    align=True)
GRAD_ARGS_DTYPE = np.dtype([
    ("gw", "<u8", (MAX_CONVS,)), ("gb", "<u8", (MAX_CONVS,)),
    ("w", "<u8", (MAX_CONVS,)), ("mean", "<u8", (MAX_CONVS,)),
    ("flags", "<i4", (MAX_CONVS,)), ("convs", "<u8"), ("chunks", "<u8"),
    ("scale", "<u8"), ("out", "<u8"), ("n_chunks", "<i4")], align=True)

# Kernel launches: one per fold, one per fold's backward.
launches = 0
grad_launches = 0

_layout_checked = False
_plans = {}


def fold_bytes(numel, out_bytes=2):
    """Bytes the fold must move: each float32 weight read once and written
    once in the output dtype (the BN vectors, under 0.1%, left out)."""
    return (4 + out_bytes) * numel


def fold_grad_bytes(numel, grad_bytes=2, gamma_numel=0):
    """Bytes the fold's backward must move: each trainable weight's
    gradient read once in the output dtype and written once in float32,
    and the float32 weights of the `gamma_numel` whose gamma trains read
    once for gamma's sums."""
    return (grad_bytes + 4) * numel + 4 * gamma_numel


def fold_flops(numel, channels):
    """Floating-point operations of the fold's function: a product per
    weight; per output channel a sum, a reciprocal square root, a product
    and a difference."""
    return numel + 4 * channels


def fold_grad_flops(numel, gamma_numel=0):
    """Floating-point operations of the backward's function: a product per
    trainable weight (the bias's gradient is a cast), and a product and a
    sum per weight of the `gamma_numel` whose gamma trains."""
    return numel + 2 * gamma_numel


def channel_sum(g, w):
    """Per output channel, the float32 sum of ``g * w`` ([O, I, kh, kw]
    each, any strides) over its filter in (tap, input channel) order:
    LANES interleaved partial sums, element j into sum j mod LANES in
    turn, then halves added pairwise (sum l plus sum l xor 16, then xor 8,
    4, 2, 1). The kernel's warp sums in this order, so the two agree bit
    for bit."""
    o = g.shape[0]
    prod = (g.float().permute(0, 2, 3, 1) * w.permute(0, 2, 3, 1)).reshape(
        o, -1)
    n = prod.shape[1]
    prod = torch.nn.functional.pad(prod, (0, -(-n // LANES) * LANES - n))
    prod = prod.reshape(o, -1, LANES)
    acc = torch.zeros((o, LANES), dtype=torch.float32, device=g.device)
    for k in range(prod.shape[1]):
        acc = acc + prod[:, k]
    lane = torch.arange(LANES, device=g.device)
    half = LANES // 2
    while half:
        acc = acc + acc[:, lane ^ half]
        half //= 2
    return acc[:, 0]


def _fold_values(w, beta, mean, var, dtype, gamma, eps):
    inv = torch.rsqrt(var + eps)
    scale = inv if gamma is None else gamma * inv
    weight = (w * scale[:, None, None, None]).to(dtype)
    return (weight.contiguous(memory_format=torch.channels_last),
            (beta - mean * scale).to(dtype), inv, scale)


class _FoldReference(torch.autograd.Function):
    """``fold_reference`` of a convolution with a gamma: the backward is
    ``fold_grad_reference``'s, the kernel's arithmetic."""

    @staticmethod
    def forward(ctx, w, beta, gamma, mean, var, dtype, eps):
        weight, bias, inv, scale = _fold_values(w, beta, mean, var, dtype,
                                                gamma, eps)
        ctx.save_for_backward(w, mean, inv, scale)
        return weight, bias

    @staticmethod
    def backward(ctx, g_weight, g_bias):
        w, mean, inv, scale = ctx.saved_tensors
        dw, dbeta, dgamma = fold_grad_reference(
            g_weight, g_bias, scale, w, mean,
            inv if ctx.needs_input_grad[2] else None)
        return dw, dbeta, dgamma, None, None, None, None


def fold_reference(w, beta, mean, var, dtype, gamma=None, eps=BN_EPSILON):
    """The plain version: one convolution's (weight, bias) in `dtype`, the
    weight channels-last. Without `gamma`, the port's former chain of
    PyTorch ops, differentiable in every leaf; with one, differentiable in
    ``weights``, ``beta`` and ``gamma`` through ``fold_grad_reference``
    (the moving statistics frozen)."""
    if gamma is None:
        return _fold_values(w, beta, mean, var, dtype, None, eps)[:2]
    if torch.is_grad_enabled() and (mean.requires_grad or var.requires_grad):
        raise ValueError("bn_fold: the moving statistics are frozen; one "
                         "requires a gradient")
    return _FoldReference.apply(w, beta, gamma, mean, var, dtype, eps)


def fold_grad_reference(g_weight, g_bias, scale, w=None, mean=None,
                        inv=None):
    """The plain version of the backward: one convolution's float32
    (dweights, dbeta, dgamma) from its outputs' gradients (either may be
    None) and its scale (its inv where it has no gamma), as the kernel
    computes them:

        dweights = float(g_weight) * scale[o]
        dbeta    = float(g_bias)
        dgamma   = (channel_sum(g_weight, w) - float(g_bias) * mean) * inv

    dgamma only with `w`, `mean` and `inv` (a convolution with a gamma),
    else None."""
    dw = None if g_weight is None else (g_weight.float()
                                        * scale[:, None, None, None])
    dbeta = None if g_bias is None else g_bias.float()
    dgamma = None
    if inv is not None:
        total = (torch.zeros_like(inv) if g_weight is None
                 else channel_sum(g_weight, w))
        if g_bias is not None:
            total = total - g_bias.float() * mean
        dgamma = total * inv
    return dw, dbeta, dgamma


def _align(n):
    return -(-n // ALIGN) * ALIGN


def _chunks(conv, n, kind, size=CHUNK):
    return [(conv, s, min(size, n - s), kind) for s in range(0, n, size)]


class FoldPlan:
    """One tree structure's layout: per convolution its shape, weight
    strides, offsets of its weight and bias in the output buffer
    (``out_total`` elements), of its scale and, where it has a gamma, its
    inv in the scale buffer (``scale_total``; inv -1 where none), and,
    where its ``weights`` / ``beta`` / ``gamma`` train (``grad_w``,
    ``grad_b``, ``grad_g``), of their gradients in the float32 gradient
    buffer (``grad_total``; -1 where none); the forward's and the
    backward's chunk tables, [n, 4] int32 rows of (convolution, start,
    length, kind), a gamma chunk's start and length in output channels.

    ``structure``: per convolution ((shape, strides) of its weights,
    whether it has a gamma)."""

    def __init__(self, structure, grad_w, grad_b, grad_g):
        self.shapes = [shape for (shape, _), _ in structure]
        self.has_gamma = tuple(g for _, g in structure)
        if len(self.shapes) > MAX_CONVS:
            raise ValueError("bn_fold: %d convolutions, at most %d in one "
                             "fold" % (len(self.shapes), MAX_CONVS))
        self.grad_w, self.grad_b = tuple(grad_w), tuple(grad_b)
        self.grad_g = tuple(grad_g)
        self.table = np.zeros(len(self.shapes), CONV_DTYPE)
        fwd, bwd = [], []
        out_at = scale_at = grad_at = 0
        for i, ((shape, stride), gamma) in enumerate(structure):
            if len(shape) != 4 or stride[3] != 1 or stride[2] != shape[3]:
                raise ValueError("bn_fold: convolution %d: weights %s with "
                                 "strides %s (4-D, taps packed)"
                                 % (i, shape, stride))
            if self.grad_g[i] and not gamma:
                raise ValueError("bn_fold: convolution %d: a gamma's "
                                 "gradient without a gamma" % i)
            o, c, kh, kw = shape
            n = o * c * kh * kw
            if n >= 2 ** 31:
                raise ValueError("bn_fold: a weight of 2^31 elements or more")
            row = self.table[i]
            row["out_channels"], row["in_channels"], row["taps"] = (
                o, c, kh * kw)
            row["w_stride_o"], row["w_stride_i"] = stride[0], stride[1]
            row["out_w"], out_at = out_at, _align(out_at + n)
            row["out_b"], out_at = out_at, _align(out_at + o)
            row["scale"], scale_at = scale_at, scale_at + o
            row["inv"] = -1
            if gamma:
                row["inv"], scale_at = scale_at, scale_at + o
            fwd += _chunks(i, n, WEIGHT) + _chunks(i, o, BIAS)
            row["grad_w"] = row["grad_b"] = row["grad_g"] = -1
            if self.grad_w[i]:
                row["grad_w"], grad_at = grad_at, _align(grad_at + n)
                bwd += _chunks(i, n, WEIGHT)
            if self.grad_b[i]:
                row["grad_b"], grad_at = grad_at, _align(grad_at + o)
                bwd += _chunks(i, o, BIAS)
            if self.grad_g[i]:
                row["grad_g"], grad_at = grad_at, _align(grad_at + o)
                bwd += _chunks(i, o, GAMMA, GAMMA_CHUNK)
        self.out_total, self.scale_total, self.grad_total = (
            max(out_at, 1), max(scale_at, 1), max(grad_at, 1))
        self.fwd_chunks = np.asarray(fwd, np.int32).reshape(-1, 4)
        self.bwd_chunks = np.asarray(bwd, np.int32).reshape(-1, 4)
        # (size, stride, offset) of each output, the weights' strides as
        # ``fold_reference`` leaves them: PyTorch's channels-last, which
        # keeps a 1x1 weight's contiguous strides.
        self._views = []
        for shape, row in zip(self.shapes, self.table):
            self._views.append((shape, torch.empty(
                shape, device="meta").contiguous(
                    memory_format=torch.channels_last).stride(),
                int(row["out_w"])))
            self._views.append((shape[:1], (1,), int(row["out_b"])))
        # (size, stride, offset) of each gradient (dweights, dbeta,
        # dgamma of each convolution), or None.
        self._grad_views = []
        for (o, c, kh, kw), row in zip(self.shapes, self.table):
            self._grad_views.append(None if row["grad_w"] < 0 else (
                (o, c, kh, kw), (c * kh * kw, kh * kw, kw, 1),
                int(row["grad_w"])))
            for key in ("grad_b", "grad_g"):
                self._grad_views.append(None if row[key] < 0 else (
                    (o,), (1,), int(row[key])))
        # Whether each output, (weight 0, bias 0, weight 1, ...), is part
        # of the graph: a weight where its weights or gamma train, a bias
        # where its beta or gamma do.
        self.trains = tuple(m for w, b, g in zip(self.grad_w, self.grad_b,
                                                 self.grad_g)
                            for m in (w or g, b or g))
        # Whether each leaf, (weights 0, beta 0, gamma 0, weights 1, ...),
        # trains.
        self.leaf_trains = tuple(m for trio in zip(
            self.grad_w, self.grad_b, self.grad_g) for m in trio)
        self._records = {}  # device -> (table, forward chunks, backward)

    def outputs(self, out, keep=None):
        """[weight 0, bias 0, weight 1, ...]: each weight a channels-last
        [O, I, kh, kw] view of `out`, each bias an [O] view; with `keep`,
        only those it marks."""
        view = out.as_strided
        if keep is None:
            return [view(*args) for args in self._views]
        return [view(*args) for args, k in zip(self._views, keep) if k]

    def gradients(self, grad):
        """[dweights 0, dbeta 0, dgamma 0, dweights 1, ...], each a
        contiguous view of the gradient buffer `grad` or None."""
        view = grad.as_strided
        return [args and view(*args) for args in self._grad_views]

    def records(self, device):
        """The convolution table and both chunk tables on `device` (made
        at first use)."""
        if device not in self._records:
            table = torch.from_numpy(
                np.frombuffer(self.table.tobytes(), np.uint8).copy())
            self._records[device] = tuple(
                t.to(device) for t in (table,
                                       torch.from_numpy(self.fwd_chunks),
                                       torch.from_numpy(self.bwd_chunks)))
        return self._records[device]


def plan(weights, grad_w, grad_b, gammas=None, grad_g=None):
    """The ``FoldPlan`` of these weights' shapes and strides, with a gamma
    where `gammas` marks one (none by default), with these trainable
    leaves, made once."""
    n = len(weights)
    gammas = (False,) * n if gammas is None else tuple(gammas)
    grad_g = (False,) * n if grad_g is None else tuple(grad_g)
    key = (tuple(((tuple(w.shape), w.stride()), g)
                 for w, g in zip(weights, gammas)),
           tuple(grad_w), tuple(grad_b), grad_g)
    if key not in _plans:
        _plans[key] = FoldPlan(*key)
    return _plans[key]


def _check_layout():
    global _layout_checked
    if _layout_checked:
        return
    fn = build.function("cap2det_bn_fold_layout",
                        [ctypes.c_void_p, ctypes.c_int])
    got = np.zeros(48, np.int64)
    n = fn(got.ctypes.data, len(got))
    want = ([CONV_DTYPE.itemsize, FOLD_ARGS_DTYPE.itemsize,
             GRAD_ARGS_DTYPE.itemsize, MAX_CONVS, VEC]
            + [CONV_DTYPE.fields[k][1] for k in CONV_DTYPE.names
               if k != "pad"]
            + [FOLD_ARGS_DTYPE.fields[k][1] for k in FOLD_ARGS_DTYPE.names]
            + [GRAD_ARGS_DTYPE.fields[k][1] for k in GRAD_ARGS_DTYPE.names])
    if got[:n].tolist() != want:
        raise RuntimeError("bn_fold: the host's struct layout %s is not the "
                           "kernel's %s" % (want, got[:n].tolist()))
    _layout_checked = True


def _check_inputs(convs, dtype):
    """Raises unless the fold's kernel takes these inputs (the weights'
    shapes and strides ``FoldPlan`` checks)."""
    if dtype not in DTYPES:
        raise TypeError("bn_fold: output dtype %s (bfloat16 or float32)"
                        % dtype)
    device = convs[0][0].get_device()
    for i, conv in enumerate(convs):
        o = conv[0].shape[:1]
        for k, t in enumerate(conv):
            if t is None:
                continue
            if t.dtype is not torch.float32 or t.get_device() != device:
                raise ValueError("bn_fold: convolution %d: a %s tensor on "
                                 "%s, expected float32 on %s" % (
                                     i, t.dtype, t.device, convs[0][0].device))
            if k and (t.shape != o or not t.is_contiguous()):
                raise ValueError("bn_fold: convolution %d: a BN vector %s, "
                                 "expected a contiguous %s"
                                 % (i, tuple(t.shape), tuple(o)))


def _launch(plan_, convs, out, scale, eps):
    global launches
    _check_layout()
    fn = build.function("cap2det_bn_fold", [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p])
    table, chunks, _ = plan_.records(out.device)
    n = len(plan_.shapes)
    rec = np.zeros((), FOLD_ARGS_DTYPE)
    ptrs = np.fromiter((0 if t is None else t.data_ptr()
                        for conv in convs for t in conv), np.uint64,
                       5 * n).reshape(n, 5)
    for k, name in enumerate(("w", "beta", "mean", "var", "gamma")):
        rec[name][:n] = ptrs[:, k]
    rec["convs"], rec["chunks"] = table.data_ptr(), chunks.data_ptr()
    rec["out"] = out.data_ptr()
    rec["scale"] = 0 if scale is None else scale.data_ptr()
    rec["eps"] = eps
    rec["n_chunks"] = len(plan_.fwd_chunks)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(fn(DTYPES[out.dtype], rec.ctypes.data, stream),
                    "bn_fold")
    launches += 1


def _grad_flags(i, g, shape, dtype):
    """GradArgs::flags of a weight's gradient; raises on one the kernel
    does not take."""
    if tuple(g.shape) != shape or g.dtype != dtype:
        raise ValueError("bn_fold: convolution %d: a %s gradient %s, the "
                         "weight is %s %s" % (i, g.dtype, tuple(g.shape),
                                              dtype, shape))
    if g.is_contiguous():
        return 0
    if g.is_contiguous(memory_format=torch.channels_last):
        return GRAD_CHANNELS_LAST
    raise ValueError("bn_fold: convolution %d: a gradient neither "
                     "contiguous nor channels-last (strides %s)"
                     % (i, g.stride()))


def _launch_grad(plan_, g_w, g_b, aux, scale, grad, dtype):
    """One launch of the backward: `g_w`, `g_b` the outputs' gradients
    (None where an output is no part of the graph), `aux` each
    convolution's (weights, moving_mean), read for gamma's gradient."""
    global grad_launches
    _check_layout()
    fn = build.function("cap2det_bn_fold_grad",
                        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    table, _, chunks = plan_.records(grad.device)
    rec = np.zeros((), GRAD_ARGS_DTYPE)
    for i, (shape, gw, gb) in enumerate(zip(plan_.shapes, g_w, g_b)):
        if gw is not None:
            rec["flags"][i] = _grad_flags(i, gw, shape, dtype)
            rec["gw"][i] = gw.data_ptr()
        if gb is not None:
            if (tuple(gb.shape) != shape[:1] or gb.dtype != dtype
                    or not gb.is_contiguous()):
                raise ValueError("bn_fold: convolution %d: a bias gradient "
                                 "%s %s, expected a contiguous %s [%d]"
                                 % (i, gb.dtype, tuple(gb.shape), dtype,
                                    shape[0]))
            rec["gb"][i] = gb.data_ptr()
        if plan_.grad_g[i]:
            rec["w"][i], rec["mean"][i] = (aux[i][0].data_ptr(),
                                           aux[i][1].data_ptr())
    for g in [*g_w, *g_b]:
        if g is not None and g.device != grad.device:
            raise ValueError("bn_fold: a gradient on %s, expected %s"
                             % (g.device, grad.device))
    rec["convs"], rec["chunks"] = table.data_ptr(), chunks.data_ptr()
    rec["scale"], rec["out"] = scale.data_ptr(), grad.data_ptr()
    rec["n_chunks"] = len(plan_.bwd_chunks)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(fn(DTYPES[dtype], rec.ctypes.data, stream),
                    "bn_fold_grad")
    grad_launches += 1


def _fold(plan_, convs, dtype, eps, keep_scale):
    """The output buffer (and the scale buffer, with `keep_scale`), filled
    by one launch."""
    device = convs[0][0].device
    out = torch.empty(plan_.out_total, dtype=dtype, device=device)
    scale = (torch.empty(plan_.scale_total, dtype=torch.float32,
                         device=device) if keep_scale else None)
    _launch(plan_, convs, out, scale, eps)
    return out, scale


def _fold_grad(plan_, g_w, g_b, aux, scale, dtype):
    """The float32 gradient buffer, filled by one launch."""
    grad = torch.empty(plan_.grad_total, dtype=torch.float32,
                       device=scale.device)
    _launch_grad(plan_, g_w, g_b, aux, scale, grad, dtype)
    return grad


class _Fold(torch.autograd.Function):
    """The differentiable outputs of a fold already made, for autograd.
    Inputs: the plan, the dtype, (the output buffer, the scale buffer,
    each convolution's (weights, moving_mean) for gamma's gradient), then
    the leaves that train, the only tensors autograd tracks, in
    ``plan.leaf_trains``' order. Outputs: the outputs that are part of the
    graph, views of the buffer, in ``plan.trains``' order. The backward is
    one launch."""

    @staticmethod
    def forward(ctx, plan_, dtype, buffers, *trainable):
        out, scale, aux = buffers
        ctx.plan, ctx.dtype, ctx.aux = plan_, dtype, aux
        ctx.save_for_backward(scale)
        return tuple(plan_.outputs(out, plan_.trains))

    @staticmethod
    def backward(ctx, *grads):
        (scale,) = ctx.saved_tensors
        plan_ = ctx.plan
        given = iter(grads)
        grads = [next(given) if m else None for m in plan_.trains]
        with span("cap2det/kernel/bn_fold_grad"):
            grad = _fold_grad(plan_, grads[0::2], grads[1::2], ctx.aux,
                              scale, ctx.dtype)
        return (None, None, None) + tuple(
            v for v, m in zip(plan_.gradients(grad), plan_.leaf_trains)
            if m)


def fold(convs, dtype=torch.bfloat16, eps=BN_EPSILON):
    """[(weights, beta, moving_mean, moving_variance[, gamma])] of
    convolutions -> [(weight, bias)] in `dtype` (bfloat16 or float32),
    the weight channels-last, equal to ``fold_reference``'s bit for bit,
    with the BatchNorm's epsilon `eps`. For CUDA tensors one launch writes
    them all as views of one fresh buffer, and the fold is differentiable
    in ``weights``, ``beta`` and ``gamma`` with one more launch in the
    backward; for CPU tensors ``fold_reference`` runs."""
    if not convs:
        return []
    convs = [tuple(conv) + (None,) * (5 - len(conv)) for conv in convs]
    with span("cap2det/kernel/bn_fold"):
        if convs[0][0].device.type == "cpu":
            return [fold_reference(w, beta, mean, var, dtype, gamma, eps)
                    for w, beta, mean, var, gamma in convs]
        return _fold_kernels(convs, dtype, eps)


def compose_separable(node):
    """A separable convolution node (InceptionV2's stem) as one dense OIHW
    kernel, exact since the pointwise convolution is 1x1:
    W[o,c,u,v] = sum_m dw[c,m,u,v] pw[o,c*mult+m]."""
    dw = node["depthwise_weights"]  # [cin, mult, kh, kw]
    pw = node["pointwise_weights"]  # [cout, cin*mult, 1, 1]
    cin, mult = dw.shape[:2]
    if cin > 8:
        raise ValueError("only the composed stem form (cin <= 8) is ported")
    return torch.einsum("cmuv,ocm->ocuv", dw, pw.reshape(-1, cin, mult))


def gather(params, slots):
    """`params`' tree as ``fold_trees`` returns it, each convolution's
    entry left empty, and (its dict, its key, its OIHW weights, its
    BatchNorm) appended to `slots` in order (a separable convolution
    composed first)."""
    out = {}
    for key, value in params.items():
        if "depthwise_weights" in value:
            out[key] = None
            slots.append((out, key, compose_separable(value),
                          value["BatchNorm"]))
        elif "weights" in value:
            out[key] = None
            slots.append((out, key, value["weights"], value["BatchNorm"]))
        else:
            out[key] = gather(value, slots)
    return out


def fold_trees(stages, dtype=torch.bfloat16, eps=BN_EPSILON):
    """Params trees of a backbone's stages -> the trees its stages read:
    every convolution ({weight, bias} in place of its node) folded by one
    ``fold`` call with the backbone's epsilon `eps`, gamma included where
    its BatchNorm has one. Serving makes them once per set of params, so
    a forward pass launches no weight arithmetic; training makes them
    inside the loss, where the fold is differentiable and frozen leaves
    build no graph."""
    slots = []
    trees = [gather(params, slots) for params in stages]
    folded = fold([(w, bn["beta"], bn["moving_mean"], bn["moving_variance"],
                    bn.get("gamma")) for _, _, w, bn in slots], dtype, eps)
    for (out, key, _, _), (weight, bias) in zip(slots, folded):
        out[key] = {"weight": weight, "bias": bias}
    return trees


def _fold_kernels(convs, dtype, eps):
    _check_inputs(convs, dtype)
    ws = [c[0] for c in convs]
    gammas = [c[4] is not None for c in convs]
    grad_w = [w.requires_grad for w in ws]
    grad_b = [c[1].requires_grad for c in convs]
    grad_g = [c[4] is not None and c[4].requires_grad for c in convs]
    trains = torch.is_grad_enabled() and (any(grad_w) or any(grad_b)
                                          or any(grad_g))
    if trains and any(t.requires_grad for c in convs for t in c[2:4]):
        raise ValueError("bn_fold: the moving statistics are frozen; one "
                         "requires a gradient")
    if not trains:
        grad_w = grad_b = grad_g = (False,) * len(convs)
    plan_ = plan(ws, grad_w, grad_b, gammas, grad_g)
    with torch.no_grad():
        out, scale = _fold(plan_, convs, dtype, eps, keep_scale=trains)
    if not trains:
        outputs = plan_.outputs(out)
    else:
        aux = [(c[0], c[2]) if g else None for c, g in zip(convs, grad_g)]
        leaves = (t for c in convs for t in (c[0], c[1], c[4]))
        diff = iter(_Fold.apply(plan_, dtype, (out, scale, aux), *[
            t for t, m in zip(leaves, plan_.leaf_trains) if m]))
        frozen = iter(plan_.outputs(out, [not m for m in plan_.trains]))
        outputs = [next(diff) if m else next(frozen) for m in plan_.trains]
    return list(zip(outputs[0::2], outputs[1::2]))
