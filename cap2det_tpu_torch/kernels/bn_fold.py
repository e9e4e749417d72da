"""The frozen-BatchNorm fold of a prepared tree's convolutions in one launch
(the port's counterpart of the fold in ``cap2det_tpu/models/
inception_v2.py`` ``_fold_bn``, which XLA fuses into the TPU program).

``fold`` takes each convolution's float32 OIHW ``weights`` and its
BatchNorm's ``beta``, ``moving_mean`` and ``moving_variance``, and
returns its weight and bias in the compute dtype, as ``fold_reference``
computes them (the port's former per-convolution chain of PyTorch ops):

    inv    = rsqrt(moving_variance + 1e-3)
    weight = (weights * inv[o]).to(dtype), channels-last
    bias   = (beta - moving_mean * inv).to(dtype)

For CUDA tensors one launch of ``csrc/bn_fold.cu`` writes every weight
and bias, each a view of one fresh buffer. While autograd records and a
leaf requires a gradient, the outputs of the convolutions whose
``weights`` or ``beta`` require one come out of a
``torch.autograd.Function``, whose backward is one more launch
(``fold_grad_reference``'s formulas) into one float32 buffer, each
gradient a contiguous view of it; the frozen convolutions' outputs are
plain views, no part of the graph. The moving statistics are frozen
there: a fold that would differentiate them raises. On a CUDA tensor the
wrapper launches or raises; it never falls back. For CPU tensors
``fold_reference`` runs, as the port always ran it, differentiable in
every leaf.

A ``FoldPlan`` lays out the buffers and the chunk tables the kernels'
blocks walk (no chunk crosses a convolution) for one tree structure (the
weights' shapes and strides, which leaves train); it is made once per
structure and uploaded once per device. Pointers go to each launch by
value, so nothing keyed on an address is kept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.utils.spans import span

BN_EPSILON = 0.001
MAX_CONVS = 80  # convolutions per launch (kMaxConvs in the source)
VEC = 8  # outputs a thread writes together (kVec)
CHUNK = 8192  # elements per block at most, a multiple of VEC
# Every view starts a multiple of ALIGN elements into its buffer: 512
# bytes or more, as an allocation of its own would.
ALIGN = 256
WEIGHT, BIAS = 0, 1  # a chunk's kind
GRAD_CHANNELS_LAST = 1  # GradArgs::flags
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The kernel's structs, as numpy records (the C entries copy an Args from
# host memory into the launch; the Conv table is uploaded once).
CONV_DTYPE = np.dtype([
    ("out_channels", "<i4"), ("in_channels", "<i4"), ("taps", "<i4"),
    ("pad", "<i4"), ("w_stride_o", "<i8"), ("w_stride_i", "<i8"),
    ("out_w", "<i8"), ("out_b", "<i8"), ("inv", "<i8"), ("grad_w", "<i8"),
    ("grad_b", "<i8")], align=True)
FOLD_ARGS_DTYPE = np.dtype([
    ("w", "<u8", (MAX_CONVS,)), ("beta", "<u8", (MAX_CONVS,)),
    ("mean", "<u8", (MAX_CONVS,)), ("var", "<u8", (MAX_CONVS,)),
    ("convs", "<u8"), ("chunks", "<u8"), ("out", "<u8"), ("inv", "<u8"),
    ("n_chunks", "<i4")], align=True)
GRAD_ARGS_DTYPE = np.dtype([
    ("gw", "<u8", (MAX_CONVS,)), ("gb", "<u8", (MAX_CONVS,)),
    ("flags", "<i4", (MAX_CONVS,)), ("convs", "<u8"), ("chunks", "<u8"),
    ("inv", "<u8"), ("out", "<u8"), ("n_chunks", "<i4")], align=True)

# Kernel launches: one per fold, one per fold's backward.
launches = 0
grad_launches = 0

_layout_checked = False
_plans = {}


def fold_bytes(numel, out_bytes=2):
    """Bytes the fold must move: each float32 weight read once and written
    once in the output dtype (the BN vectors, under 0.1%, left out)."""
    return (4 + out_bytes) * numel


def fold_grad_bytes(numel, grad_bytes=2):
    """Bytes the fold's backward must move: each trainable weight's
    gradient read once in the output dtype and written once in float32."""
    return (grad_bytes + 4) * numel


def fold_flops(numel, channels):
    """Floating-point operations of the fold's function: a product per
    weight; per output channel a sum, a reciprocal square root, a product
    and a difference."""
    return numel + 4 * channels


def fold_grad_flops(numel):
    """Floating-point operations of the backward's function: a product per
    trainable weight (the bias's gradient is a cast)."""
    return numel


def fold_reference(w, beta, mean, var, dtype):
    """The plain version: one convolution's (weight, bias) in `dtype`, the
    weight channels-last, by the port's former chain of PyTorch ops
    (differentiable)."""
    inv = torch.rsqrt(var + BN_EPSILON)
    weight = (w * inv[:, None, None, None]).to(dtype)
    return (weight.contiguous(memory_format=torch.channels_last),
            (beta - mean * inv).to(dtype))


def fold_grad_reference(g_weight, g_bias, inv):
    """The plain version of the backward: one convolution's float32
    (dweights, dbeta) from its outputs' gradients (either may be None) and
    its inv, as autograd computes them through ``fold_reference``."""
    return (None if g_weight is None
            else g_weight.float() * inv[:, None, None, None],
            None if g_bias is None else g_bias.float())


def _align(n):
    return -(-n // ALIGN) * ALIGN


def _chunks(conv, n, kind):
    return [(conv, s, min(CHUNK, n - s), kind) for s in range(0, n, CHUNK)]


class FoldPlan:
    """One tree structure's layout: per convolution its shape, weight
    strides, offsets of its weight and bias in the output buffer
    (``out_total`` elements), of its inv in the inv buffer (``inv_total``),
    and, where its ``weights`` / ``beta`` train (``grad_w``, ``grad_b``),
    of their gradients in the float32 gradient buffer (``grad_total``; -1
    where none); the forward's and the backward's chunk tables, [n, 4]
    int32 rows of (convolution, start, length, kind)."""

    def __init__(self, structure, grad_w, grad_b):
        self.shapes = [shape for shape, _ in structure]
        if len(self.shapes) > MAX_CONVS:
            raise ValueError("bn_fold: %d convolutions, at most %d in one "
                             "fold" % (len(self.shapes), MAX_CONVS))
        self.grad_w, self.grad_b = tuple(grad_w), tuple(grad_b)
        self.table = np.zeros(len(self.shapes), CONV_DTYPE)
        fwd, bwd = [], []
        out_at = inv_at = grad_at = 0
        for i, (shape, stride) in enumerate(structure):
            if len(shape) != 4 or stride[3] != 1 or stride[2] != shape[3]:
                raise ValueError("bn_fold: convolution %d: weights %s with "
                                 "strides %s (4-D, taps packed)"
                                 % (i, shape, stride))
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
            row["inv"], inv_at = inv_at, inv_at + o
            fwd += _chunks(i, n, WEIGHT) + _chunks(i, o, BIAS)
            row["grad_w"] = row["grad_b"] = -1
            if self.grad_w[i]:
                row["grad_w"], grad_at = grad_at, _align(grad_at + n)
                bwd += _chunks(i, n, WEIGHT)
            if self.grad_b[i]:
                row["grad_b"], grad_at = grad_at, _align(grad_at + o)
                bwd += _chunks(i, o, BIAS)
        self.out_total, self.inv_total, self.grad_total = (
            max(out_at, 1), max(inv_at, 1), max(grad_at, 1))
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
        # (size, stride, offset) of each gradient, or None.
        self._grad_views = []
        for (o, c, kh, kw), row in zip(self.shapes, self.table):
            self._grad_views.append(None if row["grad_w"] < 0 else (
                (o, c, kh, kw), (c * kh * kw, kh * kw, kw, 1),
                int(row["grad_w"])))
            self._grad_views.append(None if row["grad_b"] < 0 else (
                (o,), (1,), int(row["grad_b"])))
        # Whether each output, (weight 0, bias 0, weight 1, ...), trains.
        self.trains = tuple(m for pair in zip(self.grad_w, self.grad_b)
                            for m in pair)
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
        """[dweights 0 or None, dbeta 0 or None, ...]: contiguous views of
        the gradient buffer `grad`."""
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


def plan(weights, grad_w, grad_b):
    """The ``FoldPlan`` of these weights' shapes and strides with these
    trainable leaves, made once."""
    key = (tuple((tuple(w.shape), w.stride()) for w in weights),
           tuple(grad_w), tuple(grad_b))
    if key not in _plans:
        _plans[key] = FoldPlan(*key)
    return _plans[key]


def _check_layout():
    global _layout_checked
    if _layout_checked:
        return
    fn = build.function("cap2det_bn_fold_layout",
                        [ctypes.c_void_p, ctypes.c_int])
    got = np.zeros(40, np.int64)
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


def _check_inputs(tensors, dtype):
    """Raises unless the fold's kernel takes these inputs (the weights'
    shapes and strides ``FoldPlan`` checks)."""
    if dtype not in DTYPES:
        raise TypeError("bn_fold: output dtype %s (bfloat16 or float32)"
                        % dtype)
    device = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if t.dtype is not torch.float32 or t.get_device() != device:
            raise ValueError("bn_fold: convolution %d: a %s tensor on %s, "
                             "expected float32 on %s" % (
                                 i // 4, t.dtype, t.device,
                                 tensors[0].device))
    for i in range(0, len(tensors), 4):
        o = tensors[i].shape[:1]
        for t in tensors[i + 1:i + 4]:
            if t.shape != o or not t.is_contiguous():
                raise ValueError("bn_fold: convolution %d: a BN vector %s, "
                                 "expected a contiguous %s"
                                 % (i // 4, tuple(t.shape), tuple(o)))


def _launch(plan_, tensors, out, inv):
    global launches
    _check_layout()
    fn = build.function("cap2det_bn_fold", [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p])
    table, chunks, _ = plan_.records(out.device)
    n = len(plan_.shapes)
    rec = np.zeros((), FOLD_ARGS_DTYPE)
    ptrs = np.fromiter((t.data_ptr() for t in tensors), np.uint64,
                       4 * n).reshape(n, 4)
    for k, name in enumerate(("w", "beta", "mean", "var")):
        rec[name][:n] = ptrs[:, k]
    rec["convs"], rec["chunks"] = table.data_ptr(), chunks.data_ptr()
    rec["out"] = out.data_ptr()
    rec["inv"] = 0 if inv is None else inv.data_ptr()
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


def _launch_grad(plan_, g_w, g_b, inv, grad, dtype):
    global grad_launches
    _check_layout()
    fn = build.function("cap2det_bn_fold_grad",
                        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    table, _, chunks = plan_.records(grad.device)
    rec = np.zeros((), GRAD_ARGS_DTYPE)
    for i, (shape, gw, gb) in enumerate(zip(plan_.shapes, g_w, g_b)):
        if plan_.grad_w[i]:
            rec["flags"][i] = _grad_flags(i, gw, shape, dtype)
            rec["gw"][i] = gw.data_ptr()
        if plan_.grad_b[i]:
            if (tuple(gb.shape) != shape[:1] or gb.dtype != dtype
                    or not gb.is_contiguous()):
                raise ValueError("bn_fold: convolution %d: a bias gradient "
                                 "%s %s, expected a contiguous %s [%d]"
                                 % (i, gb.dtype, tuple(gb.shape), dtype,
                                    shape[0]))
            rec["gb"][i] = gb.data_ptr()
    for g in [*g_w, *g_b]:
        if g is not None and g.device != grad.device:
            raise ValueError("bn_fold: a gradient on %s, expected %s"
                             % (g.device, grad.device))
    rec["convs"], rec["chunks"] = table.data_ptr(), chunks.data_ptr()
    rec["inv"], rec["out"] = inv.data_ptr(), grad.data_ptr()
    rec["n_chunks"] = len(plan_.bwd_chunks)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(fn(DTYPES[dtype], rec.ctypes.data, stream),
                    "bn_fold_grad")
    grad_launches += 1


def _fold(plan_, tensors, dtype, keep_inv):
    """The output buffer (and the inv buffer, with `keep_inv`), filled by
    one launch."""
    device = tensors[0].device
    out = torch.empty(plan_.out_total, dtype=dtype, device=device)
    inv = (torch.empty(plan_.inv_total, dtype=torch.float32, device=device)
           if keep_inv else None)
    _launch(plan_, tensors, out, inv)
    return out, inv


def _fold_grad(plan_, g_w, g_b, inv, dtype):
    """The float32 gradient buffer, filled by one launch."""
    grad = torch.empty(plan_.grad_total, dtype=torch.float32,
                       device=inv.device)
    _launch_grad(plan_, g_w, g_b, inv, grad, dtype)
    return grad


class _Fold(torch.autograd.Function):
    """The trainable leaves' outputs of a fold already made, for autograd.
    Inputs: the plan, the dtype, (the output buffer, the inv buffer), then
    the leaves that train, the only tensors autograd tracks, in
    ``plan.trains``' order. Outputs: those leaves' weights and biases,
    views of the buffer, in the same order. The backward is one launch."""

    @staticmethod
    def forward(ctx, plan_, dtype, buffers, *trainable):
        out, inv = buffers
        ctx.plan, ctx.dtype = plan_, dtype
        ctx.save_for_backward(inv)
        return tuple(plan_.outputs(out, plan_.trains))

    @staticmethod
    def backward(ctx, *grads):
        (inv,) = ctx.saved_tensors
        plan_ = ctx.plan
        given = iter(grads)
        grads = [next(given) if m else None for m in plan_.trains]
        with span("cap2det/kernel/bn_fold_grad"):
            grad = _fold_grad(plan_, grads[0::2], grads[1::2], inv,
                              ctx.dtype)
        return (None, None, None) + tuple(
            v for v, m in zip(plan_.gradients(grad), plan_.trains) if m)


def fold(convs, dtype=torch.bfloat16):
    """[(weights, beta, moving_mean, moving_variance)] of convolutions ->
    [(weight, bias)] in `dtype` (bfloat16 or float32), the weight
    channels-last, equal to ``fold_reference``'s bit for bit. For CUDA
    tensors one launch writes them all as views of one fresh buffer, and
    the fold is differentiable in ``weights`` and ``beta`` with one more
    launch in the backward; for CPU tensors ``fold_reference`` runs."""
    if not convs:
        return []
    with span("cap2det/kernel/bn_fold"):
        if convs[0][0].device.type == "cpu":
            return [fold_reference(*conv, dtype) for conv in convs]
        return _fold_kernels(convs, dtype)


def _fold_kernels(convs, dtype):
    tensors = [t for conv in convs for t in conv]
    _check_inputs(tensors, dtype)
    ws, betas = tensors[0::4], tensors[1::4]
    grad_w = [w.requires_grad for w in ws]
    grad_b = [b.requires_grad for b in betas]
    trains = torch.is_grad_enabled() and (any(grad_w) or any(grad_b))
    if trains and any(t.requires_grad for t in tensors[2::4] + tensors[3::4]):
        raise ValueError("bn_fold: the moving statistics are frozen; one "
                         "requires a gradient")
    if not trains:
        grad_w = grad_b = (False,) * len(convs)
    plan_ = plan(ws, grad_w, grad_b)
    with torch.no_grad():
        out, inv = _fold(plan_, tensors, dtype, keep_inv=trains)
    if not trains:
        outputs = plan_.outputs(out)
    else:
        # Frozen convolutions' outputs are plain views, no part of the graph.
        leaves = (t for pair in zip(ws, betas) for t in pair)
        diff = iter(_Fold.apply(plan_, dtype, (out, inv), *[
            t for t, m in zip(leaves, plan_.trains) if m]))
        frozen = iter(plan_.outputs(out, [not m for m in plan_.trains]))
        outputs = [next(diff) if m else next(frozen) for m in plan_.trains]
    return list(zip(outputs[0::2], outputs[1::2]))
