"""The fused flat optimizer update (the port's counterpart of
``cap2det_tpu/train/optimizers.py`` ``_fused_flat_transform`` followed by
``optax.apply_updates``, the JAX package's default update).

``fused_update`` launches ``csrc/fused_optimizer.cu`` for CUDA tensors:
one multi-tensor launch over every trainable leaf (two with per-leaf
clipping; as many more per ``MAX_LEAVES`` leaves), which scales each
float32 gradient by its multiplier, clips it by its own norm, runs the
rule with the slots held in one flat float32 buffer per slot name, and
adds the step to the param in place. For CPU tensors it runs
``fused_update_reference``, JAX's flat formulation written in torch,
which is also the kernel's oracle on the card. On a CUDA tensor it
launches the kernel or raises; it never falls back.

A ``LeafSet`` describes the trainable leaves once: their paths, shapes,
offsets into the flat slot buffers, multipliers, and the chunk table the
kernel's blocks walk (no chunk crosses a leaf), uploaded once per device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.utils.spans import span

KINDS = {"sgd": 0, "adagrad": 1, "adam": 2, "rmsprop": 3, "momentum": 4}
# Each kind's slots, by name, at their place in the kernel's slot array.
SLOT_PLACES = {"sgd": {}, "adagrad": {"sum_of_squares": 0},
               "adam": {"mu": 0, "nu": 1},
               "rmsprop": {"nu": 0, "mu": 1, "trace": 2},
               "momentum": {"trace": 0}}
MAX_LEAVES = 64  # leaves per launch (kMaxLeaves in the source)
CHUNK = 8192  # elements per block at most

# Args::options and Leaf::flags of the source.
CENTERED, TRACE, NESTEROV = 1, 2, 4
GRAD_CHANNELS_LAST = 1

# The kernel's parameter structs, as numpy records (the C entry copies an
# Args from host memory into the launch).
LEAF_DTYPE = np.dtype([
    ("g", "<u8"), ("p", "<u8"), ("slot_offset", "<i8"),
    ("multiplier", "<f4"), ("flags", "<i4"), ("channels", "<i4"),
    ("spatial", "<i4"), ("first_chunk", "<i4"), ("n_chunks", "<i4")],
    align=True)
ARGS_DTYPE = np.dtype([
    ("leaf", LEAF_DTYPE, (MAX_LEAVES,)), ("chunks", "<u8"),
    ("partials", "<u8"), ("slot", "<u8", (3,)), ("neg_lr", "<f4"),
    ("c", "<f4", (7,)), ("clip_norm", "<f4"), ("options", "<i4"),
    ("clip", "<i4"), ("n_chunks", "<i4")], align=True)

# Kernel launches: one per leaf group and update, and one more for the
# chunk sums of a clipped update.
launches = 0

_layout_checked = False


def update_bytes(n_slots, numel, grad_bytes=4):
    """Bytes the update must move: the gradient read once, the float32
    param and each float32 slot read and written once. Clipping moves no
    more by this count: each input is counted once."""
    return (grad_bytes + 8 + 8 * n_slots) * numel


# Operations per element of each rule, the step's product by -lr and
# the param's add included (counted from ``BaseRule.update``).
_RULE_FLOPS = {"sgd": 2, "adagrad": 7, "adam": 14, "rmsprop": 9,
               "momentum": 4}


def update_flops(rule, leaf_set, clip):
    """Floating-point operations of the update's function: the rule's per
    element (rmsprop +5 centered, +2 with momentum; nesterov +2), one
    product per element of a leaf whose multiplier is not 1, and with
    clipping a square and an add for the norm and the factor's product
    per element."""
    per = _RULE_FLOPS[rule.which]
    c = rule.config
    if rule.which == "rmsprop":
        per += 5 * bool(c.centered) + 2 * (c.momentum > 0)
    elif rule.which == "momentum":
        per += 2 * bool(c.use_nesterov)
    scaled = sum(n for n, m in zip(leaf_set.numels, leaf_set.multipliers)
                 if m != 1.0)
    return per * leaf_set.total + scaled + 3 * clip * leaf_set.total


def ulp_gap(got, want):
    """The largest |got - want| in units of the float32 spacing at `want`'s
    largest magnitude (one ulp of the leaf's scale): 0.0 exactly when the
    two are equal bit for bit."""
    if torch.equal(got, want):
        return 0.0
    scale = np.float32(want.detach().abs().max().item())
    diff = (got.detach().double() - want.detach().double()).abs().max()
    return float(diff.item()) / float(np.spacing(scale))


class LeafSet:
    """The trainable leaves in order: paths, shapes, element counts, their
    offsets into the flat slot buffers (``total`` elements), multipliers,
    and the launch groups of at most MAX_LEAVES leaves with their chunk
    tables."""

    def __init__(self, paths, shapes, multipliers):
        self.paths = list(paths)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.numels = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        if any(n >= 2 ** 31 for n in self.numels):
            raise ValueError("a leaf of 2^31 elements or more")
        self.offsets = [int(o) for o in np.cumsum([0] + self.numels[:-1])]
        self.total = sum(self.numels)
        self.multipliers = [float(m) for m in multipliers]
        # Each group: (first leaf, leaf count, [n, 4] int32 chunk table,
        # first chunk and chunk count per leaf).
        self.groups = []
        for lo in range(0, len(self.paths), MAX_LEAVES):
            hi = min(lo + MAX_LEAVES, len(self.paths))
            table, spans = [], []
            for local, n in enumerate(self.numels[lo:hi]):
                spans.append((len(table), -(-n // CHUNK)))
                table.extend((local, s, min(CHUNK, n - s), 0)
                             for s in range(0, n, CHUNK))
            self.groups.append((lo, hi - lo,
                                np.asarray(table, np.int32).reshape(-1, 4),
                                spans))
        self._records = {}  # device -> [(record, chunks, partials)] per group

    def records(self, device):
        """Per group: its Args record with the static fields filled, and
        its chunk table and chunk sums on `device` (made at first use)."""
        if device not in self._records:
            out = []
            for lo, count, table, spans in self.groups:
                rec = np.zeros((), ARGS_DTYPE)
                leaf = rec["leaf"]
                leaf["slot_offset"][:count] = self.offsets[lo:lo + count]
                leaf["multiplier"][:count] = self.multipliers[lo:lo + count]
                leaf["first_chunk"][:count] = [s[0] for s in spans]
                leaf["n_chunks"][:count] = [s[1] for s in spans]
                chunks = torch.from_numpy(table).to(device)
                partials = torch.empty(max(len(table), 1),
                                       dtype=torch.float64, device=device)
                rec["chunks"] = chunks.data_ptr()
                rec["partials"] = partials.data_ptr()
                rec["n_chunks"] = len(table)
                out.append((rec, chunks, partials))
            self._records[device] = out
        return self._records[device]


def _scaled_clipped(g, mult, clip_norm):
    """One leaf's float32 gradient, times its multiplier, clipped by its
    own norm, in train/optimizers.py ``Optimizer.apply``'s order."""
    g = g.float()
    if mult != 1.0:
        g = g * mult
    if clip_norm is not None:
        norm = torch.sqrt(torch.sum(torch.square(g)))
        g = g * torch.clamp(clip_norm / torch.clamp_min(norm, 1e-12),
                            max=1.0)
    return g


def fused_update_reference(rule, leaf_set, params, grads, slots, lr, count,
                           clip_norm):
    """The plain version: the scaled and clipped float32 gradients
    concatenated, `rule` (``train/optimizers.BaseRule``) over the flat
    vector with the flat slot buffers `slots` ({name: [total] float32},
    updated in place), and the step's slices added to the params in
    place."""
    if not params:
        return
    parts = [_scaled_clipped(g, m, clip_norm).reshape(-1)
             for g, m in zip(grads, leaf_set.multipliers)]
    flat_g = torch.cat(parts) if len(parts) > 1 else parts[0]
    new = dict(slots)
    u = rule.update(flat_g, new, lr, count)
    for name, flat in slots.items():
        flat.copy_(new[name])
    for p, off, n in zip(params, leaf_set.offsets, leaf_set.numels):
        p.add_(u[off:off + n].view(p.shape).to(p.dtype))


def _constants(rule, lr, count):
    """(neg_lr, c[7], options) of the source, from the rule's Python
    values rounded to float32 as PyTorch rounds a Python scalar."""
    c = [0.0] * 7
    options = 0
    cfg = rule.config
    if rule.which == "adagrad":
        c[0] = 1e-7
    elif rule.which == "adam":
        c[:7] = [1 - cfg.beta1, cfg.beta1, 1 - cfg.beta2, cfg.beta2,
                 1 - cfg.beta1 ** (count + 1), 1 - cfg.beta2 ** (count + 1),
                 cfg.epsilon]
    elif rule.which == "rmsprop":
        c[:4] = [1 - cfg.decay, cfg.decay, cfg.epsilon, cfg.momentum]
        options = (CENTERED if cfg.centered else 0) | (
            TRACE if cfg.momentum > 0 else 0)
    elif rule.which == "momentum":
        c[0] = cfg.momentum
        options = NESTEROV if cfg.use_nesterov else 0
    return np.float32(-lr), np.asarray(c, np.float32), options


def _check_layout():
    global _layout_checked
    if _layout_checked:
        return
    fn = build.function("cap2det_fused_optimizer_layout",
                        [ctypes.c_void_p, ctypes.c_int])
    got = np.zeros(32, np.int64)
    n = fn(got.ctypes.data, len(got))
    leaf_offsets = [LEAF_DTYPE.fields[k][1] for k in LEAF_DTYPE.names]
    args_offsets = [ARGS_DTYPE.fields[k][1] for k in ARGS_DTYPE.names[1:]]
    want = ([LEAF_DTYPE.itemsize, ARGS_DTYPE.itemsize, MAX_LEAVES]
            + leaf_offsets + args_offsets)
    if got[:n].tolist() != want:
        raise RuntimeError("fused_optimizer: the host's Args layout %s is "
                           "not the kernel's %s" % (want, got[:n].tolist()))
    _layout_checked = True


def _grad_flags(path, g, shape):
    """(flags, channels, spatial) of a gradient the kernel takes; raises
    on any other."""
    if tuple(g.shape) != shape:
        raise ValueError("fused_optimizer: gradient of %s is %s, the leaf "
                         "is %s" % (path, tuple(g.shape), shape))
    if g.dtype != torch.float32:
        raise TypeError("fused_optimizer: gradient of %s is %s, not float32"
                        % (path, g.dtype))
    if g.is_contiguous():
        return 0, 0, 0
    if g.dim() == 4 and g.is_contiguous(memory_format=torch.channels_last):
        return GRAD_CHANNELS_LAST, shape[1], shape[2] * shape[3]
    raise ValueError("fused_optimizer: gradient of %s is neither contiguous "
                     "nor channels-last (strides %s)" % (path, g.stride()))


def _launch(rule, leaf_set, params, grads, slots, lr, count, clip_norm):
    global launches
    device = params[0].device
    for name, flat in slots.items():
        if (flat.device != device or flat.dtype != torch.float32
                or not flat.is_contiguous() or flat.numel() != leaf_set.total):
            raise ValueError("fused_optimizer: slot %r must be a contiguous "
                             "float32 [%d] on %s, got %s %s on %s"
                             % (name, leaf_set.total, device, flat.dtype,
                                tuple(flat.shape), flat.device))
    g_ptr, p_ptr, flags = [], [], []
    for path, shape, p, g in zip(leaf_set.paths, leaf_set.shapes, params,
                                 grads):
        if p.device != device or g.device != device:
            raise ValueError("fused_optimizer: %s: param on %s, gradient on "
                             "%s, expected %s" % (path, p.device, g.device,
                                                  device))
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise TypeError("fused_optimizer: param %s must be a contiguous "
                            "float32 tensor, got %s" % (path, p.dtype))
        if tuple(p.shape) != shape:
            raise ValueError("fused_optimizer: param %s is %s, the leaf set "
                             "has %s" % (path, tuple(p.shape), shape))
        flags.append(_grad_flags(path, g, shape))
        g_ptr.append(g.data_ptr())
        p_ptr.append(p.data_ptr())
    _check_layout()
    fn = build.function("cap2det_fused_optimizer",
                        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    neg_lr, c, options = _constants(rule, lr, count)
    places = SLOT_PLACES[rule.which]
    slot_ptrs = [0, 0, 0]
    for name, flat in slots.items():
        slot_ptrs[places[name]] = flat.data_ptr()
    kind = KINDS[rule.which]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for (lo, n, table, _), (rec, _, _) in zip(leaf_set.groups,
                                                 leaf_set.records(device)):
            if not len(table):
                continue
            leaf = rec["leaf"]
            leaf["g"][:n] = g_ptr[lo:lo + n]
            leaf["p"][:n] = p_ptr[lo:lo + n]
            leaf["flags"][:n], leaf["channels"][:n], leaf["spatial"][:n] = (
                zip(*flags[lo:lo + n]))
            rec["slot"] = slot_ptrs
            rec["neg_lr"], rec["c"], rec["options"] = neg_lr, c, options
            rec["clip"] = clip_norm is not None
            rec["clip_norm"] = clip_norm if clip_norm is not None else 0.0
            build.check(fn(kind, rec.ctypes.data, stream), "fused_optimizer")
            launches += 1 + (clip_norm is not None)


def fused_update(rule, leaf_set, params, grads, slots, lr, count,
                 clip_norm=None):
    """params[i] += the update of grads[i], in place, for the leaves of
    `leaf_set` in order, with `rule` (``train/optimizers.BaseRule``), its
    flat slot buffers `slots` ({name: [total] float32}, updated in place),
    the learning rate `lr` and the update count `count` (0 on the first
    update). The kernel for CUDA tensors, the plain version for CPU ones.
    """
    if not params:
        return
    with span("cap2det/kernel/fused_optimizer"):
        if all(t.device.type == "cpu"
               for t in [*params, *grads, *slots.values()]):
            fused_update_reference(rule, leaf_set, params, grads, slots, lr,
                                   count, clip_norm)
            return
        _launch(rule, leaf_set, params, grads, slots, lr, count, clip_norm)
