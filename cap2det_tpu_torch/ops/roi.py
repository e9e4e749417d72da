"""ROI crop with TF ``crop_and_resize`` semantics, plus a VALID max-pool
(port of ``cap2det_tpu/ops/roi.py``).

This is the plain PyTorch version of the fused ROI kernels
(``kernels/roi_pool.py``; ``csrc/roi_pool.cu`` forward,
``csrc/roi_pool_bwd.cu`` backward): the CPU path, and the oracle the
kernels are held against on the card. The forward's bilinear crop is two
products with sparse interpolation-weight matrices:

    tmp[p,i,w,c] = sum_h W_y[p,i,h] * F[h,w,c]
    out[p,i,j,c] = sum_w W_x[p,j,w] * tmp[p,i,w,c]

with W_y[p,i,h] = relu(1 - |in_y(p,i) - h|), zero outside the map. It runs
in float32 whatever the features' dtype, as the kernel does, and casts
the pooled result back. The [P, S, W, C] intermediate is large (7.4 GB
for P=2000 on a 76x114x576 map), so the proposals go through in chunks
that bound it.
"""

from __future__ import annotations

import torch

# Bytes of the float32 [chunk, S, W, C] intermediate per chunk.
_CHUNK_BYTES = 256 * 1024 * 1024


def interpolation_weights(starts, ends, crop_size, image_size):
    """[..., S, H] bilinear sampling weights; sample points outside
    [0, H-1] get all-zero rows (TF extrapolation_value=0)."""
    h_max = image_size - 1
    if crop_size > 1:
        i = torch.arange(crop_size, dtype=torch.float32, device=starts.device)
        # A tensor divisor: CUDA turns division by a Python scalar into a
        # reciprocal multiply, one ulp off, which moves samples of boxes
        # ending at exactly 1.0 off the map's edge.
        steps = torch.tensor(float(crop_size - 1), device=starts.device)
        coords = (
            starts[..., None] * h_max
            + i * (ends[..., None] - starts[..., None]) * h_max / steps
        )
    else:
        coords = ((starts + ends) * 0.5 * h_max)[..., None]
    grid = torch.arange(image_size, dtype=torch.float32, device=starts.device)
    weights = torch.relu(1.0 - torch.abs(coords[..., None] - grid))
    inside = (coords >= 0.0) & (coords <= h_max)
    return weights * inside[..., None].to(weights.dtype)


def crop_and_resize(features, boxes, crop_size):
    """[B, H, W, C] features, [B, P, 4] boxes -> [B, P, S, S, C] float32."""
    _, height, width, _ = features.shape
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    wy = interpolation_weights(y1, y2, crop_size, height)  # [B, P, S, H]
    wx = interpolation_weights(x1, x2, crop_size, width)  # [B, P, S, W]
    f = features.float()
    tmp = torch.einsum("bpih,bhwc->bpiwc", wy, f)
    return torch.einsum("bpjw,bpiwc->bpijc", wx, tmp)


def max_pool_2d(x, kernel, stride):
    """VALID max pool over the two spatial dims of [..., H, W, C]."""
    h, w = x.shape[-3:-1]
    out_h = (h - kernel) // stride + 1
    out_w = (w - kernel) // stride + 1
    acc = None
    for i in range(kernel):
        for j in range(kernel):
            view = x[..., i:i + (out_h - 1) * stride + 1:stride,
                     j:j + (out_w - 1) * stride + 1:stride, :]
            acc = view if acc is None else torch.maximum(acc, view)
    return acc


def crop_resize_maxpool(features, boxes, crop_size, pool_kernel, pool_stride):
    """Fused crop_and_resize + max-pool, chunked over proposals.

    Returns [B, P, S', S', C] in the features' dtype, with
    S' = (S - pool_kernel)//pool_stride + 1.
    """
    _, _, width, channels = features.shape
    per_proposal = crop_size * width * channels * 4
    chunk = max(1, _CHUNK_BYTES // per_proposal)
    outs = [
        max_pool_2d(
            crop_and_resize(features, boxes[:, p:p + chunk], crop_size),
            pool_kernel, pool_stride,
        )
        for p in range(0, boxes.shape[1], chunk)
    ]
    return torch.cat(outs, dim=1).to(features.dtype)


# ---------------------------------------------------------------------------
# The kernels' own arithmetic: exact oracles, and the plain backward
# ---------------------------------------------------------------------------


def sample_coords(starts, ends, crop_size, extent):
    """Per-sample (floor index [..., S] int64, weight of idx, weight of
    idx+1) with the kernels' arithmetic (``csrc/roi_common.cuh``): every
    operation rounded on its own, the divisor a tensor (true division)."""
    h_max = float(extent - 1)
    if crop_size > 1:
        i = torch.arange(crop_size, dtype=torch.float32, device=starts.device)
        step = i * (ends - starts)[..., None]
        step = step * h_max / torch.tensor(float(crop_size - 1),
                                           device=starts.device)
        coords = starts[..., None] * h_max + step
    else:
        coords = ((starts + ends) * 0.5 * h_max)[..., None]
    inside = ((coords >= 0.0) & (coords <= h_max)).float()
    idx = torch.clamp(torch.floor(coords), 0.0, float(extent - 2))
    frac = (coords - idx) * inside
    return idx.long(), (1.0 - frac) * inside, frac * inside


def _sample_grid(features, boxes, crop_size):
    """The batch index, the two rows and two columns of every sample and
    their weights, broadcastable over [B, P, S, S, C]."""
    batch, height, width, _ = features.shape
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    yi, ya, yb = sample_coords(y1, y2, crop_size, height)  # [B, P, S]
    xi, xa, xb = sample_coords(x1, x2, crop_size, width)
    bi = torch.arange(batch, device=features.device)[:, None, None, None]
    rows = (yi[..., :, None], yi[..., :, None] + 1)
    cols = (xi[..., None, :], xi[..., None, :] + 1)
    wy = (ya[..., :, None, None], yb[..., :, None, None])
    wx = (xa[..., None, :, None], xb[..., None, :, None])
    return bi, rows, cols, wy, wx


def crop_samples(features, boxes, crop_size):
    """[B, P, S, S, C] float32 crop samples computed exactly as the CUDA
    kernels compute them: ``sample_coords``, the y-lerp of the two rows at
    columns x0 and x0+1, then the x-lerp, each operation rounded on its
    own (PyTorch runs each as a kernel of its own, so nothing is
    contracted into an FMA)."""
    bi, rows, cols, wy, wx = _sample_grid(features, boxes, crop_size)

    def corner(r, c):
        return features[bi, rows[r], cols[c]].float()

    t0 = corner(0, 0) * wy[0] + corner(1, 0) * wy[1]
    t1 = corner(0, 1) * wy[0] + corner(1, 1) * wy[1]
    return t0 * wx[0] + t1 * wx[1]


def crop_resize_maxpool_exact(features, boxes, crop_size, pool_kernel,
                              pool_stride):
    """``crop_resize_maxpool`` with the kernels' sample arithmetic
    (``crop_samples``), chunked over proposals: the CUDA forward (K1)
    equals it bit for bit, in float32 and bfloat16. Returns
    [B, P, S', S', C] in the features' dtype."""
    # About six float32 [S, S, C] intermediates live per proposal.
    channels = features.shape[-1]
    chunk = max(1, _CHUNK_BYTES // (6 * crop_size * crop_size * channels * 4))
    outs = [
        max_pool_2d(crop_samples(features, boxes[:, p:p + chunk], crop_size),
                    pool_kernel, pool_stride)
        for p in range(0, boxes.shape[1], chunk)
    ]
    return torch.cat(outs, dim=1).to(features.dtype)


# 64-bit fixed point of the CUDA backward: units of 2^-32.
FIXED_SCALE = 2.0 ** 32


def _winners(features, boxes, grad, crop_size, pool_kernel, pool_stride):
    """The pool's taps, as indices into [B, P, S, S, C], and per tap the
    float32 gradient of the cells whose winner it is (0 elsewhere): the
    first maximal crop sample of each window, taps in row-major order."""
    samples = crop_samples(features, boxes, crop_size)
    pooled = grad.shape[2]
    span = (pooled - 1) * pool_stride + 1
    taps = [(..., slice(i, i + span, pool_stride),
             slice(j, j + span, pool_stride), slice(None))
            for i in range(pool_kernel) for j in range(pool_kernel)]
    views = [samples[t] for t in taps]
    best = views[0]
    for v in views[1:]:
        best = torch.maximum(best, v)
    gf = grad.float()
    taken = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    g_taps = []
    for v in views:
        hit = (v >= best) & ~taken
        taken |= hit
        g_taps.append(gf * hit)
    return taps, g_taps


def _fixed_contributions(features, boxes, grad, crop_size, pool_kernel,
                         pool_stride):
    """Yields (r, ti, c, tj, v) per tap (rows ti, columns tj of the crop)
    and winner corner (r, c in {0, 1}): v = (g * wy) * wx [B, P, S', S', C],
    the CUDA backward's contributions, each quantised on its own (where
    windows overlap, a sample's contributions are not pre-summed)."""
    _, _, _, wy, wx = _sample_grid(features, boxes, crop_size)
    taps, g_taps = _winners(features, boxes, grad, crop_size, pool_kernel,
                            pool_stride)
    for (_, ti, tj, _), g_tap in zip(taps, g_taps):
        for r in (0, 1):
            dy = g_tap * wy[r][..., ti, :, :]
            for c in (0, 1):
                yield r, ti, c, tj, dy * wx[c][..., tj, :]


def _grad_chunk(features, boxes, grad, dfeat, crop_size, pool_kernel,
                pool_stride):
    """Adds one chunk of proposals' dF into dfeat [B*H*W, C]: float32 sums,
    or, when dfeat is int64, the kernel's fixed-point contributions."""
    _, height, width, _ = features.shape
    bi, rows, cols, wy, wx = _sample_grid(features, boxes, crop_size)
    channels = dfeat.shape[-1]
    if dfeat.dtype == torch.int64:
        for r, ti, c, tj, v in _fixed_contributions(
                features, boxes, grad, crop_size, pool_kernel, pool_stride):
            q = torch.round(v * FIXED_SCALE).long()
            flat = ((bi * height + rows[r][..., ti, :]) * width
                    + cols[c][..., tj])
            dfeat.index_add_(0, flat.expand(v.shape[:-1]).reshape(-1),
                             q.reshape(-1, channels))
        return

    taps, g_taps = _winners(features, boxes, grad, crop_size, pool_kernel,
                            pool_stride)
    dsamples = torch.zeros(tuple(grad.shape[:2]) + (crop_size, crop_size,
                                                    channels),
                           dtype=torch.float32, device=features.device)
    for t, g_tap in zip(taps, g_taps):
        dsamples[t] += g_tap
    # Scatter through the bilinear weights into dF.
    for r in (0, 1):
        dy = dsamples * wy[r]
        for c in (0, 1):
            flat = (bi * height + rows[r]) * width + cols[c]
            dfeat.index_add_(0, flat.expand(dy.shape[:-1]).reshape(-1),
                             (dy * wx[c]).reshape(-1, channels))


def crop_resize_maxpool_grad(features, boxes, grad, crop_size, pool_kernel,
                             pool_stride, fixed_point=False):
    """dF of ``crop_resize_maxpool`` given the pooled gradient
    [B, P, S', S', C], in the features' dtype.

    The samples are recomputed per sample, through gathers, with the CUDA
    kernels' expressions (``crop_samples``), not with the forward's dense
    interpolation matrices, whose weights can differ by an ulp: so this
    version and the kernel pick each window's winner from bitwise-equal
    values. By default the contributions are summed in float32 with
    ``index_add_`` (the CPU path). With ``fixed_point`` each contribution
    v = (g * wy) * wx becomes round_half_even(v * 2^32) in int64, summed
    exactly, then converted once (times 2^-32 to float32, then to the
    features' dtype): the CUDA backward (K2) equals that bit for bit, and it
    does not depend on the order of the proposals. Chunked over proposals
    like the forward; boxes get no gradient."""
    batch, height, width, channels = features.shape
    dfeat = torch.zeros((batch * height * width, channels),
                        dtype=torch.int64 if fixed_point else torch.float32,
                        device=features.device)
    for p in _grad_chunks(boxes.shape[1], crop_size, channels):
        _grad_chunk(features, boxes[:, p], grad[:, p], dfeat, crop_size,
                    pool_kernel, pool_stride)
    if fixed_point:
        dfeat = dfeat.to(torch.float32) * (1.0 / FIXED_SCALE)
    return dfeat.reshape(features.shape).to(features.dtype)


def _grad_chunks(num_p, crop_size, channels):
    """Slices of the proposals, each small enough that the backward's
    about ten float32 [S, S, C] intermediates per proposal fit a chunk."""
    per_proposal = 10 * crop_size * crop_size * channels * 4
    chunk = max(1, _CHUNK_BYTES // per_proposal)
    return [slice(p, p + chunk) for p in range(0, num_p, chunk)]


def _footprint_slots(idx):
    """For per-sample floor indices [..., S]: the slot of each idx in the
    ascending set of {idx, idx + 1} over the samples (a proposal's row or
    column set, as the CUDA kernels build it), and the set's size."""
    ordered = torch.cat([idx, idx + 1], -1).sort(-1).values
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[..., 1:] = ordered[..., 1:] != ordered[..., :-1]
    slot = ((ordered[..., None, :] < idx[..., :, None])
            & first[..., None, :]).sum(-1)
    return slot, first.sum(-1)


def crop_resize_maxpool_grad_atomics(features, boxes, grad, crop_size,
                                     pool_kernel, pool_stride, local_slots):
    """Global int64 atomics of the CUDA backward (K2) on these inputs,
    counted from its fixed-point contributions (no kernel runs):
    {"contributions": the nonzero contributions, one atomic each when added
    straight to dF, "atomics": the atomics when every proposal whose
    footprint |R| x |C| holds at most `local_slots` positions first sums
    its contributions per (position, channel) and then issues one atomic per
    nonzero sum}."""
    _, height, width, channels = features.shape
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    contributions = atomics = 0
    for p in _grad_chunks(boxes.shape[1], crop_size, channels):
        slot_y, n_y = _footprint_slots(
            sample_coords(y1[:, p], y2[:, p], crop_size, height)[0])
        slot_x, n_x = _footprint_slots(
            sample_coords(x1[:, p], x2[:, p], crop_size, width)[0])
        local = (n_y * n_x <= local_slots)[..., None, None, None]
        acc = torch.zeros(tuple(n_y.shape) + (max(local_slots, 1), channels),
                          dtype=torch.int64, device=features.device)
        for r, ti, c, tj, v in _fixed_contributions(
                features, boxes[:, p], grad[:, p], crop_size, pool_kernel,
                pool_stride):
            nonzero = v != 0
            contributions += int(nonzero.sum())
            atomics += int((nonzero & ~local).sum())
            q = torch.round(v * FIXED_SCALE).long() * local
            slot = ((slot_y[..., ti, None] + r) * n_x[..., None, None]
                    + slot_x[..., None, tj] + c)
            slot = torch.clamp(slot, max=acc.shape[2] - 1)
            acc.scatter_add_(2, slot.flatten(2)[..., None].expand(
                -1, -1, -1, channels), q.flatten(2, 3))
        atomics += int((acc != 0).sum())
    return {"contributions": contributions, "atomics": atomics}
