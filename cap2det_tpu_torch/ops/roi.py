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
# Backward: the plain version of the ROI backward kernel
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


def _grad_chunk(features, boxes, grad, dfeat, crop_size, pool_kernel,
                pool_stride):
    """Adds one chunk of proposals' dF into dfeat [B*H*W, C] float32."""
    batch, height, width, _ = features.shape
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    yi, ya, yb = sample_coords(y1, y2, crop_size, height)  # [B, P, S]
    xi, xa, xb = sample_coords(x1, x2, crop_size, width)
    bi = torch.arange(batch, device=features.device)[:, None, None, None]
    rows = (yi[..., :, None], yi[..., :, None] + 1)
    cols = (xi[..., None, :], xi[..., None, :] + 1)

    def corner(r, c):  # [B, P, S, S, C] float32
        return features[bi, rows[r], cols[c]].float()

    ya4, yb4 = ya[..., :, None, None], yb[..., :, None, None]
    xa4, xb4 = xa[..., None, :, None], xb[..., None, :, None]
    # The kernel's sample: y-lerp at columns x0 and x0+1, then x-lerp.
    t0 = corner(0, 0) * ya4 + corner(1, 0) * yb4
    t1 = corner(0, 1) * ya4 + corner(1, 1) * yb4
    samples = t0 * xa4 + t1 * xb4
    del t0, t1

    # First-tie routing over each window, taps in row-major order.
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
    dsamples = torch.zeros_like(samples)
    for t, v in zip(taps, views):
        hit = (v >= best) & ~taken
        taken |= hit
        dsamples[t] += gf * hit
    del samples, views

    # Scatter through the bilinear weights into dF.
    channels = dfeat.shape[-1]
    for r, wy in ((0, ya4), (1, yb4)):
        dy = dsamples * wy
        for c, wx in ((0, xa4), (1, xb4)):
            flat = (bi * height + rows[r]) * width + cols[c]
            dfeat.index_add_(0, flat.reshape(-1),
                             (dy * wx).reshape(-1, channels))


def crop_resize_maxpool_grad(features, boxes, grad, crop_size, pool_kernel,
                             pool_stride):
    """dF of ``crop_resize_maxpool`` given the pooled gradient
    [B, P, S', S', C], in the features' dtype (accumulated in float32).

    The samples are recomputed per sample, through gathers, with the CUDA
    kernels' expressions (``sample_coords``, the y-lerp then the x-lerp),
    not with the forward's dense interpolation matrices, whose weights can
    differ by an ulp: so this version and the kernel pick each window's
    winner from bitwise-equal values. Chunked over proposals like the
    forward; boxes get no gradient."""
    batch, height, width, channels = features.shape
    dfeat = torch.zeros((batch * height * width, channels),
                        dtype=torch.float32, device=features.device)
    # About ten float32 [S, S, C] intermediates live per proposal.
    per_proposal = 10 * crop_size * crop_size * channels * 4
    chunk = max(1, _CHUNK_BYTES // per_proposal)
    for p in range(0, boxes.shape[1], chunk):
        _grad_chunk(features, boxes[:, p:p + chunk], grad[:, p:p + chunk],
                    dfeat, crop_size, pool_kernel, pool_stride)
    return dfeat.reshape(features.shape).to(features.dtype)
