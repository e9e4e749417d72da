"""ROI crop with TF ``crop_and_resize`` semantics, plus a VALID max-pool
(port of ``cap2det_tpu/ops/roi.py``).

This is the plain PyTorch version of the fused ROI kernel
(``kernels/roi_pool.py``, ``csrc/roi_pool.cu``): the CPU path, and the
oracle the kernel is held against on the card. The bilinear crop is two
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
