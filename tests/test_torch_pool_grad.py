"""Plain versions of the port's SAME pool backward kernels (K5 max, K6
avg) against the JAX package: ``maxpool_grad_reference`` and the Pallas
kernels in interpret mode, which route max-pool ties first-tie as the port
does. Also the autograd Function (K4 forward, K5/K6 backward) on the CPU,
the order of K6's float32 sums that its kernel copies, and the host's rule
for the tiled and untiled kernels.

Tie-rich inputs are quantised to {0, 1, 2}. Against the reference the
max-pool gradient moves whole values in the same order (exact); the
Pallas kernels sum overlapping windows in another order, row by row
(rtol 1e-6).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.kernels import pool_grad as jax_pool_grad
from cap2det_tpu_torch.kernels import build, pool_grad, roi_pool

torch.set_num_threads(1)

SHAPES = [((3, 7, 7, 5), 3, 2), ((2, 4, 4, 6), 3, 1), ((2, 5, 9, 3), 3, 2),
          ((2, 6, 8, 3), 2, 2)]
IDS = ["7x7_s2", "4x4_s1", "odd_5x9_s2", "even_kernel"]


def _case(shape, stride, seed, quantised=True):
    rng = np.random.default_rng(seed)
    if quantised:
        x = rng.integers(0, 3, shape).astype(np.float32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
    n, h, w, c = shape
    g = rng.normal(size=(n, -(-h // stride), -(-w // stride), c)).astype(
        np.float32)
    return x, g


@pytest.mark.parametrize("shape,k,s", SHAPES, ids=IDS)
def test_plain_maxpool_grad_matches_first_tie_reference(shape, k, s):
    x, g = _case(shape, s, 0)
    want = np.asarray(jax_pool_grad.maxpool_grad_reference(
        jnp.asarray(x), jnp.asarray(g), k, s))
    got = pool_grad.maxpool_grad(torch.from_numpy(x), torch.from_numpy(g),
                                 k, s).numpy()
    np.testing.assert_array_equal(got, want)
    # Every window's gradient lands exactly once.
    np.testing.assert_allclose(got.sum(), g.sum(), rtol=1e-4)


@pytest.mark.parametrize("shape,k,s", SHAPES[:3], ids=IDS[:3])
def test_plain_maxpool_grad_matches_pallas_interpret(shape, k, s):
    x, g = _case(shape, s, 1)
    want = np.asarray(jax_pool_grad.maxpool_grad(
        jnp.asarray(x), jnp.asarray(g), k, s, interpret=True))
    got = pool_grad.maxpool_grad(torch.from_numpy(x), torch.from_numpy(g),
                                 k, s).numpy()
    # Same winners; the kernel's hierarchical form sums a row's windows
    # before the rows, so overlapping windows add in another order.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,k,s", SHAPES[:3], ids=IDS[:3])
def test_plain_avgpool_grad_matches_pallas_interpret(shape, k, s):
    _, g = _case(shape, s, 2)
    want = np.asarray(jax_pool_grad.avgpool_grad(
        shape, jnp.float32, jnp.asarray(g), k, s, interpret=True))
    got = pool_grad.avgpool_grad(shape, torch.float32, torch.from_numpy(g),
                                 k, s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize("shape,k,s", SHAPES, ids=IDS)
def test_function_backward_is_the_plain_version(kind, shape, k, s):
    x, g = _case(shape, s, 3, quantised=kind == "pool_max")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pool_grad.pool_same(xt, kind, k, s)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        pool_grad.pool_same_plain(torch.from_numpy(x), kind, k, s).numpy())
    # A non-contiguous upstream gradient, as a concat's backward gives.
    g_wide = torch.from_numpy(np.concatenate([g, g], axis=-1))
    (dx,) = torch.autograd.grad(out, xt, g_wide[..., :shape[-1]])
    if kind == "pool_max":
        want = pool_grad.maxpool_grad_plain(torch.from_numpy(x),
                                            torch.from_numpy(g), k, s)
    else:
        want = pool_grad.avgpool_grad_plain(shape, torch.float32,
                                            torch.from_numpy(g), k, s)
    assert torch.equal(dx, want)


def _avgpool_grad_by_pixel(x_shape, g, kernel, stride):
    """dx of the SAME avg pool in float32, pixel by pixel: g / count of each
    window containing the pixel, added from 0 in descending (oy, ox)."""
    n, h, w, c = x_shape
    out_h, pad_t, _ = pool_grad.same_pads(h, kernel, stride)
    out_w, pad_l, _ = pool_grad.same_pads(w, kernel, stride)

    def span(o, pad, size):
        lo = o * stride - pad
        return max(lo, 0), min(lo + kernel, size)

    dx = np.zeros((n, h, w, c), np.float32)
    for iy in range(h):
        for ix in range(w):
            acc = np.zeros((n, c), np.float32)
            for oy in reversed(range(out_h)):
                y_lo, y_hi = span(oy, pad_t, h)
                if not y_lo <= iy < y_hi:
                    continue
                for ox in reversed(range(out_w)):
                    x_lo, x_hi = span(ox, pad_l, w)
                    if not x_lo <= ix < x_hi:
                        continue
                    count = np.float32((y_hi - y_lo) * (x_hi - x_lo))
                    acc = acc + g[:, oy, ox] / count
            dx[:, iy, ix] = acc
    return dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,k,s", [
    ((3, 4, 4, 40), 3, 1), ((2, 7, 7, 24), 3, 2), ((3, 5, 9, 20), 3, 2),
    ((4, 6, 8, 7), 2, 2)], ids=["4x4_s1", "7x7_s2", "odd_5x9_s2",
                                "even_kernel"])
def test_plain_avgpool_grad_adds_windows_in_descending_order(dtype, shape, k,
                                                             s):
    """The plain K6 equals, bit for bit, float32 sums that walk each
    pixel's windows in descending (oy, ox) from 0, rounded once to the
    dtype: the order and arithmetic the kernel copies."""
    _, g = _case(shape, s, 6, quantised=False)
    gt = torch.from_numpy(g).to(dtype)
    want = torch.from_numpy(_avgpool_grad_by_pixel(
        shape, gt.float().numpy(), k, s)).to(dtype)
    got = pool_grad.avgpool_grad_plain(shape, dtype, gt, k, s)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize("shape,k,s", [((1000, 7, 7, 576), 3, 2),
                                       ((1000, 4, 4, 1024), 3, 1)],
                         ids=["mixed5a", "mixed5bc"])
def test_model_shapes_take_the_tiled_kernels(dtype, kind, shape, k, s):
    assert pool_grad._tiling(shape[-1], dtype) == (
        True, 64 if dtype == torch.bfloat16 else 32)
    assert pool_grad._tiled(shape, dtype, k, s, kind)


@pytest.mark.parametrize("shape,k,s,kind,tiled", [
    ((2, 40, 40, 64), 3, 2, "pool_max", False),
    ((2, 40, 40, 64), 3, 2, "pool_avg", False),
    ((2, 4, 4, 8), 17, 1, "pool_max", False),
    ((2, 4, 4, 8), 17, 1, "pool_avg", True),
    ((2, 4, 4, 8), 16, 1, "pool_max", True),
], ids=["k5_large_map", "k6_large_map", "k5_kernel17", "k6_kernel17",
        "k5_kernel16"])
def test_untiled_kernels_take_what_the_tiled_cannot(shape, k, s, kind,
                                                    tiled):
    """Maps whose tile exceeds the shared-memory budget, and max kernels
    whose tap index would not fit a byte, run the untiled kernel."""
    assert pool_grad._tiled(shape, torch.float32, k, s, kind) == tiled


@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, (False, 32)),
    (torch.float32, True, (True, 32)),
    (torch.float32, False, (False, 32)),
], ids=["bf16_40_bytes", "f32_80_bytes", "f32_misaligned"])
def test_ragged_or_misaligned_rows_take_one_channel_per_lane(dtype, aligned,
                                                             want):
    """C = 20: 40 bytes a row in bf16 (not a multiple of 16) take the
    scalar path; 80 in float32 take 16-byte lanes unless a pointer is
    misaligned. Either way the tiled kernel runs at 4x4."""
    assert pool_grad._tiling(20, dtype, aligned) == want
    for kind in ("pool_max", "pool_avg"):
        assert pool_grad._tiled((5, 4, 4, 20), dtype, 3, 1, kind, aligned)


def test_plain_bf16_rounds_the_f32_result():
    x, g = _case((2, 7, 7, 4), 2, 4, quantised=False)
    xb = torch.from_numpy(x).bfloat16()
    gb = torch.from_numpy(g).bfloat16()
    got = pool_grad.maxpool_grad(xb, gb, 3, 2)
    assert got.dtype == torch.bfloat16
    want = pool_grad.maxpool_grad(xb.float(), gb.float(), 3, 2).bfloat16()
    assert torch.equal(got, want)
    got = pool_grad.avgpool_grad(x.shape, torch.bfloat16, gb, 3, 2)
    assert got.dtype == torch.bfloat16


def _c_params(source, name):
    """Parameter count of `extern "C" int name(...)` in a csrc file."""
    text = (pathlib.Path(build.CSRC) / source).read_text()
    match = re.search(r'extern "C" int %s\(([^)]*)\)' % name, text)
    assert match, name
    return len(match.group(1).split(","))


@pytest.mark.parametrize("source,name,argtypes", [
    ("pool.cu", "cap2det_pool_same_fwd", pool_grad._FWD_ARGTYPES),
    ("pool_grad.cu", "cap2det_pool_same_grad", pool_grad._GRAD_ARGTYPES),
    ("roi_pool.cu", "cap2det_roi_crop_maxpool_fwd_staged",
     roi_pool._FWD_STAGED_ARGTYPES),
    ("roi_pool_bwd.cu", "cap2det_roi_crop_maxpool_bwd_staged",
     roi_pool._BWD_STAGED_ARGTYPES),
    ("roi_pool_bwd.cu", "cap2det_roi_grad_from_fixed",
     roi_pool._FROM_FIXED_ARGTYPES),
    ("roi_pool.cu", "cap2det_roi_crop_maxpool_fwd_generic",
     roi_pool._FWD_GENERIC_ARGTYPES),
    ("roi_pool_bwd.cu", "cap2det_roi_crop_maxpool_bwd_generic",
     roi_pool._BWD_GENERIC_ARGTYPES),
], ids=["K4", "K5_K6", "K1", "K2", "K2_from_fixed", "K1_generic",
        "K2_generic"])
def test_argtypes_match_the_c_signatures(source, name, argtypes):
    """ctypes checks only that enough arguments are passed: a declared
    type too many shows up only on the card."""
    assert len(argtypes) == _c_params(source, name)


def test_wrappers_check_shapes_and_count_no_plain_launches():
    x, g = _case((2, 7, 7, 4), 2, 5)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    counters = ("launches", "maxpool_grad_launches", "avgpool_grad_launches",
                "maxpool_grad_tiled_launches", "maxpool_grad_untiled_launches",
                "avgpool_grad_tiled_launches", "avgpool_grad_untiled_launches")
    before = [getattr(pool_grad, name) for name in counters]
    out = pool_grad.pool_same(xt.requires_grad_(True), "pool_max", 3, 2)
    out.backward(gt)
    pool_grad.avgpool_grad(x.shape, torch.float32, gt, 3, 2)
    assert [getattr(pool_grad, name) for name in counters] == before
    with pytest.raises(ValueError, match="g must be"):
        pool_grad.maxpool_grad(xt.detach(), gt[:, :3], 3, 2)
    with pytest.raises(ValueError, match="g must be"):
        pool_grad.avgpool_grad((2, 7, 7, 4), torch.float32, gt[..., :3], 3, 2)
    with pytest.raises(ValueError, match="kind"):
        pool_grad.pool_same(xt, "pool_min", 3, 2)
