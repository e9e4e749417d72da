"""Plain versions of the port's SAME pool backward kernels (K5 max, K6
avg) against the JAX package: ``maxpool_grad_reference`` and the Pallas
kernels in interpret mode, which route max-pool ties first-tie as the port
does. Also the autograd Function (K4 forward, K5/K6 backward) on the CPU.

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
    before = (pool_grad.launches, pool_grad.maxpool_grad_launches,
              pool_grad.avgpool_grad_launches)
    out = pool_grad.pool_same(xt.requires_grad_(True), "pool_max", 3, 2)
    out.backward(gt)
    pool_grad.avgpool_grad(x.shape, torch.float32, gt, 3, 2)
    assert (pool_grad.launches, pool_grad.maxpool_grad_launches,
            pool_grad.avgpool_grad_launches) == before
    with pytest.raises(ValueError, match="g must be"):
        pool_grad.maxpool_grad(xt.detach(), gt[:, :3], 3, 2)
    with pytest.raises(ValueError, match="g must be"):
        pool_grad.avgpool_grad((2, 7, 7, 4), torch.float32, gt[..., :3], 3, 2)
    with pytest.raises(ValueError, match="kind"):
        pool_grad.pool_same(xt, "pool_min", 3, 2)
