"""Plain version of the port's SAME pool kernel (K4), and the first
stage's large-map pools, against the JAX package: the Pallas
``pool_grad.pool_fwd`` in interpret mode and the ``reduce_window`` form
``inception_v2._pool_fast``."""

import numpy as np
import pytest
import torch

from cap2det_tpu.kernels import pool_grad as jax_pool_grad
from cap2det_tpu.models import inception_v2 as jax_inception
from cap2det_tpu_torch.kernels import pool_grad

torch.set_num_threads(1)

CASES = [  # (h, w, kernel, stride)
    (7, 7, 3, 2),  # Mixed_5a
    (4, 4, 3, 1),  # Mixed_5b / 5c
    (5, 9, 3, 2),  # odd, asymmetric SAME padding on one axis
    (3, 5, 3, 1),
    (6, 8, 2, 2),  # even kernel
]


def _x(seed, n, h, w, c):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize("h,w,k,s", CASES)
def test_plain_matches_jax(kind, h, w, k, s):
    x = _x(0, 3, h, w, 8)
    got = pool_grad.pool_fwd(torch.from_numpy(x), kind, k, s).numpy()
    want_rw = np.asarray(jax_inception._pool_fast(x, kind, k, s))
    assert got.shape == want_rw.shape
    np.testing.assert_allclose(got, want_rw, rtol=1e-6, atol=1e-6)
    if jax_pool_grad.supported(x.shape, k, s):
        want_pallas = np.asarray(
            jax_pool_grad.pool_fwd(x, kind, k, s, interpret=True))
        np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [7, 8, 9, 30])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2)])
def test_same_pads_match_jax(size, k, s):
    assert pool_grad.same_pads(size, k, s) == jax_inception._same_pads(
        size, k, s)


@pytest.mark.parametrize("kind,k,s", [("pool_max", 3, 2), ("pool_avg", 3, 1),
                                      ("pool_avg", 2, 2)])
def test_first_stage_pool_matches_jax(kind, k, s):
    """The first stage's large-map pools (plain torch on NCHW views)."""
    x = _x(1, 2, 24, 30, 8)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = pool_grad.pool_dense(nchw, kind, k, s).permute(0, 2, 3, 1)
    want = np.asarray(jax_inception._pool_fast(x, kind, k, s))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_avg_divisor_counts_in_bounds_taps():
    x = np.ones((1, 4, 4, 1), np.float32)
    got = pool_grad.pool_fwd(torch.from_numpy(x), "pool_avg", 3, 1)
    np.testing.assert_array_equal(got.numpy(), x)  # not 4/9 at corners


def test_bf16_avg_sums_in_f32():
    x = torch.from_numpy(_x(2, 2, 4, 4, 16))
    got = pool_grad.pool_fwd(x.bfloat16(), "pool_avg", 3, 1)
    assert got.dtype == torch.bfloat16
    want = pool_grad.pool_fwd(x.bfloat16().float(), "pool_avg", 3, 1)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_wrapper_contract():
    x = torch.from_numpy(_x(3, 2, 4, 4, 4))
    before = pool_grad.launches
    pool_grad.pool_fwd(x, "pool_max", 3, 1)
    assert pool_grad.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="pool kind"):
        pool_grad.pool_fwd(x, "pool_min", 3, 1)
    with pytest.raises(ValueError):
        pool_grad.pool_fwd(x[0], "pool_max", 3, 1)
