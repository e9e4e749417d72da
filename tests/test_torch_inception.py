"""The port's InceptionV2 stages against the JAX package at float32: the
first stage on a 64x96 canvas (the JAX side fed both the raw canvas and
its space-to-depth packing), and the second stage on ROI features.

Weights are made with numpy from a seed, with non-trivial frozen BN
statistics so the BN fold is exercised, and carried to the port by
``params.from_jax_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.models import inception_v2 as jax_inception
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.kernels import pool_grad
from cap2det_tpu_torch.models import inception_v2

torch.set_num_threads(1)

# float32 through ~20 convolutions summed in another order by XLA and by
# PyTorch's CPU kernels; activations are O(1) under He-scaled weights.
RTOL, ATOL = 1e-4, 1e-4


def _randomize_bn(tree, rng):
    for key, value in tree.items():
        if key == "BatchNorm":
            n = value["beta"].shape[0]
            value["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
            value["moving_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            value["moving_variance"] = rng.uniform(0.5, 1.5, n).astype(
                np.float32)
        elif isinstance(value, dict):
            _randomize_bn(value, rng)
    return tree


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    first = _randomize_bn(
        inception_v2.init_first_stage_params_numpy(rng), rng)
    second = _randomize_bn(
        inception_v2.init_second_stage_params_numpy(rng), rng)
    return first, second


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _prepared(tree):
    return inception_v2.prepare(params_lib.from_jax_numpy(tree, "cpu"),
                                torch.float32)


def test_first_stage_matches_jax_raw_and_s2d(trees):
    first, _ = trees
    rng = np.random.default_rng(1)
    canvas = rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    pre = np.asarray(jax_inception.preprocess(canvas))
    run = jax.jit(lambda p, x: jax_inception.first_stage(
        p, x, compute_dtype=jnp.float32))
    want_raw = np.asarray(run(_jax(first), pre))
    want_s2d = np.asarray(run(_jax(first), jax_inception.space_to_depth(pre)))

    got = inception_v2.first_stage(
        _prepared(first), inception_v2.preprocess(torch.from_numpy(canvas)))
    assert got.shape == (2, 4, 6, 576) == want_raw.shape
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_raw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_s2d, rtol=RTOL, atol=ATOL)


def test_second_stage_matches_jax(trees):
    _, second = trees
    rng = np.random.default_rng(2)
    rois = np.abs(rng.standard_normal((5, 7, 7, 576))).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_inception.second_stage(
        p, x, compute_dtype=jnp.float32))(_jax(second), rois))
    got = inception_v2.second_stage(_prepared(second), torch.from_numpy(rois))
    assert got.shape == (5, 4, 4, 1024) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pool_kernel_serves_exactly_the_second_stage_pools(trees,
                                                            monkeypatch):
    """Mixed_5a/5b/5c each pool once through ``pool_grad.pool_fwd``; the
    first stage's large-map pools never do."""
    first, second = trees
    calls = []
    real = pool_grad.pool_fwd

    def counting(x, kind, kernel, stride):
        calls.append((tuple(x.shape[1:3]), kind, kernel, stride))
        return real(x, kind, kernel, stride)

    monkeypatch.setattr(pool_grad, "pool_fwd", counting)
    inception_v2.first_stage(_prepared(first), torch.zeros(1, 64, 64, 3))
    assert calls == []
    inception_v2.second_stage(_prepared(second), torch.zeros(2, 7, 7, 576))
    assert calls == [((7, 7), "pool_max", 3, 2), ((4, 4), "pool_avg", 3, 1),
                     ((4, 4), "pool_max", 3, 1)]


def test_prepare_folds_bn_once_into_compute_dtype(trees):
    """``prepare`` turns every conv into a folded {weight, bias} in the
    compute dtype (the stem composed into one dense 7x7 conv), with
    conv(x, weight) + bias == BN(conv(x, weights))."""
    first, _ = trees
    prepared = inception_v2.prepare(params_lib.from_jax_numpy(first, "cpu"),
                                    torch.bfloat16)
    p = prepared["InceptionV2"]
    assert set(p["Conv2d_1a_7x7"]) == {"weight", "bias"}
    assert tuple(p["Conv2d_1a_7x7"]["weight"].shape) == (64, 3, 7, 7)
    conv = p["Mixed_4e"]["Branch_2"]["Conv2d_0b_3x3"]
    assert conv["weight"].dtype == conv["bias"].dtype == torch.bfloat16
    assert conv["weight"].is_contiguous(memory_format=torch.channels_last)
    raw = first["InceptionV2"]["Mixed_4e"]["Branch_2"]["Conv2d_0b_3x3"]
    bn = raw["BatchNorm"]
    inv = 1.0 / np.sqrt(bn["moving_variance"] + inception_v2.BN_EPSILON)
    want_w = raw["weights"].transpose(3, 2, 0, 1) * inv[:, None, None, None]
    np.testing.assert_allclose(conv["weight"].float().numpy(), want_w,
                               rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(conv["bias"].float().numpy(),
                               bn["beta"] - bn["moving_mean"] * inv,
                               rtol=8e-3, atol=1e-6)


def test_dense_avg_pool_refuses_asymmetric_padding():
    """Every avg pool of the network is 3x3/s1 (symmetric SAME padding);
    an asymmetric one raises rather than taking another path."""
    x = torch.ones(1, 2, 8, 8)
    got = inception_v2.pool_dense(x, "pool_avg", 3, 1)
    assert torch.equal(got, x)
    with pytest.raises(ValueError, match="asymmetric"):
        inception_v2.pool_dense(x, "pool_avg", 3, 2)


def test_stem_pads_asymmetrically_like_tf(trees):
    """Conv2d_1a 7x7/s2 on an even input pads 2 before and 3 after; a
    symmetric pad would shift every output by one pixel."""
    assert pool_grad.same_pads(64, 7, 2) == (32, 2, 3)
    assert pool_grad.same_pads(8, 3, 2) == (4, 0, 1)
    assert pool_grad.same_pads(7, 3, 2) == (4, 1, 1)
