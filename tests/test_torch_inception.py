"""The port's InceptionV2 stages against the JAX package at float32: the
first stage on a 64x96 canvas (the JAX side fed both the raw canvas and
its space-to-depth packing), and the second stage on ROI features, also
recomputed in the backward (``remat=True`` against JAX's
CAP2DET_SECOND_STAGE_REMAT=1, value and gradients).

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
from cap2det_tpu_torch import bench
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


def _live_params(tree):
    """The port's params from the numpy `tree`, every leaf requiring
    gradients, and its leaves in ``jax.tree`` order."""
    params = params_lib.from_jax_numpy(tree, "cpu")
    leaves = jax.tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return params, leaves


def _second_stage_grads(tree, rois, g, remat, dtype=torch.float32):
    """The port's second stage on `rois` from the numpy `tree`: its output,
    the gradient tree of sum(output * g) (the params' structure) and the
    ROIs' gradient."""
    params, leaves = _live_params(tree)
    x = torch.from_numpy(rois).to(dtype).requires_grad_(True)
    out = inception_v2.second_stage(inception_v2.prepare(params, dtype), x,
                                    remat=remat)
    *grads, dx = torch.autograd.grad(
        (out.float() * torch.from_numpy(g)).sum(), [*leaves, x])
    return (out.detach(),
            jax.tree.unflatten(jax.tree.structure(params), grads), dx)


def _no_ties_rois(seed, n):
    """ROI features with no tied maxima in Mixed_5a's pool windows."""
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((n, 7, 7, 576))).astype(np.float32)


def _upstream(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 4, 4, 1024)).astype(np.float32)


def test_second_stage_remat_matches_jax_remat(trees, monkeypatch):
    """``second_stage(remat=True)`` against JAX's second stage traced with
    CAP2DET_SECOND_STAGE_REMAT=1 (a jax.checkpoint per Mixed_5 block):
    the output and the gradients of sum(out * g) with respect to the ROIs
    and every second-stage leaf. The ROIs have no ties; Mixed_5c's pool
    sees tied post-ReLU zeros, whose gradient the ReLU stops on both
    sides."""
    _, second = trees
    rois, g = _no_ties_rois(6, 3), _upstream(7, 3)
    monkeypatch.setenv("CAP2DET_SECOND_STAGE_REMAT", "1")

    def loss(p, x):
        out = jax_inception.second_stage(p, x, compute_dtype=jnp.float32)
        return jnp.sum(out * g), out

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    # The variable is read at trace time: this trace holds the remat.
    assert "remat" in str(jax.make_jaxpr(fn)(_jax(second), rois))
    (_, want), (want_tree, want_rois) = jax.jit(fn)(_jax(second), rois)

    got, grads, dx = _second_stage_grads(second, rois, g, remat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_rois), rtol=RTOL,
                               atol=ATOL)
    got_leaves = jax.tree_util.tree_flatten_with_path(
        params_lib.to_jax_numpy(grads))[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, value), (_, want_value) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(value, np.asarray(want_value), rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_second_stage_remat_changes_no_bit(trees, dtype):
    """The port recomputing the Mixed_5 blocks in the backward gives the
    same bits as keeping their intermediates: the output and every
    gradient (the ROIs' included)."""
    _, second = trees
    rois, g = _no_ties_rois(8, 3), _upstream(9, 3)
    plain, plain_grads, plain_dx = _second_stage_grads(second, rois, g,
                                                       False, dtype)
    remat, remat_grads, remat_dx = _second_stage_grads(second, rois, g,
                                                       True, dtype)
    assert plain.dtype == dtype and torch.equal(remat, plain)
    assert torch.equal(remat_dx, plain_dx)
    plain_leaves = jax.tree.leaves(plain_grads)
    assert len(plain_leaves) == len(jax.tree.leaves(second)) == 76  # 19 convs
    for a, b in zip(jax.tree.leaves(remat_grads), plain_leaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("full_freeze", [False, True],
                         ids=["mixed4e_trainable", "full_freeze"])
def test_remat_reruns_the_pool_kernel_as_the_bench_counts(
        trees, monkeypatch, full_freeze):
    """``pool_grad.pool_fwd`` calls of one second stage: 3 under no_grad
    with or without remat and 3 through a backward without it; with it,
    each block's recompute runs its pool again, except Mixed_5a's when no
    gradient flows into the ROIs (the full freeze). The counts are
    ``bench.LAUNCHES``'s."""
    _, second = trees
    calls = []
    real = pool_grad.pool_fwd

    def counting(x, kind, kernel, stride):
        calls.append(kind)
        return real(x, kind, kernel, stride)

    monkeypatch.setattr(pool_grad, "pool_fwd", counting)
    params, _ = _live_params(second)
    rois = torch.from_numpy(_no_ties_rois(10, 2))
    for remat in (False, True):
        calls.clear()
        with torch.no_grad():
            inception_v2.second_stage(
                inception_v2.prepare(params, torch.float32), rois,
                remat=remat)
        assert len(calls) == 3
        calls.clear()
        x = rois.clone().requires_grad_(not full_freeze)
        inception_v2.second_stage(
            inception_v2.prepare(params, torch.float32), x,
            remat=remat).sum().backward()
        assert len(calls) == bench.LAUNCHES[(full_freeze, remat)][
            "pool_fwd"] == (3 if not remat else 5 if full_freeze else 6)


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
    got = pool_grad.pool_dense(x, "pool_avg", 3, 1)
    assert torch.equal(got, x)
    with pytest.raises(ValueError, match="asymmetric"):
        pool_grad.pool_dense(x, "pool_avg", 3, 2)


def test_stem_pads_asymmetrically_like_tf(trees):
    """Conv2d_1a 7x7/s2 on an even input pads 2 before and 3 after; a
    symmetric pad would shift every output by one pixel."""
    assert pool_grad.same_pads(64, 7, 2) == (32, 2, 3)
    assert pool_grad.same_pads(8, 3, 2) == (4, 0, 1)
    assert pool_grad.same_pads(7, 3, 2) == (4, 1, 1)
