"""The port's masked ops, losses and OICR targets against the JAX package
(``ops/masked.py``, ``ops/losses.py``, ``models/wsod.py``), float32 on the
CPU. Elementwise float32 in the same operation order: rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.models import wsod as jax_wsod
from cap2det_tpu.ops import losses as jax_losses
from cap2det_tpu.ops import masked as jax_masked
from cap2det_tpu_torch.models import wsod
from cap2det_tpu_torch.ops import losses, masked

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _data(seed=0, shape=(3, 7, 4)):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape[:2]) < 0.6).astype(np.float32)
    mask[0] = 0.0  # a fully masked row
    mask[1, 2] = 1.0
    return data, mask


@pytest.mark.parametrize("name", ["masked_maximum", "masked_minimum",
                                  "masked_sum", "masked_avg"])
@pytest.mark.parametrize("keepdim", [True, False])
def test_masked_reductions_match_jax(name, keepdim):
    data, mask = _data()
    want = getattr(jax_masked, name)(data, mask[..., None], axis=1,
                                     keepdims=keepdim)
    got = getattr(masked, name)(torch.from_numpy(data),
                                torch.from_numpy(mask)[..., None], dim=1,
                                keepdim=keepdim)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("name", ["masked_sum_nd", "masked_avg_nd"])
def test_masked_nd_forms_match_jax(name):
    data, mask = _data(1)
    want = getattr(jax_masked, name)(data, mask, axis=1)
    got = getattr(masked, name)(torch.from_numpy(data),
                                torch.from_numpy(mask), dim=1)
    _close(got, want)


@pytest.mark.parametrize("name", ["masked_argmax", "masked_argmin"])
def test_masked_arg_extrema_match_jax_with_ties(name):
    data, mask = _data(2)
    data[2, 1:4] = data[2, 0]  # exact ties: the first index wins
    data = np.round(data, 1)  # more ties
    want = getattr(jax_masked, name)(data, mask[..., None], axis=1)
    got = getattr(masked, name)(torch.from_numpy(data),
                                torch.from_numpy(mask)[..., None], dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_avg_floors_the_count():
    data, mask = _data(3)
    got = masked.masked_avg(torch.from_numpy(data),
                            torch.zeros_like(torch.from_numpy(data)))
    assert torch.isfinite(got).all() and float(got.abs().max()) == 0.0


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 30, (4, 9)).astype(np.float32)  # large |x|
    labels = (rng.uniform(size=(4, 9)) < 0.4).astype(np.float32)
    _close(losses.sigmoid_cross_entropy(torch.from_numpy(labels),
                                        torch.from_numpy(logits)),
           jax_losses.sigmoid_cross_entropy(labels, logits))
    dist = rng.uniform(size=(4, 9)).astype(np.float32)
    dist /= dist.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        losses.softmax_cross_entropy(torch.from_numpy(dist),
                                     torch.from_numpy(logits)).numpy(),
        np.asarray(jax_losses.softmax_cross_entropy(dist, logits)),
        rtol=1e-5)


def test_l2_regularization_matches_jax():
    rng = np.random.default_rng(5)
    tree = {"midn": {"a": {"weights": rng.normal(size=(5, 3)),
                           "biases": rng.normal(size=3)}},
            "oicr": {"iter1": {"weights": rng.normal(size=(5, 4)),
                               "biases": rng.normal(size=4)}}}
    tree = {k: {n: {m: v.astype(np.float32) for m, v in leaf.items()}
                for n, leaf in sub.items()} for k, sub in tree.items()}
    want = jax_losses.l2_regularization(tree, 1e-4)
    port_tree = {k: {n: {m: torch.from_numpy(v) for m, v in leaf.items()}
                     for n, leaf in sub.items()} for k, sub in tree.items()}
    np.testing.assert_allclose(float(losses.l2_regularization(port_tree,
                                                              1e-4)),
                               float(want), rtol=1e-6)
    only_biases = losses.l2_regularization(
        port_tree, 1.0, predicate=lambda p: p.endswith("biases"))
    np.testing.assert_allclose(float(only_biases), float(
        jax_losses.l2_regularization(tree, 1.0,
                                     predicate=lambda p: p.endswith("biases"))),
        rtol=1e-6)


def _oicr_case(seed):
    rng = np.random.default_rng(seed)
    b, p, c = 3, 9, 4
    y0, x0 = rng.uniform(0, 0.6, (b, p)), rng.uniform(0, 0.6, (b, p))
    proposals = np.stack([y0, x0, y0 + rng.uniform(0.1, 0.4, (b, p)),
                          x0 + rng.uniform(0.1, 0.4, (b, p))],
                         -1).astype(np.float32)
    proposals[:, 1] = proposals[:, 0]  # duplicate boxes: IoU 1 with a seed
    scores_prev = rng.uniform(size=(b, p, 1 + c)).astype(np.float32)
    scores_prev[0, 2:5, 1:] = scores_prev[0, 1, 1:]  # tied seed scores
    scores_next = rng.normal(size=(b, p, 1 + c)).astype(np.float32)
    labels = (rng.uniform(size=(b, c)) < 0.5).astype(np.float32)
    labels[0, 0] = 1.0
    labels[1] = 0.0  # no class fires: every proposal is background
    mask = np.ones((b, p), np.float32)
    mask[2, 6:] = 0.0
    mask[1] = 0.0  # a fully masked row
    return labels, proposals, scores_prev, scores_next, mask


@pytest.mark.parametrize("iou_threshold", [0.3, 0.6])
def test_oicr_targets_and_loss_match_jax(iou_threshold):
    labels, proposals, prev, nxt, mask = _oicr_case(6)
    t = [torch.from_numpy(a) for a in (labels, proposals, prev, nxt, mask)]
    want = jax_wsod.oicr_target_assignment(labels, proposals, prev, mask,
                                           iou_threshold)
    got = wsod.oicr_target_assignment(t[0], t[1], t[2], t[4], iou_threshold)
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert torch.all(got[1, :, 0] == 1.0)  # all background
    want_loss = jax_wsod.oicr_loss(labels, proposals, prev, nxt, mask,
                                   iou_threshold)
    got_loss = wsod.oicr_loss(*t[:4], t[4], iou_threshold)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)


def test_oicr_loss_gradient_stops_at_the_targets():
    labels, proposals, prev, nxt, mask = _oicr_case(7)
    prev_t = torch.from_numpy(prev).requires_grad_(True)
    nxt_t = torch.from_numpy(nxt).requires_grad_(True)
    loss = wsod.oicr_loss(torch.from_numpy(labels),
                          torch.from_numpy(proposals), prev_t, nxt_t,
                          torch.from_numpy(mask))
    loss.backward()
    assert prev_t.grad is None
    assert float(nxt_t.grad[1].abs().max()) == 0.0  # masked row
    assert float(nxt_t.grad[2, 6:].abs().max()) == 0.0  # padded slots
    want = jax.grad(lambda s: jax_wsod.oicr_loss(
        labels, proposals, prev, s, mask))(jnp.asarray(nxt))
    np.testing.assert_allclose(nxt_t.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-8)
