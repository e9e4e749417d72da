"""Plain version of the port's ROI crop+pool backward kernel (K2) against
the JAX package's Pallas backward, ``jax.vjp`` of
``roi_pool.roi_crop_maxpool(..., interpret=True)``, which routes each
window's gradient first-tie as the port does.

Tolerances: rtol 1e-4 on random features (the Pallas backward samples
from precomputed coordinates and scatters through interpolation
matrices, close to the kernel's expressions but not bit-identical: the
floor ROADMAP queue 3 records); 1e-5 on the tie-rich case, whose boxes
put every sample on a half-pixel grid, so both sides compute every
sample exactly and pick the same winners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.kernels import roi_pool as jax_roi_pool
from cap2det_tpu_torch.kernels import roi_pool
from cap2det_tpu_torch.ops import roi

torch.set_num_threads(1)


def _jax_vjp(features, boxes, grad, crop, **kw):
    _, vjp = jax.vjp(lambda f: jax_roi_pool.roi_crop_maxpool(
        f, boxes, crop, 2, 2, interpret=True, **kw), jnp.asarray(features))
    return np.asarray(vjp(jnp.asarray(grad))[0])


def _port_vjp(features, boxes, grad, crop, k=2, s=2):
    f = torch.from_numpy(features).requires_grad_(True)
    out = roi_pool.roi_crop_maxpool(f, torch.from_numpy(boxes), crop, k, s)
    (df,) = torch.autograd.grad(out, f, torch.from_numpy(grad))
    return df.numpy()


def test_plain_grad_matches_pallas_vjp():
    """P=13, C=20, with boxes partly and wholly outside the map and zero
    padding boxes."""
    rng = np.random.RandomState(0)
    b, p, h, w, c, crop = 2, 13, 9, 12, 20, 6
    features = rng.randn(b, h, w, c).astype(np.float32)
    y0 = rng.uniform(-0.3, 0.8, (b, p))
    x0 = rng.uniform(-0.3, 0.8, (b, p))
    boxes = np.stack([y0, x0, y0 + rng.uniform(0.05, 0.6, (b, p)),
                      x0 + rng.uniform(0.05, 0.6, (b, p))],
                     -1).astype(np.float32)
    boxes[0, 0] = [-0.5, -0.5, -0.1, -0.2]  # wholly outside
    boxes[1, 0] = [0.7, 0.8, 1.4, 1.3]  # partly outside
    boxes[:, -2:] = 0.0
    grad = rng.randn(b, p, crop // 2, crop // 2, c).astype(np.float32)
    want = _jax_vjp(features, boxes, grad, crop)
    got = _port_vjp(features, boxes, grad, crop)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tie_rich_quantised_features_route_first_tie():
    """Features in {0, 1, 2} and boxes on a grid where every sample lands
    on a whole or half pixel: many windows hold exactly equal maxima. The
    flat first-tie scan of the Pallas backward (CAP2DET_ROI_BWD=scatter)
    and the port must send each window's gradient to the same sample."""
    rng = np.random.RandomState(3)
    b, p, h, w, c, crop = 1, 8, 9, 9, 8, 6
    features = rng.randint(0, 3, size=(b, h, w, c)).astype(np.float32)
    # h_max = 8: starts on multiples of 1/8 and spans of 2.5/8 or 5/8 put
    # the 6 samples 0.5 or 1 pixel apart.
    starts = rng.randint(0, 4, size=(b, p, 2)) / 8.0
    spans = rng.choice([2.5 / 8, 5.0 / 8], size=(b, p, 2))
    boxes = np.concatenate([starts, starts + spans], -1).astype(np.float32)
    grad = rng.randn(b, p, crop // 2, crop // 2, c).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP2DET_ROI_BWD", "scatter")
        want = _jax_vjp(features, boxes, grad, crop)
    got = _port_vjp(features, boxes, grad, crop)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The routing is first-tie, not a split of tied windows' gradients.
    samples = roi.crop_and_resize(torch.from_numpy(features),
                                  torch.from_numpy(boxes), crop).numpy()
    windows = samples.reshape(b, p, 3, 2, 3, 2, c)
    assert (windows == windows.max(axis=(3, 5), keepdims=True)).sum() > (
        1.3 * windows[:, :, :, 0, :, 0].size)


def test_tied_windows_conserve_gradient_mass():
    """Constant features (the post-ReLU zeros case): each window's whole
    gradient lands once, as TF MaxPoolGrad routes it."""
    features = np.zeros((1, 8, 8, 8), np.float32)
    boxes = np.array([[[0.0, 0.0, 1.0, 1.0]]], np.float32)
    grad = np.ones((1, 1, 2, 2, 8), np.float32)
    got = _port_vjp(features, boxes, grad, 4)
    np.testing.assert_allclose(got.sum(), 32.0, atol=1e-4)
    np.testing.assert_allclose(got, _jax_vjp(features, boxes, grad, 4),
                               atol=1e-6)


@pytest.mark.parametrize("crop,k,s", [(6, 3, 1), (7, 2, 2)])
def test_plain_grad_matches_autograd_of_the_sample_form(crop, k, s):
    """Pools the Pallas kernel does not take (overlapping windows, a crop
    the pool does not tile) against autograd through the plain forward on
    tie-free features: the same function, differentiated by PyTorch."""
    rng = np.random.RandomState(4)
    features = rng.randn(2, 7, 10, 5).astype(np.float32)
    y0, x0 = rng.uniform(0, 0.5, (2, 6)), rng.uniform(0, 0.5, (2, 6))
    boxes = np.stack([y0, x0, y0 + 0.4, x0 + 0.45], -1).astype(np.float32)
    pooled = (crop - k) // s + 1
    grad = rng.randn(2, 6, pooled, pooled, 5).astype(np.float32)
    f = torch.from_numpy(features).requires_grad_(True)
    out = roi.max_pool_2d(
        roi.crop_and_resize(f, torch.from_numpy(boxes), crop), k, s)
    (want,) = torch.autograd.grad(out, f, torch.from_numpy(grad))
    got = _port_vjp(features, boxes, grad, crop, k, s)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)


def test_chunked_grad_equals_unchunked(monkeypatch):
    rng = np.random.RandomState(5)
    features = torch.from_numpy(rng.randn(2, 6, 7, 4).astype(np.float32))
    boxes = torch.from_numpy(rng.uniform(0, 1, (2, 5, 4)).astype(np.float32))
    grad = torch.from_numpy(rng.randn(2, 5, 3, 3, 4).astype(np.float32))
    whole = roi_pool.roi_crop_maxpool_grad(features, boxes, grad, 6)
    monkeypatch.setattr(roi, "_CHUNK_BYTES", 1)  # one proposal per chunk
    # The same contributions, added into dF in another order.
    torch.testing.assert_close(
        roi_pool.roi_crop_maxpool_grad(features, boxes, grad, 6), whole,
        rtol=1e-6, atol=1e-6)


def test_no_backward_when_features_need_no_gradient(monkeypatch):
    calls = []
    real = roi_pool.roi_crop_maxpool_grad
    monkeypatch.setattr(roi_pool, "roi_crop_maxpool_grad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(6)
    features = torch.from_numpy(rng.randn(1, 6, 6, 4).astype(np.float32))
    boxes = torch.from_numpy(rng.uniform(0, 1, (1, 3, 4)).astype(np.float32))
    weight = torch.ones(4, requires_grad=True)
    out = roi_pool.roi_crop_maxpool(features, boxes, 4)
    assert not out.requires_grad
    (out * weight).sum().backward()
    assert calls == [] and weight.grad is not None
    out = roi_pool.roi_crop_maxpool(features.requires_grad_(True), boxes, 4)
    out.sum().backward()
    assert calls == [1]
    assert roi_pool.grad_launches == 0  # the plain version launches nothing


def test_grad_wrapper_contract():
    rng = np.random.RandomState(7)
    features = torch.from_numpy(rng.randn(1, 6, 6, 4).astype(np.float32))
    boxes = torch.from_numpy(rng.uniform(0, 1, (1, 3, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="grad must be"):
        roi_pool.roi_crop_maxpool_grad(features, boxes,
                                       torch.zeros(1, 3, 2, 2, 4), 6)
    bf16 = roi_pool.roi_crop_maxpool_grad(
        features.bfloat16(), boxes, torch.ones(1, 3, 3, 3, 4).bfloat16(), 6)
    assert bf16.dtype == torch.bfloat16


def _fixed_case(seed, b=2, p=13, h=9, w=12, c=20, crop=6, k=2, s=2):
    rng = np.random.RandomState(seed)
    features = rng.randn(b, h, w, c).astype(np.float32)
    y0 = rng.uniform(-0.3, 0.8, (b, p))
    x0 = rng.uniform(-0.3, 0.8, (b, p))
    boxes = np.stack([y0, x0, y0 + rng.uniform(0.05, 0.6, (b, p)),
                      x0 + rng.uniform(0.05, 0.6, (b, p))],
                     -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 1, [2, 3, 0, 1]]  # reversed
    boxes[:, -2:] = 0.0
    pooled = (crop - k) // s + 1
    grad = rng.randn(b, p, pooled, pooled, c).astype(np.float32)
    return features, boxes, grad


def _fixed(features, boxes, grad, crop, k=2, s=2):
    return roi.crop_resize_maxpool_grad(
        torch.from_numpy(features), torch.from_numpy(boxes),
        torch.from_numpy(grad), crop, k, s, fixed_point=True)


def test_fixed_point_grad_matches_float_plain_and_pallas_vjp():
    """The fixed-point sums (the CUDA backward's bits) within GRAD_TOL of
    the float32 plain version, and of the Pallas backward as the float
    version is held to it."""
    features, boxes, grad = _fixed_case(8)
    got = _fixed(features, boxes, grad, 6)
    assert got.dtype == torch.float32
    want = roi.crop_resize_maxpool_grad(
        torch.from_numpy(features), torch.from_numpy(boxes),
        torch.from_numpy(grad), 6, 2, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               _jax_vjp(features, boxes, grad, 6),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("crop,k,s", [(6, 2, 2), (6, 3, 1), (7, 2, 2)])
def test_fixed_point_grad_matches_float_on_other_pools(crop, k, s):
    """Overlapping windows (3/s1) quantise each window's contribution on
    its own, as the kernel does."""
    features, boxes, grad = _fixed_case(9, crop=crop, k=k, s=s)
    got = _fixed(features, boxes, grad, crop, k, s)
    want = _port_vjp(features, boxes, grad, crop, k, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("crop,k,s", [(6, 2, 2), (6, 3, 1)])
def test_fixed_point_grad_ignores_proposal_order(crop, k, s):
    """Integer sums: shuffling the proposals with their gradients, or
    chunking them, changes no bit, in float32 and bf16."""
    features, boxes, grad = _fixed_case(10, crop=crop, k=k, s=s)
    perm = np.random.RandomState(11).permutation(boxes.shape[1])
    for dtype in (torch.float32, torch.bfloat16):
        f = torch.from_numpy(features).to(dtype)
        g = torch.from_numpy(grad).to(dtype)
        b = torch.from_numpy(boxes)
        whole = roi.crop_resize_maxpool_grad(f, b, g, crop, k, s,
                                             fixed_point=True)
        assert whole.dtype == dtype
        shuffled = roi.crop_resize_maxpool_grad(
            f, b[:, perm], g[:, perm], crop, k, s, fixed_point=True)
        assert torch.equal(shuffled, whole)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(roi, "_CHUNK_BYTES", 1)  # one proposal per chunk
            assert torch.equal(roi.crop_resize_maxpool_grad(
                f, b, g, crop, k, s, fixed_point=True), whole)


def test_fixed_point_grad_is_the_quantised_sum():
    """One proposal, one channel, written out: each winner corner's
    (g * wy) * wx rounded half to even at 2^-32, summed, scaled back."""
    features = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    boxes = np.array([[[0.1, 0.2, 0.7, 0.9]]], np.float32)
    grad = np.array([[[[[0.3]]]]], np.float32)
    got = _fixed(features, boxes, grad, 2, 2, 2)
    f, b = torch.from_numpy(features), torch.from_numpy(boxes)
    samples = roi.crop_samples(f, b, 2)[0, 0, ..., 0]
    i, j = divmod(int(torch.argmax(samples.reshape(-1))), 2)
    yi, ya, yb = roi.sample_coords(b[..., 0], b[..., 2], 2, 4)
    xi, xa, xb = roi.sample_coords(b[..., 1], b[..., 3], 2, 4)
    want = torch.zeros(4, 4, dtype=torch.int64)
    g = torch.tensor(0.3, dtype=torch.float32)
    for dy, wy in enumerate((ya[0, 0, i], yb[0, 0, i])):
        for dx, wx in enumerate((xa[0, 0, j], xb[0, 0, j])):
            q = torch.round(g * wy * wx * 2.0 ** 32).long()
            want[yi[0, 0, i] + dy, xi[0, 0, j] + dx] += q
    want = (want.float() * 2.0 ** -32)[None, :, :, None]
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,reverse", [(12, False), (13, True)])
def test_footprint_slots_index_the_sorted_row_set(seed, reverse):
    """Each floor index's slot in the ascending set of {idx, idx + 1}, as
    the kernels' warp scan builds it, for increasing and reversed boxes
    and a zero box (R = {0, 1})."""
    rng = np.random.RandomState(seed)
    idx = np.sort(rng.randint(0, 20, (5, 14)), -1)
    if reverse:
        idx = idx[:, ::-1]
    idx[0] = 0
    slot, size = roi._footprint_slots(torch.from_numpy(idx.copy()))
    for row, got, n in zip(idx, slot.tolist(), size.tolist()):
        want = sorted(set(row) | set(row + 1))
        assert n == len(want) and got == [want.index(v) for v in row]
    assert size[0] == 2


@pytest.mark.parametrize("crop,k,s", [(6, 2, 2), (6, 3, 1)])
def test_atomic_counts_of_the_fixed_point_sums(crop, k, s):
    """With no footprint summed locally every nonzero contribution is an
    atomic; with all of them, one per (proposal, position, channel) whose
    quantised sum is nonzero, which the oracle run on each proposal alone
    counts."""
    features, boxes, grad = _fixed_case(14, crop=crop, k=k, s=s)
    f, b, g = (torch.from_numpy(x) for x in (features, boxes, grad))

    def counts(local_slots):
        return roi.crop_resize_maxpool_grad_atomics(f, b, g, crop, k, s,
                                                    local_slots)

    none, all_local = counts(0), counts((2 * crop) ** 2)
    assert none["atomics"] == none["contributions"] == all_local[
        "contributions"]
    nonzero = sum(
        int(torch.count_nonzero(roi.crop_resize_maxpool_grad(
            f[i:i + 1], b[i:i + 1, p:p + 1], g[i:i + 1, p:p + 1], crop, k, s,
            fixed_point=True)))
        for i in range(b.shape[0]) for p in range(b.shape[1]))
    assert all_local["atomics"] == nonzero < all_local["contributions"]
    some = counts(20)["atomics"]
    assert all_local["atomics"] < some < none["atomics"]
    # Chunking changes no count.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roi, "_CHUNK_BYTES", 1)
        assert counts(20)["atomics"] == some


@pytest.mark.parametrize("shape,dtype,local_slots", [
    ((1, 76, 114, 576), torch.bfloat16, 64),
    ((2, 64, 96, 576), torch.float32, 128),
    ((1, 9, 12, 64), torch.bfloat16, 27),  # slot budget 9 x 12 = 108
    ((2, 9, 12, 20), torch.bfloat16, 0),  # the generic kernel
])
def test_grad_atomic_counts_take_the_kernels_rule(shape, dtype, local_slots):
    """The footprints K2 sums in shared memory: those whose int64
    accumulator (8 bytes per channel of the tile) fits the slot budget's
    bytes; the generic kernel sums none."""
    assert roi_pool._local_slots(14, 2, 2, shape, dtype) == local_slots
    features, boxes, grad = _fixed_case(15, b=shape[0], h=9, w=12,
                                        c=shape[-1], crop=14)
    f = torch.from_numpy(features).to(dtype)
    got = roi_pool.grad_atomic_counts(f, torch.from_numpy(boxes),
                                      torch.from_numpy(grad).to(dtype), 14)
    assert got == roi.crop_resize_maxpool_grad_atomics(
        f, torch.from_numpy(boxes), torch.from_numpy(grad).to(dtype), 14, 2,
        2, roi_pool._local_slots(14, 2, 2, f.shape, dtype))
