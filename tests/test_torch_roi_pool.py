"""Plain version of the port's ROI crop+pool kernel (K1) against the JAX
package: the Pallas kernel in interpret mode (rtol 1e-4, the floor set
by its precomputed sampling coordinates) and the XLA reference
``ops.roi.crop_resize_maxpool``."""

import numpy as np
import pytest
import torch

from cap2det_tpu.kernels import roi_pool as jax_roi_pool
from cap2det_tpu.ops import roi as jax_roi
from cap2det_tpu_torch.kernels import roi_pool
from cap2det_tpu_torch.ops import roi

torch.set_num_threads(1)


def _case(seed, batch=2, num_p=13, h=9, w=12, c=20, outside=True):
    rng = np.random.RandomState(seed)
    features = rng.randn(batch, h, w, c).astype(np.float32)
    lo = -0.3 if outside else 0.0
    y0 = rng.uniform(lo, 0.8, (batch, num_p))
    x0 = rng.uniform(lo, 0.8, (batch, num_p))
    boxes = np.stack(
        [y0, x0, y0 + rng.uniform(0.05, 0.6, (batch, num_p)),
         x0 + rng.uniform(0.05, 0.6, (batch, num_p))], -1
    ).astype(np.float32)
    boxes[:, -2:] = 0.0  # zero padding boxes crop the top-left cell
    if outside:
        boxes[0, 0] = [-0.5, -0.5, -0.1, -0.2]  # wholly outside: all zeros
        boxes[1, 0] = [0.7, 0.8, 1.4, 1.3]  # partly outside
    return features, boxes


def _port(features, boxes, crop, k=2, s=2):
    return roi_pool.roi_crop_maxpool(
        torch.from_numpy(features), torch.from_numpy(boxes), crop, k, s
    ).numpy()


@pytest.mark.parametrize("crop", [6, 14])
def test_plain_matches_pallas_interpret(crop):
    features, boxes = _case(0)
    want = np.asarray(jax_roi_pool.roi_crop_maxpool(
        features, boxes, crop, 2, 2, interpret=True))
    got = _port(features, boxes, crop)
    assert got.shape == want.shape == (2, 13, crop // 2, crop // 2, 20)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("crop,k,s", [(14, 2, 2), (6, 3, 1), (7, 2, 2)])
def test_plain_matches_xla_reference(crop, k, s):
    """Including pools that the Pallas kernel does not take (stride !=
    kernel, a crop the pool does not tile): the JAX model runs those on
    the XLA path, and the port's kernel handles them itself."""
    features, boxes = _case(1)
    want = np.asarray(jax_roi.crop_resize_maxpool(features, boxes, crop, k, s))
    got = _port(features, boxes, crop, k, s)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_outside_box_is_zero_and_padding_box_is_corner():
    features, boxes = _case(2)
    got = _port(features, boxes, 6)
    assert np.all(got[0, 0] == 0.0)
    # A zero box samples the top-left cell at every crop position.
    np.testing.assert_allclose(
        got[0, -1], np.broadcast_to(features[0, 0, 0], got[0, -1].shape),
        rtol=1e-6)


def test_crop_and_resize_matches_xla():
    features, boxes = _case(3, num_p=5, outside=False)
    want = np.asarray(jax_roi.crop_and_resize(features, boxes, 7))
    got = roi.crop_and_resize(torch.from_numpy(features),
                              torch.from_numpy(boxes), 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_chunked_plain_equals_unchunked(monkeypatch):
    features, boxes = _case(4)
    whole = _port(features, boxes, 6)
    monkeypatch.setattr(roi, "_CHUNK_BYTES", 1)  # one proposal per chunk
    np.testing.assert_array_equal(_port(features, boxes, 6), whole)


def test_bf16_plain_rounds_the_f32_result():
    features, boxes = _case(5)
    f32 = _port(features, boxes, 6)
    got = roi_pool.roi_crop_maxpool(
        torch.from_numpy(features).bfloat16(), torch.from_numpy(boxes), 6)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(features).bfloat16().float().numpy()
    want = _port(want, boxes, 6)
    np.testing.assert_array_equal(
        got.float().numpy(), torch.from_numpy(want).bfloat16().float().numpy())
    assert np.abs(got.float().numpy() - f32).max() < 0.05


def test_wrapper_contract():
    features, boxes = _case(6)
    f, b = torch.from_numpy(features), torch.from_numpy(boxes)
    before = roi_pool.launches
    for impl in roi_pool.IMPLS:
        np.testing.assert_array_equal(
            roi_pool.roi_crop_maxpool(f, b, 6, impl=impl).numpy(),
            _port(features, boxes, 6))
    assert roi_pool.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="impl"):
        roi_pool.roi_crop_maxpool(f, b, 6, impl="nope")
    with pytest.raises(ValueError, match="at least 2x2"):
        roi_pool.roi_crop_maxpool(f[:, :1], b, 6)
    with pytest.raises(ValueError):
        roi_pool.roi_crop_maxpool(f, b[..., :3], 6)


def _reversed(boxes):
    boxes = boxes.copy()
    boxes[:, 1] = boxes[:, 1, [2, 3, 0, 1]]  # ymin > ymax, xmin > xmax
    return boxes


@pytest.mark.parametrize("crop", [6, 14])
def test_exact_oracle_matches_plain_and_pallas(crop):
    """``crop_resize_maxpool_exact`` (the kernels' sample arithmetic, which
    the CUDA forward equals bit for bit) within the plain version's
    tolerances, with boxes outside the map, a reversed box and zero padding
    boxes."""
    features, boxes = _case(7)
    boxes = _reversed(boxes)
    f, b = torch.from_numpy(features), torch.from_numpy(boxes)
    got = roi.crop_resize_maxpool_exact(f, b, crop, 2, 2).numpy()
    np.testing.assert_allclose(got, _port(features, boxes, crop), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jax_roi_pool.roi_crop_maxpool(
        features, boxes, crop, 2, 2, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # A zero padding box samples the top-left cell everywhere.
    np.testing.assert_array_equal(
        got[0, -1], np.broadcast_to(features[0, 0, 0], got[0, -1].shape))


@pytest.mark.parametrize("crop,k,s", [(6, 3, 1), (7, 2, 2)])
def test_exact_oracle_matches_xla_reference_on_other_pools(crop, k, s):
    features, boxes = _case(8)
    boxes = _reversed(boxes)
    want = np.asarray(jax_roi.crop_resize_maxpool(features, boxes, crop, k, s))
    got = roi.crop_resize_maxpool_exact(
        torch.from_numpy(features), torch.from_numpy(boxes), crop, k, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_exact_oracle_chunks_and_rounds_like_the_kernel(monkeypatch):
    """Chunking changes no bit; bf16 is the float32 result of the
    bf16-rounded map, rounded once."""
    features, boxes = _case(9)
    f, b = torch.from_numpy(features).bfloat16(), torch.from_numpy(boxes)
    whole = roi.crop_resize_maxpool_exact(f, b, 6, 2, 2)
    assert whole.dtype == torch.bfloat16
    assert torch.equal(
        whole, roi.crop_resize_maxpool_exact(f.float(), b, 6, 2, 2).bfloat16())
    monkeypatch.setattr(roi, "_CHUNK_BYTES", 1)  # one proposal per chunk
    assert torch.equal(roi.crop_resize_maxpool_exact(f, b, 6, 2, 2), whole)


@pytest.mark.parametrize("crop,k,s,shape,dtype,aligned,staged", [
    (14, 2, 2, (1, 76, 114, 576), torch.bfloat16, True, True),
    (14, 2, 2, (2, 64, 96, 576), torch.float32, True, True),
    (14, 2, 2, (1, 26, 38, 576), torch.bfloat16, True, True),
    (6, 3, 1, (1, 12, 14, 64), torch.bfloat16, True, True),
    (14, 2, 2, (2, 9, 12, 20), torch.float32, True, True),
    (14, 2, 2, (2, 9, 12, 20), torch.bfloat16, True, False),  # 40-byte rows
    (6, 3, 1, (1, 10, 7, 130), torch.float32, True, False),
    (14, 2, 2, (1, 12, 14, 1030), torch.bfloat16, True, False),
    (14, 2, 2, (1, 76, 114, 576), torch.bfloat16, False, False),
    (20, 2, 2, (1, 64, 64, 64), torch.bfloat16, True, True),
    (21, 3, 2, (1, 64, 64, 64), torch.bfloat16, True, True),
    (32, 1, 1, (1, 64, 64, 64), torch.bfloat16, True, False),  # 224 KB
    (32, 1, 1, (1, 64, 64, 64), torch.float32, True, True),  # 192 KB
    (40, 2, 2, (1, 64, 64, 64), torch.bfloat16, True, False),
    (40, 2, 2, (1, 9, 9, 64), torch.bfloat16, True, False),  # crop > 32
    (17, 17, 1, (1, 20, 20, 64), torch.float32, True, False),  # 289 taps
])
def test_staged_rule(crop, k, s, shape, dtype, aligned, staged):
    """Which kernel K1 and K2 launch, decided on the host."""
    assert roi_pool._staged(crop, k, s, shape, dtype, aligned) is staged
