"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

The kernels have no CPU mode, so every test here needs an NVIDIA GPU and
``nvcc`` and skips without one. This file imports no JAX (the machine with
the card has none); run it there without the repo's JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from cap2det_tpu_torch.kernels import pool_grad, roi_pool
from cap2det_tpu_torch.ops import roi as roi_ops

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

# float32: both sides do float32 lerps and sums in another order.
# bfloat16: both round float32 values to bfloat16, one bf16 step apart.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, batch, num_p):
    y0 = rng.uniform(-0.3, 0.9, (batch, num_p))
    x0 = rng.uniform(-0.3, 0.9, (batch, num_p))
    boxes = np.stack(
        [y0, x0, y0 + rng.uniform(0.02, 0.8, (batch, num_p)),
         x0 + rng.uniform(0.02, 0.8, (batch, num_p))], -1)
    boxes[:, : num_p // 3] = np.clip(boxes[:, : num_p // 3], 0.0, 1.0)
    boxes[:, -2:] = 0.0  # zero padding boxes
    return boxes.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,num_p,crop,k,s",
    [((2, 9, 12, 20), 13, 14, 2, 2),
     ((1, 76, 114, 576), 301, 14, 2, 2),
     ((1, 10, 7, 130), 9, 6, 3, 1),
     ((2, 5, 6, 33), 7, 7, 2, 2)],
    ids=["small", "serving_width", "k3s1", "untiled"])
def test_roi_kernel_matches_plain(cuda, dtype, shape, num_p, crop, k, s):
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    boxes = torch.from_numpy(_boxes(rng, shape[0], num_p)).to(cuda)
    before = roi_pool.launches
    got = roi_pool.roi_crop_maxpool(feats, boxes, crop, k, s)
    assert roi_pool.launches == before + 1
    want = roi_ops.crop_resize_maxpool(feats, boxes, crop, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize(
    "shape,k,s",
    [((2000, 7, 7, 576), 3, 2), ((2000, 4, 4, 1024), 3, 1),
     ((3, 5, 9, 20), 3, 2), ((4, 6, 8, 7), 2, 2)],
    ids=["mixed5a", "mixed5bc", "odd", "even_kernel"])
def test_pool_kernel_matches_plain(cuda, dtype, kind, shape, k, s):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    before = pool_grad.launches
    got = pool_grad.pool_fwd(x, kind, k, s)
    assert pool_grad.launches == before + 1
    want = pool_grad.pool_same_plain(x, kind, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    feats = torch.randn(1, 8, 8, 16, device=cuda)
    boxes = torch.rand(1, 5, 4, device=cuda)
    with pytest.raises(TypeError):
        roi_pool.roi_crop_maxpool(feats.half(), boxes, 14)
    with pytest.raises(TypeError):
        roi_pool.roi_crop_maxpool(feats, boxes.double(), 14)
    with pytest.raises(ValueError, match="contiguous"):
        roi_pool.roi_crop_maxpool(feats.transpose(1, 2), boxes, 14)
    with pytest.raises(ValueError):
        roi_pool.roi_crop_maxpool(feats, boxes.cpu(), 14)
    with pytest.raises(ValueError):
        roi_pool.roi_crop_maxpool(feats, boxes, 100)
    x = torch.randn(4, 7, 7, 16, device=cuda)
    with pytest.raises(TypeError):
        pool_grad.pool_fwd(x.half(), "pool_max", 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pool_grad.pool_fwd(x.transpose(1, 2), "pool_max", 3, 2)
