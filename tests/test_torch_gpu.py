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

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.kernels import pool_grad, roi_pool
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.ops import roi as roi_ops
from cap2det_tpu_torch.train import trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

# float32: both sides do float32 lerps and sums in another order.
# bfloat16: both round float32 values to bfloat16, one bf16 step apart.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-5)}
# The ROI backward adds many contributions of size ~1 into each dF value,
# with atomics on the card and index_add_ in the plain version: the same
# terms in another order.
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1.6e-2, 1e-4)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quantised", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize(
    "shape,num_p,crop,k,s",
    [((2, 9, 12, 20), 13, 14, 2, 2), ((2, 64, 96, 576), 100, 14, 2, 2),
     ((1, 10, 7, 130), 9, 6, 3, 1)],
    ids=["small", "coco_width", "k3s1"])
def test_roi_grad_kernel_matches_plain(cuda, dtype, quantised, shape, num_p,
                                       crop, k, s):
    rng = np.random.default_rng(2)
    feats = (rng.integers(0, 3, shape) if quantised
             else rng.standard_normal(shape)).astype(np.float32)
    feats = torch.from_numpy(feats).to(cuda, dtype)
    boxes = torch.from_numpy(_boxes(rng, shape[0], num_p)).to(cuda)
    pooled = (crop - k) // s + 1
    grad = torch.from_numpy(rng.standard_normal(
        (shape[0], num_p, pooled, pooled, shape[-1]), dtype=np.float32)).to(
            cuda, dtype)
    before = roi_pool.grad_launches
    got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, crop, k, s)
    assert roi_pool.grad_launches == before + 1
    want = roi_ops.crop_resize_maxpool_grad(feats, boxes, grad, crop, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == feats.shape
    rtol, atol = GRAD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize(
    "shape,k,s",
    [((1000, 7, 7, 576), 3, 2), ((1000, 4, 4, 1024), 3, 1),
     ((3, 5, 9, 20), 3, 2), ((4, 6, 8, 7), 2, 2)],
    ids=["mixed5a", "mixed5bc", "odd", "even_kernel"])
def test_pool_grad_kernels_match_plain(cuda, dtype, kind, shape, k, s):
    """Same winners, same f32 summation order: equal up to the tolerance
    (in practice bit for bit). x is quantised for the max form (ties)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 3, shape).astype(np.float32)).to(
        cuda, dtype)
    out_shape = (shape[0], -(-shape[1] // s), -(-shape[2] // s), shape[3])
    g = torch.from_numpy(rng.standard_normal(out_shape, dtype=np.float32)).to(
        cuda, dtype)
    if kind == "pool_max":
        before = pool_grad.maxpool_grad_launches
        got = pool_grad.maxpool_grad(x, g, k, s)
        assert pool_grad.maxpool_grad_launches == before + 1
        want = pool_grad.maxpool_grad_plain(x, g, k, s)
    else:
        before = pool_grad.avgpool_grad_launches
        got = pool_grad.avgpool_grad(x.shape, dtype, g, k, s)
        assert pool_grad.avgpool_grad_launches == before + 1
        want = pool_grad.avgpool_grad_plain(x.shape, dtype, g, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
def test_pool_function_backward_on_the_card(cuda, kind):
    """The Function's gradient on the card equals its CPU gradient (the
    plain versions) for a non-contiguous upstream gradient."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 7, 7, 16)).astype(np.float32)
    g = rng.standard_normal((6, 4, 4, 32)).astype(np.float32)
    grads = []
    for device in (cuda, torch.device("cpu")):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        out = pool_grad.pool_same(xt, kind, 3, 2)
        (dx,) = torch.autograd.grad(
            out, xt, torch.from_numpy(g).to(device)[..., :16])
        grads.append(dx.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_roi_function_backward_on_the_card(cuda):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 9, 12, 40)).astype(np.float32)
    boxes = _boxes(rng, 2, 11)
    grad = rng.standard_normal((2, 11, 7, 7, 80)).astype(np.float32)
    grads = []
    for device in (cuda, torch.device("cpu")):
        f = torch.from_numpy(feats).to(device).requires_grad_(True)
        out = roi_pool.roi_crop_maxpool(f, torch.from_numpy(boxes).to(device),
                                        14)
        (df,) = torch.autograd.grad(
            out, f, torch.from_numpy(grad).to(device)[..., :40])
        grads.append(df.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


_TRAIN_PIPELINE = """
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6 maxpool_kernel_size: 2 maxpool_stride: 2
      dropout_keep_prob: 0.5
    }
    oicr_iterations: 2
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
train_config {
  learning_rate: 0.01
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  %s
}
"""
_UNFREEZE_4E = """gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0 }"""


@pytest.mark.parametrize("unfreeze,want_k2,want_k5",
                         [(_UNFREEZE_4E, 1, 2), ("", 0, 1)],
                         ids=["mixed4e_unfrozen", "full_freeze"])
def test_train_step_launch_counts(cuda, tmp_path, unfreeze, want_k2,
                                  want_k5):
    labels = tmp_path / "labels.txt"
    labels.write_text("person\ndog\ncar\n")
    cfg = schema.loads_pipeline(_TRAIN_PIPELINE % (labels, unfreeze))
    model = registry.build(cfg.model, is_training=True)
    state, opt, _, mask = trainer.TrainState.create(model, cfg.train_config,
                                                    0)
    step = trainer.make_train_step(model, opt, cfg.train_config, mask)
    rng = np.random.default_rng(6)
    y0, x0 = rng.uniform(0, 0.5, (2, 8)), rng.uniform(0, 0.5, (2, 8))
    batch = model.device_batch({
        "image": rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8),
        "proposals": np.stack([y0, x0, y0 + 0.4, x0 + 0.45],
                              -1).astype(np.float32),
        "number_of_proposals": np.array([8, 6], np.int32),
        "pseudo_labels": np.array([[1, 0, 1], [0, 1, 0]], np.float32),
    })
    counts = (roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
              pool_grad.maxpool_grad_launches,
              pool_grad.avgpool_grad_launches)
    state, logs = step(state, batch, 0)
    torch.cuda.synchronize()
    delta = tuple(b - a for a, b in zip(counts, (
        roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
        pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches)))
    assert delta == (1, 3, want_k2, want_k5, 1)
    assert torch.isfinite(logs["loss/total_loss"])
    assert state["step"] == 1
