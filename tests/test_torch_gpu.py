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
from cap2det_tpu_torch.data import pipeline
from cap2det_tpu_torch.kernels import build, pool_grad, roi_pool
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
# in 64-bit fixed point on the card and in float32 with index_add_ in the
# plain version.
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1.6e-2, 1e-4)}


# Beyond the model's shapes: channel counts whose rows are not a multiple
# of 16 bytes (the one-channel path, with a partial last tile), a single
# block (N = 1, one channel tile), and a map too large to stage in shared
# memory (the untiled kernels). The model's shapes, and "odd" in float32
# (a partial tile of 16-byte lanes), cover the vector path.
EXTRA_POOL_SHAPES = [((3, 7, 7, 130), 3, 2), ((2, 4, 4, 1030), 3, 1),
                     ((1, 7, 7, 32), 3, 2), ((1, 4, 4, 1030), 3, 1),
                     ((2, 40, 40, 64), 3, 2)]
EXTRA_POOL_IDS = ["c130", "c1030", "one_block", "n1_c1030", "large_map"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, batch, num_p, kind="mixed"):
    """Seeded boxes: a mix of sizes partly outside the map, or all narrow
    (2-10% of the map) or all wide (50-100%) inside it. The second box is
    reversed (ymin > ymax, xmin > xmax) and the last two are zero padding."""
    if kind == "mixed":
        lo, size = rng.uniform(-0.3, 0.9, (2, batch, num_p)), rng.uniform(
            0.02, 0.8, (2, batch, num_p))
    else:
        span = (0.02, 0.1) if kind == "narrow" else (0.5, 1.0)
        size = rng.uniform(*span, (2, batch, num_p))
        lo = rng.uniform(0.0, 1.0, (2, batch, num_p)) * (1.0 - size)
    y0, x0 = lo
    boxes = np.stack([y0, x0, y0 + size[0], x0 + size[1]], -1)
    boxes[:, : num_p // 3] = np.clip(boxes[:, : num_p // 3], 0.0, 1.0)
    boxes[:, 1] = boxes[:, 1, [2, 3, 0, 1]]
    boxes[:, -2:] = 0.0  # zero padding boxes
    return boxes.astype(np.float32)


def _path_counts():
    return (roi_pool.staged_launches, roi_pool.generic_launches,
            roi_pool.grad_staged_launches, roi_pool.grad_generic_launches)


# K1/K2 cases: the model's shapes (staged kernels) with mixed, all-narrow
# and all-wide boxes, and what only the generic kernels take: rows of C
# channels that are not a multiple of 16 bytes (C = 20 in bf16, 33, 130,
# 1030) and a crop of 40, too large to stage.
ROI_CASES = [((2, 9, 12, 20), 13, 14, 2, 2, "mixed"),
             ((1, 76, 114, 576), 301, 14, 2, 2, "mixed"),
             ((1, 10, 7, 130), 9, 6, 3, 1, "mixed"),
             ((2, 5, 6, 33), 7, 7, 2, 2, "mixed"),
             ((1, 76, 114, 576), 301, 14, 2, 2, "narrow"),
             ((1, 76, 114, 576), 301, 14, 2, 2, "wide"),
             ((1, 64, 64, 64), 9, 40, 2, 2, "mixed"),
             ((1, 12, 14, 1030), 9, 14, 2, 2, "mixed")]
ROI_IDS = ["small", "serving_width", "k3s1", "untiled", "serving_narrow",
           "serving_wide", "crop40_generic", "c1030"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,num_p,crop,k,s,box_kind", ROI_CASES,
                         ids=ROI_IDS)
def test_roi_kernel_matches_plain(cuda, dtype, shape, num_p, crop, k, s,
                                  box_kind):
    """K1 equals its exact oracle bit for bit, and the dense plain version
    within the tolerance; the rule's kernel ran."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    boxes = torch.from_numpy(_boxes(rng, shape[0], num_p, box_kind)).to(cuda)
    before, paths = roi_pool.launches, _path_counts()
    got = roi_pool.roi_crop_maxpool(feats, boxes, crop, k, s)
    assert roi_pool.launches == before + 1
    staged = roi_pool._staged(crop, k, s, shape, dtype)
    assert staged == (shape[-1] * feats.element_size() % 16 == 0
                      and crop <= 32)
    moved = tuple(b - a for a, b in zip(paths, _path_counts()))
    assert moved == ((1, 0, 0, 0) if staged else (0, 1, 0, 0))
    exact = roi_ops.crop_resize_maxpool_exact(feats, boxes, crop, k, s)
    want = roi_ops.crop_resize_maxpool(feats, boxes, crop, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, exact)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize(
    "shape,k,s",
    [((2000, 7, 7, 576), 3, 2), ((2000, 4, 4, 1024), 3, 1),
     ((3, 5, 9, 20), 3, 2), ((4, 6, 8, 7), 2, 2)] + EXTRA_POOL_SHAPES,
    ids=["mixed5a", "mixed5bc", "odd", "even_kernel"] + EXTRA_POOL_IDS)
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
    "shape,num_p,crop,k,s,box_kind",
    [((2, 9, 12, 20), 13, 14, 2, 2, "mixed"),
     ((2, 64, 96, 576), 100, 14, 2, 2, "mixed"),
     ((1, 10, 7, 130), 9, 6, 3, 1, "mixed"),
     ((2, 64, 96, 576), 100, 14, 2, 2, "narrow"),
     ((2, 64, 96, 576), 100, 14, 2, 2, "wide"),
     ((1, 12, 14, 64), 9, 6, 3, 1, "mixed"),
     ((1, 64, 64, 64), 9, 40, 2, 2, "mixed")],
    ids=["small", "coco_width", "k3s1", "coco_narrow", "coco_wide",
         "k3s1_staged", "crop40_generic"])
def test_roi_grad_kernel_matches_plain(cuda, dtype, quantised, shape, num_p,
                                       crop, k, s, box_kind):
    """K2 equals its fixed-point oracle bit for bit, and the float32 plain
    version within the tolerance; the rule's kernel ran."""
    rng = np.random.default_rng(2)
    feats = (rng.integers(0, 3, shape) if quantised
             else rng.standard_normal(shape)).astype(np.float32)
    feats = torch.from_numpy(feats).to(cuda, dtype)
    boxes = torch.from_numpy(_boxes(rng, shape[0], num_p, box_kind)).to(cuda)
    pooled = (crop - k) // s + 1
    grad = torch.from_numpy(rng.standard_normal(
        (shape[0], num_p, pooled, pooled, shape[-1]), dtype=np.float32)).to(
            cuda, dtype)
    before, paths = roi_pool.grad_launches, _path_counts()
    got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, crop, k, s)
    assert roi_pool.grad_launches == before + 1
    staged = roi_pool._staged(crop, k, s, shape, dtype)
    moved = tuple(b - a for a, b in zip(paths, _path_counts()))
    assert moved == ((0, 0, 1, 0) if staged else (0, 0, 0, 1))
    exact = roi_ops.crop_resize_maxpool_grad(feats, boxes, grad, crop, k, s,
                                             fixed_point=True)
    want = roi_ops.crop_resize_maxpool_grad(feats, boxes, grad, crop, k, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == feats.shape
    assert torch.equal(got, exact)
    rtol, atol = GRAD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _pool_grad_counts(kind):
    """(launches, tiled, untiled) of K5 (pool_max) or K6 (pool_avg)."""
    name = "maxpool_grad" if kind == "pool_max" else "avgpool_grad"
    return tuple(getattr(pool_grad, name + suffix) for suffix in
                 ("_launches", "_tiled_launches", "_untiled_launches"))


def _run_pool_grad(kind, x, g, k, s):
    """The kernel and its plain version on x, g; asserts one launch of the
    kernel the host's rule picks (tiled or untiled) and returns (got,
    want, tiled)."""
    dtype = x.dtype
    before = _pool_grad_counts(kind)
    if kind == "pool_max":
        got = pool_grad.maxpool_grad(x, g, k, s)
        want = pool_grad.maxpool_grad_plain(x, g, k, s)
        aligned = build.aligned(x, g)
    else:
        got = pool_grad.avgpool_grad(x.shape, dtype, g, k, s)
        want = pool_grad.avgpool_grad_plain(x.shape, dtype, g, k, s)
        aligned = build.aligned(g)
    tiled = pool_grad._tiled(x.shape, dtype, k, s, kind, aligned)
    after = _pool_grad_counts(kind)
    assert tuple(b - a for a, b in zip(before, after)) == (
        1, int(tiled), int(not tiled))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    return got, want, tiled


# K5/K6 cases: the model's shapes (coco17 N=1000, voc07 N=2000), small
# odd maps, a ragged C = 20 (40 bytes a row in bf16: one channel per lane;
# 80 in float32: a partial tile of 16-byte lanes) and EXTRA_POOL_SHAPES.
MODEL_POOL_SHAPES = [((1000, 7, 7, 576), 3, 2), ((1000, 4, 4, 1024), 3, 1),
                     ((2000, 4, 4, 1024), 3, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
@pytest.mark.parametrize(
    "shape,k,s",
    MODEL_POOL_SHAPES + [((3, 5, 9, 20), 3, 2), ((4, 6, 8, 7), 2, 2),
                         ((5, 4, 4, 20), 3, 1)] + EXTRA_POOL_SHAPES,
    ids=["mixed5a", "mixed5bc", "voc07_mixed5bc", "odd", "even_kernel",
         "ragged_c20"] + EXTRA_POOL_IDS)
def test_pool_grad_kernels_match_plain(cuda, dtype, kind, shape, k, s):
    """Same winners, same divisions, the same float32 sums in the same
    order, rounded once: K5 and K6 equal their plain versions bit for bit
    in both dtypes. x is quantised (ties). The model's shapes take the
    tiled kernel."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 3, shape).astype(np.float32)).to(
        cuda, dtype)
    out_shape = (shape[0], -(-shape[1] // s), -(-shape[2] // s), shape[3])
    g = torch.from_numpy(rng.standard_normal(out_shape, dtype=np.float32)).to(
        cuda, dtype)
    got, want, tiled = _run_pool_grad(kind, x, g, k, s)
    if (shape, k, s) in MODEL_POOL_SHAPES:
        assert tiled
    assert torch.equal(got, want), float((got.float() - want.float()).abs()
                                         .max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["pool_max", "pool_avg"])
def test_pool_grad_kernels_take_a_misaligned_g(cuda, dtype, kind):
    """g one element past a 16-byte boundary (a storage offset of one):
    the tiled kernel runs with one channel per lane and gives the same
    bits."""
    rng = np.random.default_rng(9)
    shape, k, s = (6, 4, 4, 64), 3, 1
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda, dtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    g = flat[1:].view(shape)
    g.copy_(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)))
    assert g.is_contiguous() and not build.aligned(g)
    assert pool_grad._tiling(shape[-1], dtype, aligned=False)[0] is False
    got, want, tiled = _run_pool_grad(kind, x, g, k, s)
    assert tiled
    assert torch.equal(got, want), float((got.float() - want.float()).abs()
                                         .max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,num_p,crop,k,s",
    [((2, 64, 96, 576), 100, 14, 2, 2), ((1, 10, 7, 130), 9, 6, 3, 1)],
    ids=["coco_width", "k3s1"])
def test_roi_grad_kernel_is_deterministic(cuda, dtype, shape, num_p, crop, k,
                                          s):
    """Two launches on the same tie-rich inputs give the same bits."""
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.integers(0, 3, shape).astype(
        np.float32)).to(cuda, dtype)
    boxes = torch.from_numpy(_boxes(rng, shape[0], num_p)).to(cuda)
    pooled = (crop - k) // s + 1
    grad = torch.from_numpy(rng.standard_normal(
        (shape[0], num_p, pooled, pooled, shape[-1]), dtype=np.float32)).to(
            cuda, dtype)
    first = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, crop, k, s)
    again = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, crop, k, s)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


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


@pytest.mark.parametrize("hw,canvas", [((375, 500), (1216, 1824)),
                                       ((37, 53), (416, 608)),
                                       ((800, 1200), (400, 600))],
                         ids=["serve_landscape", "up_x11", "down_2x"])
def test_resize_on_the_card_equals_the_cpu(cuda, hw, canvas):
    """The integer resize gives the same canvas on the card as on the CPU,
    where the CPU tests hold it to cv2 bit for bit."""
    image = np.random.default_rng(8).integers(0, 256, hw + (3,)).astype(
        np.uint8)
    got, got_hw = pipeline.fit_image_to_canvas(
        torch.from_numpy(image).to(cuda), canvas)
    want, want_hw = pipeline.fit_image_to_canvas(image, canvas)
    assert got.is_cuda and got_hw == want_hw
    assert torch.equal(got.cpu(), want)


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
