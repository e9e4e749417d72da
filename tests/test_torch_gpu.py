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

from cap2det_tpu_torch import bench
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline
from cap2det_tpu_torch.eval import evaluator
from cap2det_tpu_torch.kernels import (bn_fold, build, fused_optimizer, nms,
                                       pool_grad, roi_pool)
from cap2det_tpu_torch.models import frcnn, inception_v2, registry, resnet_v1
from cap2det_tpu_torch.ops import nms as nms_ops
from cap2det_tpu_torch.ops import roi as roi_ops
from cap2det_tpu_torch.train import optimizers, trainer
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
             ((1, 12, 14, 1030), 9, 14, 2, 2, "mixed"),
             ((1, 76, 114, 1024), 301, 14, 2, 2, "mixed")]
ROI_IDS = ["small", "serving_width", "k3s1", "untiled", "serving_narrow",
           "serving_wide", "crop40_generic", "c1030", "resnet_width"]


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
     ((1, 64, 64, 64), 9, 40, 2, 2, "mixed"),
     ((2, 64, 96, 1024), 100, 14, 2, 2, "mixed")],
    ids=["small", "coco_width", "k3s1", "coco_narrow", "coco_wide",
         "k3s1_staged", "crop40_generic", "resnet_width"])
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
              pool_grad.avgpool_grad_launches, fused_optimizer.launches,
              bn_fold.launches, bn_fold.grad_launches)
    state, logs = step(state, batch, 0)
    torch.cuda.synchronize()
    delta = tuple(b - a for a, b in zip(counts, (
        roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
        pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches,
        fused_optimizer.launches, bn_fold.launches, bn_fold.grad_launches)))
    # The fused optimizer updates every trainable leaf in one launch; the
    # BN fold is one launch forward and one backward.
    assert delta == (1, 3, want_k2, want_k5, 1, 1, 1, 1)
    assert torch.isfinite(logs["loss/total_loss"])
    assert state["step"] == 1


@pytest.mark.parametrize("full_freeze", [False, True],
                         ids=["mixed4e_unfrozen", "full_freeze"])
def test_second_stage_remat_on_the_card(cuda, monkeypatch, full_freeze):
    """Two bench steps at a small shape (bf16, dropout on), the second
    stage recomputed in the backward against kept: the same losses and
    params bit for bit under deterministic algorithms, and each step's
    launches are ``bench.LAUNCHES``'s for its regime."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    shape = dict(batch=2, canvas_hw=(64, 96), num_proposals=16,
                 num_classes=3, full_freeze=full_freeze)
    runs = []
    try:
        for remat in (False, True):
            step = bench.BenchStep(shape, cuda, second_stage_remat=remat)
            launches = bench.step_launches(step)
            bench.check_launches(launches, full_freeze, cuda, remat)
            losses = [step.logs["loss/total_loss"],
                      step.run()["loss/total_loss"]]
            runs.append((losses, optimizers.flatten_params(
                step.state["params"])))
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    (plain_losses, plain), (losses, params) = runs
    assert all(map(torch.equal, losses, plain_losses))
    assert [p for p, _ in params] == [p for p, _ in plain]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(params, plain))


def test_dropout_divides_as_the_cpu(cuda):
    """keep_prob 0.7 is no power of two: the card's quotient equals the
    CPU's IEEE one, where a Python-scalar divisor was a reciprocal
    multiply, one ulp off in about a tenth of the values."""
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0.5, 2.0, 1 << 20).astype(np.float32))
    gen = torch.Generator(device=cuda).manual_seed(0)
    got = frcnn.dropout(x.to(cuda), 0.7, gen).cpu()
    kept = got != 0
    assert 0.69 < kept.float().mean().item() < 0.71
    want = torch.where(kept, x / torch.tensor(0.7), torch.zeros_like(x))
    assert torch.equal(got, want)


def test_score_mean_over_three_scales_divides_as_the_cpu(cuda, tmp_path):
    """MultiScalePredictor averages three scales' scores: the same scores
    give the same mean on the card as on the CPU (3 is no power of two).
    The model's scores are fixed per scale, so only the mean differs."""
    labels = tmp_path / "labels.txt"
    labels.write_text("person\ndog\ncar\n")
    cfg = schema.loads_pipeline((_TRAIN_PIPELINE % (labels, "")).replace(
        "oicr_iterations: 2", "oicr_iterations: 2 eval_min_dimension: 96 "
        "eval_min_dimension: 64 eval_min_dimension: 48 "
        "midn_post_processor { max_size_per_class: 5 max_total_size: 10 } "
        "oicr_post_processor { max_size_per_class: 5 max_total_size: 10 }"))
    rng = np.random.default_rng(10)
    num_p = 200
    scales = [{"oicr_proposal_scores_at_%d" % i: rng.standard_normal(
        (1, num_p, 3 + (i > 0))).astype(np.float32) for i in range(3)}
        for _ in range(3)]
    example = {"image": rng.integers(0, 256, (50, 70, 3)).astype(np.uint8),
               "proposals": np.sort(rng.uniform(0, 1, (num_p, 2, 2)),
                                    axis=1).reshape(num_p, 4)[:, [0, 2, 1, 3]]
               .astype(np.float32)}
    means = {}
    for device in ("cuda", "cpu"):
        model = registry.build(cfg.model, compute_dtype=torch.float32,
                               device=device)
        calls = iter(scales)
        model.predictions = lambda prepared, batch, _dev=device: {
            k: torch.from_numpy(v).to(_dev) for k, v in next(calls).items()}
        predictor = evaluator.MultiScalePredictor(
            model, model.init_params(0), schema.Cap2DetReader.from_dict(
                {"max_num_proposals": num_p}))
        means[device] = predictor.predict(example)["proposal_scores"]
    assert set(means["cuda"]) == set(scales[0])
    for key, want in means["cpu"].items():
        total = scales[0][key] + scales[1][key] + scales[2][key]
        np.testing.assert_array_equal(want, total / np.float32(3))
        np.testing.assert_array_equal(means["cuda"][key], want)


_EVAL_PIPELINE = """
eval_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: false
    batch_size: 1
    max_num_proposals: 40
  }
}
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2
      dropout_keep_prob: 1.0 dropout_on_feature_map: false
    }
    fc_hyperparams {
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 2
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 10 max_total_size: 20
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 10 max_total_size: 20
    }
    eval_min_dimension: 96
    eval_min_dimension: 64
    label_extractor { groundtruth_extractor { label_file: '%(labels)s' } }
  }
}
"""


def _eval_setup(tmp_path, num_examples=3):
    from cap2det_tpu_torch.data import synthetic

    classes = ["person", "dog", "car"]
    record = synthetic.write_synthetic_dataset(
        str(tmp_path / "eval.record"), num_examples=num_examples, seed=4,
        classes=classes, image_hw=(90, 120), num_proposals=40)
    labels = synthetic.write_label_file(str(tmp_path / "labels.txt"),
                                        classes)
    return schema.loads_pipeline(_EVAL_PIPELINE % {"record": record,
                                                   "labels": labels})


def test_update_params_prepares_again_on_the_card(cuda, tmp_path):
    cfg = _eval_setup(tmp_path, num_examples=1)
    reader = cfg.eval_reader.cap2det_reader
    model = registry.build(cfg.model, compute_dtype=torch.float32)
    example = next(pipeline.InputPipeline(reader, prefetch=0)
                   .example_stream())
    first, second = model.init_params(0), model.init_params(1)
    predictor = evaluator.MultiScalePredictor(model, None, reader)
    predictor.update_params(first)
    before = predictor.predict(example)["proposal_scores"]
    predictor.update_params(second)
    got = predictor.predict(example)["proposal_scores"]
    want = evaluator.MultiScalePredictor(model, second, reader).predict(
        example)["proposal_scores"]
    for key, w in want.items():
        # The same float32 forward twice on the card.
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-7)
        assert np.abs(got[key] - before[key]).max() > 1e-4 * np.abs(w).max()


def test_run_evaluation_launch_counts(cuda, tmp_path):
    """Per image: K1 once and K4 three times per scale, NMS once per OICR
    iteration (three); no backward kernel; one BN fold for the set of
    params."""
    cfg = _eval_setup(tmp_path)
    model = registry.build(cfg.model)
    counts = (roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
              pool_grad.maxpool_grad_launches,
              pool_grad.avgpool_grad_launches, nms.launches,
              bn_fold.launches, bn_fold.grad_launches)
    metrics, maps = evaluator.run_evaluation(cfg, model.init_params(0),
                                             model=model)
    torch.cuda.synchronize()
    delta = tuple(b - a for a, b in zip(counts, (
        roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
        pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches,
        nms.launches, bn_fold.launches, bn_fold.grad_launches)))
    assert delta == (2 * 3, 3 * 2 * 3, 0, 0, 0, 3 * 3, 1, 0)
    assert metrics["num_examples"] == 3 and len(maps) == 3


def test_postprocess_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The card's averaged scores, postprocessed on the CPU, give the
    card's detections bit for bit."""
    cfg = _eval_setup(tmp_path, num_examples=1)
    reader = cfg.eval_reader.cap2det_reader
    model = registry.build(cfg.model)
    example = next(pipeline.InputPipeline(reader, prefetch=0)
                   .example_stream())
    out = evaluator.MultiScalePredictor(model, model.init_params(0),
                                        reader).predict(example)
    cpu_model = registry.build(cfg.model, device="cpu")
    want = cpu_model.postprocess(
        {k: torch.from_numpy(v) for k, v in out["proposal_scores"].items()},
        torch.from_numpy(out["proposals"])[None],
        torch.tensor([out["num_proposals"]]))
    for key, w in want.items():
        np.testing.assert_array_equal(out[key], w[0].numpy(), err_msg=key)


def test_softmax_on_the_card_equals_the_cpu(cuda):
    """ops/softmax.py gives the CPU's bits on the card, where
    torch.softmax differs in about a third of the values."""
    from cap2det_tpu_torch.ops import softmax

    x = torch.from_numpy(np.random.default_rng(11).normal(
        0, 3, (50, 2000, 21)).astype(np.float32))
    assert torch.equal(softmax.softmax(x.to(cuda)).cpu(), softmax.softmax(x))


# -- the text model ------------------------------------------------------------


@pytest.mark.parametrize("keep", [0.5, 0.7])
def test_text_dropout_divides_as_the_cpu(cuda, keep):
    """The text classifier's dropout on its [batch 20, hidden 400] pooled
    features: the card's quotient equals the CPU's IEEE one at the
    configs' 0.5 and at 0.7, no power of two."""
    from cap2det_tpu_torch.text import classifier

    x = torch.from_numpy(np.random.default_rng(12).uniform(
        0.0, 3.0, (20, 400)).astype(np.float32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    got = classifier.dropout(x.to(cuda), keep, gen).cpu()
    kept = got != 0
    assert abs(kept.float().mean().item() - keep) < 0.03
    want = torch.where(kept, x / torch.tensor(keep), torch.zeros_like(x))
    assert torch.equal(got, want)


def _text_tree(num_words=300, dims=32, hidden=40, classes=8, seed=13):
    from cap2det_tpu_torch.text import classifier

    rng = np.random.default_rng(seed)
    table = classifier.build_embedding_table(rng.standard_normal(
        (num_words, dims)).astype(np.float32))
    tree = classifier.init_params_numpy(seed, num_words + 1, dims, hidden,
                                        classes, table)
    tree["text_classifier"]["layer2"]["weights"] *= 3.0
    return tree


def test_text_classifier_on_the_card_equals_the_cpu(cuda):
    """float32 logits of classifier.apply, the card against the CPU (TF32
    off; the products sum in another order): rtol 1e-5, atol 1e-6. An
    all-OOV caption included."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.text import classifier

    tree = _text_tree()
    ids = np.random.default_rng(14).integers(0, 301, (20, 64)).astype(
        np.int32)
    ids[0] = 300
    want = classifier.apply(params_lib.from_jax_numpy(tree, "cpu"),
                            torch.from_numpy(ids), 300)
    got = classifier.apply(params_lib.from_jax_numpy(tree, cuda),
                           torch.from_numpy(ids).to(cuda), 300)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_text_extractor_labels_on_the_card_equal_the_cpu(cuda, tmp_path):
    """TextClassifierMatchExtractor on the card and on the CPU give the
    same labels on seeded captions whose probabilities keep at least 1e-4
    from the 0.7 threshold (asserted on the CPU's)."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.text import extractors

    words = ["w%d" % i for i in range(300)]
    (tmp_path / "vocab.txt").write_text("\n".join(words))
    (tmp_path / "labels.txt").write_text("\n".join(
        "class%d" % i for i in range(8)))
    np.save(tmp_path / "emb.npy", np.random.default_rng(13).standard_normal(
        (300, 32)).astype(np.float32))
    options = schema.TextClassifierMatchExtractor.from_dict({
        "label_file": str(tmp_path / "labels.txt"),
        "open_vocabulary_file": str(tmp_path / "vocab.txt"),
        "open_vocabulary_word_embedding_file": str(tmp_path / "emb.npy"),
        "hidden_units": 40, "label_threshold": 0.7})
    tree = _text_tree()
    rng = np.random.default_rng(15)
    texts = [[words[i] for i in rng.integers(0, 300, rng.integers(1, 20))]
             for _ in range(200)]
    on_cpu = extractors.TextClassifierMatchExtractor(options, device="cpu")
    on_cpu.set_params(params_lib.from_jax_numpy(tree, "cpu"))
    logits = on_cpu.predict_logits(on_cpu.encode_tokens(texts)).numpy()
    margin = np.abs(1 / (1 + np.exp(-logits)) - 0.7).min(axis=1)
    texts = [t for t, m in zip(texts, margin) if m > 1e-4]
    assert len(texts) > 150
    on_card = extractors.TextClassifierMatchExtractor(options, device=cuda)
    on_card.set_params(params_lib.from_jax_numpy(tree, cuda))
    want = on_cpu.extract_labels(texts)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(on_card.extract_labels(texts), want)


def test_host_library_builds_on_the_card_machine(cuda, tmp_path, monkeypatch):
    """Selective search's host library builds from csrc/host/ into a clean
    directory with the host compiler of the machine beside the card, and
    two calls give identical boxes and label maps. (It runs on the host:
    the card takes no part; the fixture only places the test there.)"""
    from cap2det_tpu_torch import native

    monkeypatch.setattr(build, "HOST_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_host_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    rng = np.random.default_rng(21)
    image = rng.normal(110, 12, (120, 160, 3)).clip(0, 255).astype(np.uint8)
    image[20:70, 30:90] = (200, 40, 40)
    first = native.selective_search(image, seed=3)
    assert build.host_build_info["built"]
    assert (tmp_path / build.host_build_info["key"]
            / build.HOST_LIB_NAME).is_file()
    assert len(first) > 10
    np.testing.assert_array_equal(native.selective_search(image, seed=3),
                                  first)
    np.testing.assert_array_equal(native.felzenszwalb(image, 100.0, 20),
                                  native.felzenszwalb(image, 100.0, 20))


# -- the fused optimizer -------------------------------------------------------

_OPTIMIZERS = {
    "sgd": "sgd {}",
    "adagrad": "adagrad { initial_accumulator_value: 0.1 }",
    "adam": "adam { beta1: 0.8 beta2: 0.99 epsilon: 0.001 }",
    "rmsprop": "rmsprop { decay: 0.9 epsilon: 0.01 }",
    "rmsprop_centered_momentum": ("rmsprop { decay: 0.9 epsilon: 0.01 "
                                  "centered: true momentum: 0.5 }"),
    "momentum": "momentum { momentum: 0.9 }",
    "nesterov": "momentum { momentum: 0.9 use_nesterov: true }",
}
# Under clipping the leaf's norm is summed in another order than
# torch.sum's, so the factor, and what follows, may differ in the last
# bits: held within this many ulps of each leaf's largest magnitude.
CLIP_ULPS = 8.0


def _fused_leaves(rng):
    """70 leaves (two launch groups): 3x3 convolution weights whose
    gradients arrive channels-last, 1x1 weights, betas, a 2-D head and
    one leaf of several chunks; multipliers 3 and 1."""
    shapes = []
    for i in range(70):
        shapes.append([(48, 32, 3, 3), (64, 40, 1, 1), (96,), (1024, 3),
                       (300, 200)][i % 5] if i != 7 else (352, 1024, 1, 1))
    paths = ["leaf%02d" % i for i in range(70)]
    mults = [3.0 if i % 4 == 0 else 1.0 for i in range(70)]
    return paths, shapes, mults


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "clip"])
@pytest.mark.parametrize("kind", list(_OPTIMIZERS))
def test_fused_optimizer_kernel_matches_plain(cuda, kind, clip):
    """Ten chained updates, kernel against ``fused_update_reference`` on
    the same inputs: params and slots bit for bit (within CLIP_ULPS with
    clipping)."""
    rng = np.random.default_rng(31)
    paths, shapes, mults = _fused_leaves(rng)
    rule = optimizers.build_base_optimizer(schema.loads_pipeline(
        "train_config { optimizer { %s } }" % _OPTIMIZERS[kind]
    ).train_config.optimizer)
    leaf_set = fused_optimizer.LeafSet(paths, shapes, mults)
    assert len(leaf_set.groups) == 2
    init = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
            for s in shapes]
    runs = []
    for launch in (fused_optimizer.fused_update,
                   fused_optimizer.fused_update_reference):
        params = [p.to(cuda) for p in init]
        slots = rule.init(torch.empty(leaf_set.total, device=cuda))
        step_rng = np.random.default_rng(32)
        before = fused_optimizer.launches
        for count in range(10):
            grads = []
            for s in shapes:
                g = torch.from_numpy(step_rng.normal(0, 1.0, s).astype(
                    np.float32)).to(cuda)
                if len(s) == 4 and s[2] == 3:
                    g = g.contiguous(memory_format=torch.channels_last)
                grads.append(g)
            launch(rule, leaf_set, params, grads, slots,
                   0.01 * 0.5 ** (count // 3), count, clip)
        torch.cuda.synchronize()
        runs.append((params, slots, fused_optimizer.launches - before))
    (got, got_slots, launches), (want, want_slots, _) = runs
    assert launches == 10 * 2 * (1 + (clip is not None))
    limit = 0.0 if clip is None else CLIP_ULPS
    for path, a, b in zip(paths, got, want):
        assert fused_optimizer.ulp_gap(a, b) <= limit, path
    for name in want_slots:
        for off, n in zip(leaf_set.offsets, leaf_set.numels):
            assert fused_optimizer.ulp_gap(
                got_slots[name][off:off + n],
                want_slots[name][off:off + n]) <= limit, name


# -- greedy NMS ----------------------------------------------------------------


def _nms_case(name):
    """(boxes [B, P, 4], scores [B, P, C], score_thresh, iou_thresh, cap)
    of an edge case, seeded; scores without ties unless the case is about
    them."""
    rng = np.random.default_rng(len(name))

    def inputs(valid, num_p, num_c):
        lo = rng.uniform(0.0, 0.8, (len(valid), num_p, 2))
        boxes = np.concatenate(
            [lo, lo + rng.uniform(0.05, 0.5, lo.shape)], -1).astype(
                np.float32)
        boxes[:, 1:2] = boxes[:, 1:2, [2, 3, 0, 1]]  # one box reversed
        scores = np.zeros((len(valid), num_p, num_c), np.float32)
        for b, n in enumerate(valid):
            boxes[b, n:] = 0.0
            rank = np.argsort(rng.random((n, num_c)), axis=0)
            scores[b, :n] = (rank + 1) / (n + 1)
        return boxes, scores

    if name == "p1_c1":
        boxes, scores = inputs([1], 1, 1)
        return boxes, scores, 1e-5, 0.3, 100
    if name == "p_not_a_block_multiple":
        return (*inputs([290], 300, 3), 1e-5, 0.3, 100)
    # 68,000 bytes of ranks in a one-block-per-class kernel; the staged
    # walk takes 51,200 (it opts in above 48 KB from P = 3,969).
    if name == "opt_in_shared_memory":
        return (*inputs([4000], 4000, 2), 1e-5, 0.3, 100)
    if name == "no_candidates":
        boxes, scores = inputs([50], 50, 4)
        return boxes, scores * 0.0, 1e-5, 0.3, 100
    if name == "all_candidates":
        return (*inputs([64], 64, 4), 0.0, 0.3, 100)
    if name == "scores_at_the_threshold":
        boxes, _ = inputs([64], 64, 4)
        scores = np.ceil(rng.random((1, 64, 4)) * 4).astype(np.float32) / 4
        return boxes, scores, 0.25, 0.3, 100  # 0.25 is no candidate
    if name == "iou_at_the_threshold":
        boxes, scores = inputs([8], 8, 2)
        # Pairs whose IoU is exactly 0.5 and exactly 0.25 in float32.
        boxes[0, :4] = [[0, 0, 1, 1], [0, 0, 1, 0.5], [2, 2, 3, 3],
                        [2, 2, 3, 2.25]]
        scores[0, :4] = [[0.99, 0.99], [0.98, 0.98], [0.97, 0.97],
                         [0.96, 0.96]]
        return boxes, scores, 1e-5, 0.5, 100
    if name == "iou_at_the_lower_threshold":
        boxes, scores, st, _, cap = _nms_case("iou_at_the_threshold")
        return boxes, scores, st, 0.25, cap
    if name == "zero_area":
        boxes, scores = inputs([30], 30, 3)
        boxes[0, ::2] = np.tile(boxes[0, ::2, :2], 2)  # points
        boxes[0, 1::4] = [0.5, 0.5, 0.5, 0.5]  # the same point
        return boxes, scores, 1e-5, 0.3, 100
    if name == "non_finite":
        boxes, scores = inputs([40], 40, 3)
        boxes[0, 3, 1] = np.nan
        boxes[0, 5] = [-np.inf, 0.1, np.inf, 0.4]
        boxes[0, 6, 2] = np.inf
        scores[0, 7, 0] = np.nan
        return boxes, scores, 1e-5, 0.3, 100
    if name.startswith("cap_"):
        cap = {"cap_0": 0, "cap_1": 1, "cap_p": 60, "cap_above_p": 10 ** 12}
        return (*inputs([60], 60, 3), 1e-5, 0.3, cap[name])
    if name == "batch_valid_counts":
        return (*inputs([120, 37, 0], 128, 5), 1e-5, 0.4, 8)
    if name == "tied_scores":
        boxes, _ = inputs([200], 200, 4)
        scores = np.ceil(rng.random((1, 200, 4)) * 3).astype(np.float32) / 3
        return boxes, scores, 1e-5, 0.3, 100
    raise ValueError(name)


_NMS_CASES = ["p1_c1", "p_not_a_block_multiple", "opt_in_shared_memory",
              "no_candidates", "all_candidates", "scores_at_the_threshold",
              "iou_at_the_threshold", "iou_at_the_lower_threshold",
              "zero_area", "non_finite", "cap_0", "cap_1", "cap_p",
              "cap_above_p", "batch_valid_counts", "tied_scores"]


@pytest.mark.parametrize("name", _NMS_CASES)
def test_nms_kernel_matches_plain(cuda, name):
    """The kernel's mask and batch_multiclass_nms's four outputs equal the
    plain version's on the card bit for bit, in one launch."""
    boxes, scores, score_thresh, iou_thresh, cap = _nms_case(name)
    boxes, scores = (torch.from_numpy(boxes).to(cuda),
                     torch.from_numpy(scores).to(cuda))
    before = nms.launches
    got = nms.nms_mask(boxes, scores, score_thresh, iou_thresh, cap)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    want = nms.plain_nms_mask(boxes, scores, score_thresh, iou_thresh, cap)
    assert torch.equal(got, want)
    assert nms.launches == before + 1
    outs = nms_ops.batch_multiclass_nms(
        boxes, scores, score_thresh=score_thresh, iou_thresh=iou_thresh,
        max_size_per_class=cap, max_total_size=25)
    for a, b in zip(outs, nms_ops.merge_detections(boxes, scores, want, 25)):
        # Bit for bit; a NaN box equals itself.
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # An IoU equal to the threshold does not overlap (strict >).
    if name == "iou_at_the_threshold":
        assert got[0, :4, 0].tolist() == [True, True, True, True]
    if name == "iou_at_the_lower_threshold":
        assert got[0, :4, 0].tolist() == [True, False, True, True]
    if name in ("no_candidates", "cap_0"):
        assert not got.any()
    if name == "scores_at_the_threshold":
        assert not got[scores <= score_thresh].any()


@pytest.mark.parametrize("name", _NMS_CASES)
def test_nms_walk_kernel_matches_plain_walk(cuda, name):
    """The walk kernel alone, over the plain overlap bits, equals the
    walk's plain version bit for bit; it counts no launch."""
    boxes, scores, score_thresh, iou_thresh, cap = _nms_case(name)
    boxes, scores = (torch.from_numpy(boxes).to(cuda),
                     torch.from_numpy(scores).to(cuda))
    bits = nms.plain_overlap_bits(boxes, iou_thresh)
    order = nms.rank_order(scores)
    before = nms.launches
    got = nms._launch_walk(bits, scores, order, score_thresh, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, nms.plain_walk(bits, order, scores,
                                           score_thresh, cap))
    assert nms.launches == before


@pytest.mark.parametrize("num_p", [1, 33, 2000, 2001, 13613])
def test_nms_bits_kernel_matches_plain(cuda, num_p):
    """The mask kernel's words equal plain_overlap_bits' bit for bit, the
    bits past P and the pad words included, at one box, a word and one, the serve shape,
    one past it and the old kernel's limit of 13,613 proposals."""
    rng = np.random.default_rng(num_p)
    lo = rng.uniform(0.0, 0.8, (2, num_p, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.02, 0.5, lo.shape)],
                           -1).astype(np.float32)
    boxes[1, 0] = boxes[1, 0, [2, 3, 0, 1]]  # a reversed box
    boxes[:, max(1, num_p // 2):] = 0.0  # padded proposals: zero boxes
    boxes = torch.from_numpy(boxes).to(cuda)
    for iou_thresh in (0.3, 0.4):
        got = nms._launch_bits(boxes, iou_thresh)
        torch.cuda.synchronize()
        assert got.shape == (2, num_p, nms.row_words(num_p))
        assert torch.equal(got, nms.plain_overlap_bits(boxes, iou_thresh))
    assert nms.scratch_bytes(2, num_p) == got.numel() * 4


@pytest.mark.parametrize("name", _NMS_CASES)
def test_nms_bits_kernel_mirrors_tiles_exactly(cuda, name):
    """The mask kernel tests each pair of 32-box tiles once and writes
    both orientations: on every edge case's boxes (zero-area, reversed,
    NaN and infinite ones among them) its words equal the plain version's,
    which computes every pair, and the mask is symmetric."""
    boxes, _, _, iou_thresh, _ = _nms_case(name)
    boxes = torch.from_numpy(boxes).to(cuda)
    got = nms._launch_bits(boxes, iou_thresh)
    torch.cuda.synchronize()
    assert torch.equal(got, nms.plain_overlap_bits(boxes, iou_thresh))
    num_p = boxes.shape[1]
    shifts = torch.arange(32, device=cuda, dtype=torch.int32)
    over = ((got[..., None] >> shifts) & 1).bool().flatten(-2)[..., :num_p]
    assert torch.equal(over, over.transpose(1, 2))


@pytest.mark.parametrize("num_p", [13613, nms.MAX_PROPOSALS])
def test_nms_accepts_the_old_limit(cuda, num_p):
    """P = 13,613, the one-block-per-class kernel's limit (~23 MB of
    scratch), and the walk's own limit (over 48 KB of shared memory,
    opted in), through nms_mask: one launch, bit for bit with the plain
    pass."""
    rng = np.random.default_rng(13)
    boxes = torch.from_numpy(np.clip(_boxes(rng, 1, num_p), 0.0, 1.0)).to(
        cuda)
    scores = torch.from_numpy(rng.random((1, num_p, 1), np.float32)).to(cuda)
    assert nms.scratch_bytes(1, num_p) == num_p * nms.row_words(num_p) * 4
    assert nms.scratch_bytes(1, 13613) == 13613 * 428 * 4
    before = nms.launches
    got = nms.nms_mask(boxes, scores, 1e-5, 0.3, 100)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(got, nms.plain_nms_mask(boxes, scores, 1e-5, 0.3,
                                               100))
    assert got.sum() == 100


def test_nms_refuses_a_p_beyond_shared_memory(cuda):
    num_p = nms.MAX_PROPOSALS + 1
    before = nms.launches
    with pytest.raises(ValueError, match=str(nms.MAX_PROPOSALS)):
        nms.nms_mask(torch.zeros(1, num_p, 4, device=cuda),
                     torch.zeros(1, num_p, 1, device=cuda), 1e-5, 0.3, 100)
    assert nms.launches == before


# -- the BN fold ------------------------------------------------------------


def _fold_leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _fold_leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _fold_convs(cuda, regime):
    """Both stages' convolutions as ``bn_fold.fold`` takes them, with
    seeded weights and BN statistics on the card, and the leaves that
    require gradients: the weights and betas of coco17_extend_match's
    Mixed_4e and second stage, of voc07_inc2's second stage, or none."""
    from cap2det_tpu_torch import params as params_lib

    rng = np.random.default_rng(8)
    tree = {frcnn.FIRST_SCOPE: inception_v2.init_first_stage_params_numpy(rng),
            frcnn.SECOND_SCOPE:
                inception_v2.init_second_stage_params_numpy(rng)}
    for path, leaf in _fold_leaves(tree):
        if path[-1] == "moving_variance":
            leaf[...] = rng.uniform(0.01, 2.0, leaf.shape)
        elif path[-1] in ("moving_mean", "beta"):
            leaf[...] = rng.normal(0.0, 1.0, leaf.shape)
    params = params_lib.from_jax_numpy(tree, cuda)
    for path, leaf in _fold_leaves(params):
        scope_trains = {"coco17": path[0] == frcnn.SECOND_SCOPE
                        or "Mixed_4e" in path,
                        "voc07": path[0] == frcnn.SECOND_SCOPE,
                        "none": False}[regime]
        leaf.requires_grad_(scope_trains and path[-1] in ("weights", "beta"))
    slots = []
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        bn_fold.gather(params[scope], slots)
    convs = [(w, bn["beta"], bn["moving_mean"], bn["moving_variance"])
             for _, _, w, bn in slots]
    return convs, [t for c in convs for t in c[:2] if t.requires_grad]


def _fold_plain(convs, dtype, eps=bn_fold.BN_EPSILON):
    """``bn_fold.fold``'s plain version, with its arguments: each conv
    (weights, beta, mean, var[, gamma])."""
    return [bn_fold.fold_reference(*c[:4], dtype, *c[4:], eps=eps)
            for c in convs]


@pytest.mark.parametrize("regime", ["coco17", "voc07", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bn_fold_kernels_match_plain(cuda, dtype, regime):
    """The fold of both stages in one launch against the per-convolution
    chain on the card: outputs bit for bit with the same strides, and the
    trainable leaves' gradients bit for bit from the same upstream
    gradients (channels-last beyond 1x1, as cuDNN gives them), in one
    more launch."""
    convs, leaves = _fold_convs(cuda, regime)
    assert len(convs) == 69
    assert len(leaves) == {"coco17": 52, "voc07": 38, "none": 0}[regime]
    runs = []
    for fn in (bn_fold.fold, _fold_plain):
        before = (bn_fold.launches, bn_fold.grad_launches)
        outs = [t for pair in fn(convs, dtype) for t in pair]
        diff = [t for t in outs if t.requires_grad]
        grads = ()
        if leaves:
            gen = torch.Generator(device=cuda).manual_seed(9)
            upstream = []
            for t in diff:
                g = torch.randn(t.shape, generator=gen, device=cuda).to(dtype)
                if t.dim() == 4 and t.shape[-1] > 1:
                    g = g.contiguous(memory_format=torch.channels_last)
                upstream.append(g)
            grads = torch.autograd.grad(diff, leaves, upstream)
        torch.cuda.synchronize()
        runs.append((outs, len(diff), grads,
                     (bn_fold.launches - before[0],
                      bn_fold.grad_launches - before[1])))
    (got, got_diff, got_g, launched), (want, want_diff, want_g, _) = runs
    assert launched == (1, int(bool(leaves)))
    assert got_diff == want_diff == len(leaves)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == dtype, i
        assert a.shape == b.shape and a.stride() == b.stride(), i
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.shape == b.shape and torch.equal(a, b), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bn_fold_resnet_kernels_match_plain(cuda, dtype):
    """ResNet-101's 104 convolutions, each with a gamma, at epsilon 1e-5
    and seeded BN statistics, in one launch against ``fold_reference``:
    outputs bit for bit; from the same upstream gradients the weights',
    betas' and gammas' gradients of coco17_resnet101's trainable set
    (block3, block4) bit for bit with ``fold_grad_reference``'s, gamma's
    summed in ``channel_sum``'s order, in one more launch."""
    from cap2det_tpu_torch import params as params_lib

    rng = np.random.default_rng(10)
    tree = {frcnn.FIRST_SCOPE: resnet_v1.init_first_stage_params_numpy(rng),
            frcnn.SECOND_SCOPE: resnet_v1.init_second_stage_params_numpy(rng)}
    for path, leaf in _fold_leaves(tree):
        if path[-1] == "moving_variance":
            leaf[...] = rng.uniform(0.01, 2.0, leaf.shape)
        elif path[-1] in ("moving_mean", "beta", "gamma"):
            leaf[...] = rng.normal(0.0, 1.0, leaf.shape)
    params = params_lib.from_jax_numpy(tree, cuda)
    for path, leaf in _fold_leaves(params):
        leaf.requires_grad_(path[-1] in ("weights", "beta", "gamma") and (
            path[0] == frcnn.SECOND_SCOPE or "block3" in path))
    slots = []
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        bn_fold.gather(params[scope], slots)
    convs = [(w, bn["beta"], bn["moving_mean"], bn["moving_variance"],
              bn["gamma"]) for _, _, w, bn in slots]
    leaves = [t for c in convs for t in (c[0], c[1], c[4]) if t.requires_grad]
    assert (len(convs), len(leaves)) == (104, 240)
    runs = []
    for fn in (lambda: bn_fold.fold(convs, dtype, resnet_v1.BN_EPSILON),
               lambda: [bn_fold.fold_reference(*c[:4], dtype, c[4],
                                               resnet_v1.BN_EPSILON)
                        for c in convs]):
        before = (bn_fold.launches, bn_fold.grad_launches)
        outs = [t for pair in fn() for t in pair]
        diff = [t for t in outs if t.requires_grad]
        gen = torch.Generator(device=cuda).manual_seed(11)
        upstream = []
        for t in diff:
            g = torch.randn(t.shape, generator=gen, device=cuda).to(dtype)
            if t.dim() == 4 and t.shape[-1] > 1:
                g = g.contiguous(memory_format=torch.channels_last)
            upstream.append(g)
        grads = torch.autograd.grad(diff, leaves, upstream)
        torch.cuda.synchronize()
        runs.append((outs, len(diff), grads,
                     (bn_fold.launches - before[0],
                      bn_fold.grad_launches - before[1])))
    (got, got_diff, got_g, launched), (want, want_diff, want_g, _) = runs
    assert launched == (1, 1)
    assert got_diff == want_diff == 2 * 80
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == dtype, i
        assert a.shape == b.shape and a.stride() == b.stride(), i
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.shape == b.shape and torch.equal(a, b), i


@pytest.mark.parametrize("full_freeze", [False, True],
                         ids=["mixed4e_unfrozen", "full_freeze"])
def test_bn_fold_step_matches_the_chain(cuda, monkeypatch, full_freeze):
    """Two bench steps at a small shape (bf16, dropout on) with the fold's
    kernels against the per-convolution chain: the same losses and params
    bit for bit under deterministic algorithms."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    shape = dict(batch=2, canvas_hw=(64, 96), num_proposals=16,
                 num_classes=3, full_freeze=full_freeze)
    runs = []
    try:
        for fn in (bn_fold.fold, _fold_plain):
            monkeypatch.setattr(bn_fold, "fold", fn)
            step = bench.BenchStep(shape, cuda)
            losses = [step.run()["loss/total_loss"] for _ in range(2)]
            runs.append((losses, optimizers.flatten_params(
                step.state["params"])))
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    (losses, params), (plain_losses, plain) = runs
    assert all(map(torch.equal, losses, plain_losses))
    assert [p for p, _ in params] == [p for p, _ in plain]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(params, plain))


def test_bn_fold_raises_on_what_the_kernels_do_not_take(cuda):
    w = torch.randn(8, 4, 3, 3, device=cuda)
    beta, mean = torch.randn(8, device=cuda), torch.randn(8, device=cuda)
    var = torch.rand(8, device=cuda) + 0.5
    with pytest.raises(TypeError, match="dtype"):
        bn_fold.fold([(w, beta, mean, var)], torch.float16)
    with pytest.raises(ValueError, match="taps packed"):
        bn_fold.fold([(w.transpose(2, 3), beta, mean, var)])
    with pytest.raises(ValueError, match="float32"):
        bn_fold.fold([(w, beta.cpu(), mean, var)])
    with pytest.raises(ValueError, match="BN vector"):
        bn_fold.fold([(w, beta[:4], mean, var)])
    with pytest.raises(ValueError, match="moving statistics"):
        bn_fold.fold([(w.requires_grad_(), beta, mean,
                       var.requires_grad_())])
    weight, bias = bn_fold.fold([(w, beta, mean, var.detach())])[0]
    with pytest.raises(ValueError, match="neither contiguous"):
        torch.autograd.grad(weight, [w], torch.ones(
            8, 3, 3, 4, dtype=weight.dtype, device=cuda).permute(0, 3, 2, 1))
