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
from cap2det_tpu_torch.eval import evaluator
from cap2det_tpu_torch.kernels import build, pool_grad, roi_pool
from cap2det_tpu_torch.models import frcnn, registry
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
    """Per image: K1 once and K4 three times per scale; no backward
    kernel."""
    cfg = _eval_setup(tmp_path)
    model = registry.build(cfg.model)
    counts = (roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
              pool_grad.maxpool_grad_launches,
              pool_grad.avgpool_grad_launches)
    metrics, maps = evaluator.run_evaluation(cfg, model.init_params(0),
                                             model=model)
    torch.cuda.synchronize()
    delta = tuple(b - a for a, b in zip(counts, (
        roi_pool.launches, pool_grad.launches, roi_pool.grad_launches,
        pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches)))
    assert delta == (2 * 3, 3 * 2 * 3, 0, 0, 0)
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
