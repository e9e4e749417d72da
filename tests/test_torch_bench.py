"""The port's bench (``cap2det_tpu_torch/bench.py``) against the JAX
package's root ``bench.py``, and the FLOP counts it reports.

* Its shapes, model and train configs equal the JAX bench's, and its
  host batch equals the JAX bench's draws (captured from the JAX bench's
  own ``main`` at a tiny canvas).
* One bench step at a tiny shape (64x96, P=16, 3 classes) from the same
  seeded numpy params, float32, dropout off, matches JAX
  ``make_train_step``; JAX runs its XLA paths on the CPU, the port the
  kernels' plain versions.
* The five kernels' FLOP formulas equal a count of the operations an
  instrumented Python version of each function performs; ``step_flops``
  of the first stage equals the closed form over the conv specs; the
  whole step's count lies between half of XLA's cost analysis and all of
  it (XLA also counts elementwise operations).
* ``bench.main`` on the CPU prints one line with the JAX bench's keys,
  and raises without a card unless given ``--device cpu``.
"""

import dataclasses
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import pbtxt as jax_pbtxt
from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.train import optimizers as jax_optimizers
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import bench
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.kernels import pool_grad, roi_pool
from cap2det_tpu_torch.models import inception_v2
from cap2det_tpu_torch.tools import benchlib
from cap2det_tpu_torch.train import optimizers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402
import bench as jax_bench  # noqa: E402  (the root bench.py)

TINY = dict(batch=2, canvas_hw=(64, 96), num_proposals=16, num_classes=3,
            full_freeze=False)
STEP_RTOL = 1e-4  # the loss and the updated params
# Each update against the leaf's largest: float32 gradients through ~20
# conv layers, summed in other orders by XLA and PyTorch's CPU kernels
# (tests/test_torch_train.py's GRAD_RTOL).
UPDATE_RTOL = 1e-3
# midn/proba_r_given_c's biases cancel in the softmax over proposals:
# their gradient is zero but for float32 noise, ~1e-10 on both sides.
ATOL = 1e-9
JAX_KEYS = {"metric", "value", "unit", "shape", "batch", "step_ms",
            "tflops_per_step", "mfu_lower_bound", "mfu", "vs_baseline",
            "baseline_source"}


def test_shapes_are_the_jax_benchs():
    assert bench.SHAPES == jax_bench.SHAPES
    assert (bench.OICR_ITERATIONS, bench.WARMUP_STEPS, bench.MEASURE_STEPS,
            bench.NUM_PROPOSALS, bench.NUM_CLASSES, bench.BATCH) == (
        jax_bench.OICR_ITERATIONS, jax_bench.WARMUP_STEPS,
        jax_bench.MEASURE_STEPS, jax_bench.NUM_PROPOSALS,
        jax_bench.NUM_CLASSES, jax_bench.BATCH)


@pytest.mark.parametrize("full_freeze", [False, True],
                         ids=["mixed4e_trainable", "full_freeze"])
def test_configs_are_the_jax_benchs(tmp_path, full_freeze):
    label_file = str(tmp_path / "labels.txt")
    cfg = bench.config(label_file, full_freeze)
    model = jax_schema.Model.from_dict(
        jax_pbtxt.parse(graft._MODEL_PBTXT % label_file)["model"])
    object.__setattr__(model.cap2det_model, "oicr_iterations",
                       jax_bench.OICR_ITERATIONS)
    object.__setattr__(model.cap2det_model.frcnn_options,
                       "initial_crop_size", 14)
    train = jax_schema.Pipeline.from_dict(jax_pbtxt.parse(
        jax_bench._FULL_FREEZE_TRAIN_PBTXT if full_freeze
        else graft._TRAIN_PBTXT)).train_config
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(model)
    assert dataclasses.asdict(cfg.train_config) == dataclasses.asdict(train)


class _Captured(Exception):
    pass


def test_host_batch_is_the_jax_benchs(monkeypatch):
    """The JAX bench's main, at a tiny canvas, up to the batch it hands
    ``device_batch``."""
    monkeypatch.setitem(jax_bench.SHAPES, "bench", dict(TINY))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--shape", "bench"])
    seen = {}

    def capture(self, host_batch):
        seen.update(host_batch)
        raise _Captured

    monkeypatch.setattr(cap2det_tpu.models.cap2det.Cap2DetModel,
                        "device_batch", capture)
    with pytest.raises(_Captured):
        jax_bench.main()
    got = bench.host_batch(TINY["batch"], TINY["canvas_hw"],
                           TINY["num_proposals"], TINY["num_classes"])
    for key in (InputFields.proposals, InputFields.num_proposals,
                InputFields.pseudo_labels):
        np.testing.assert_array_equal(got[key], seen[key], err_msg=key)
        assert got[key].dtype == seen[key].dtype, key
    assert got[InputFields.image].dtype == np.uint8
    np.testing.assert_array_equal(got[InputFields.image],
                                  seen[InputFields.image].astype(np.uint8))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One tiny bench step on each side from the same numpy params: the
    losses, the updated params, XLA's FLOP count of JAX's step and
    ``step_flops`` of a second port step."""
    port = bench.BenchStep(TINY, "cpu", torch.float32, keep_prob=1.0)
    tree = port.model.init_jax_numpy(0)
    host = bench.host_batch(TINY["batch"], TINY["canvas_hw"],
                            TINY["num_proposals"], TINY["num_classes"])

    label_file = str(tmp_path_factory.mktemp("labels") / "labels.txt")
    with open(label_file, "w") as f:
        f.write("\n".join(bench.class_names(TINY["num_classes"])))
    model_cfg = jax_schema.Model.from_dict(jax_pbtxt.parse(
        (graft._MODEL_PBTXT % label_file).replace(
            "dropout_keep_prob: 0.5", "dropout_keep_prob: 1"))["model"])
    object.__setattr__(model_cfg.cap2det_model, "oicr_iterations", 3)
    object.__setattr__(model_cfg.cap2det_model.frcnn_options,
                       "initial_crop_size", 14)
    train_config = jax_schema.Pipeline.from_dict(
        jax_pbtxt.parse(graft._TRAIN_PBTXT)).train_config
    model = jax_registry.build(model_cfg, is_training=True,
                               compute_dtype=jnp.float32, use_pallas=False)
    params = jax.tree.map(jnp.asarray, tree)
    tx, mask, _ = jax_optimizers.build_optimizer(
        train_config, params, non_trainable_paths=model.non_trainable_paths,
        non_trainable_substrings=model.non_trainable_substrings)
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    batch = {"image": jnp.asarray(host[InputFields.image]),
             "proposals": jnp.asarray(host[InputFields.proposals]),
             "num_proposals": jnp.asarray(host[InputFields.num_proposals]),
             "labels": jnp.asarray(host[InputFields.pseudo_labels])}
    rng = jax.random.PRNGKey(bench.STEP_SEED)
    compiled = jax.jit(jax_trainer.make_train_step(
        model, tx, train_config, mask)).lower(state, batch, rng).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    new_state, jax_logs = compiled(state, batch, rng)

    logs = port.run()
    return {
        "jax_loss": float(jax_logs["loss/total_loss"]),
        "jax_params": dict(zip(
            jax_optimizers.param_path_strings(new_state["params"]),
            jax.tree_util.tree_leaves(new_state["params"]))),
        "xla_flops": float(cost["flops"]),
        "port_loss": float(logs["loss/total_loss"]),
        # Copies: the counted step below updates the params in place.
        "port_params": {path: np.array(leaf) for path, leaf in
                        optimizers.flatten_params(params_lib.to_jax_numpy(
                            port.state["params"]))},
        "port_flops": benchlib.step_flops(port.run),
        "port_flops_in_bounds": _in_bounds_step_flops(port.run),
        "initial": dict(optimizers.flatten_params(tree)),
        "trainable": {path for path, t in optimizers.flatten_params(
            port.mask) if t},
    }


def test_bench_step_matches_jax(steps):
    np.testing.assert_allclose(steps["port_loss"], steps["jax_loss"],
                               rtol=STEP_RTOL)
    assert set(steps["port_params"]) == set(steps["jax_params"])
    moved = 0
    for path, want in steps["jax_params"].items():
        got, before = steps["port_params"][path], steps["initial"][path]
        want = np.asarray(want)
        if path not in steps["trainable"]:
            np.testing.assert_array_equal(got, before, err_msg=path)
            continue
        moved += not np.array_equal(want, before)
        # rtol 1e-4 of the value, and of the leaf's largest update the
        # gradients' tolerance, beyond the value's float32 rounding.
        bound = (STEP_RTOL * np.abs(want)
                 + UPDATE_RTOL * np.abs(want - before).max()
                 + 2 * np.spacing(np.abs(want).astype(np.float32)) + ATOL)
        assert np.all(np.abs(got - want) <= bound), (
            path, float(np.abs(got - want).max()))
    assert moved >= len(steps["trainable"]) // 2


def _in_bounds_macs(x_shape, w_shape, stride, padding, dilation):
    """Multiply-adds of a convolution over the taps that land inside its
    input: XLA's cost analysis leaves out the taps on padding."""
    macs = x_shape[0] * w_shape[0] * w_shape[1]
    for d, (size, k) in enumerate(zip(x_shape[2:], w_shape[2:])):
        s, p, dl = stride[d], padding[d], dilation[d]
        out = (size + 2 * p - dl * (k - 1) - 1) // s + 1
        macs *= sum(0 <= o * s - p + t * dl < size
                    for o in range(out) for t in range(k))
    return macs


def _conv_in_bounds(x_shape, w_shape, _bias, stride, padding, dilation,
                    transposed, *args, out_shape=None, **kwargs):
    assert not transposed
    return 2 * _in_bounds_macs(x_shape, w_shape, stride, padding, dilation)


def _conv_backward_in_bounds(grad_out_shape, x_shape, w_shape, _bias,
                             stride, padding, dilation, transposed,
                             _output_padding, _groups, output_mask,
                             out_shape=None, **kwargs):
    assert not transposed
    return (2 * _in_bounds_macs(x_shape, w_shape, stride, padding, dilation)
            * (bool(output_mask[0]) + bool(output_mask[1])))


def _in_bounds_step_flops(fn):
    """``step_flops`` with convolutions counted as XLA counts them."""
    from torch.utils import flop_counter

    aten = torch.ops.aten
    registry = flop_counter.flop_registry
    saved = {k: registry[k] for k in (aten.convolution,
                                      aten.convolution_backward)}
    registry[aten.convolution] = flop_counter.shape_wrapper(_conv_in_bounds)
    registry[aten.convolution_backward] = flop_counter.shape_wrapper(
        _conv_backward_in_bounds)
    try:
        return benchlib.step_flops(fn)
    finally:
        registry.update(saved)


def test_step_count_lies_within_xla_count(steps):
    """XLA's cost analysis counts every elementwise operation too, but
    only the taps of a convolution that land inside its input; the port
    counts convolutions (every tap, padding too, as the library computes
    them), matmuls and the kernels' functions. Counted as XLA counts
    convolutions, the port's step is at most XLA's and at least half."""
    xla = steps["xla_flops"]
    port, in_bounds = (steps["port_flops"]["total"],
                       steps["port_flops_in_bounds"]["total"])
    print("port %.6g FLOP (%.6g with XLA's convolution count), XLA %.6g: "
          "ratios %.4f, %.4f" % (port, in_bounds, xla, port / xla,
                                 in_bounds / xla))
    assert xla / 2 <= in_bounds <= xla < port
    assert steps["port_flops_in_bounds"]["kernels"] == steps[
        "port_flops"]["kernels"]
    assert set(steps["port_flops"]["kernels"]) == {
        k for k, v in bench.LAUNCHES[(False, False)].items() if v}


# -- the kernels' FLOP formulas against instrumented Python versions --------


class Ops:
    """Counts the arithmetic operations a Python walk performs."""

    def __init__(self):
        self.n = 0

    def lerp(self, a, b, t):
        self.n += 3
        return a + (b - a) * t

    def max(self, a, b):
        self.n += 1
        return max(a, b)


def _crop_sample(ops, f, y, x):
    """TF crop_and_resize's bilinear sample of one channel map at (y, x)."""
    h, w = f.shape
    y0, x0 = int(np.floor(y)), int(np.floor(x))
    y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
    top = ops.lerp(f[y0, x0], f[y0, x1], x - x0)
    bottom = ops.lerp(f[y1, x0], f[y1, x1], x - x0)
    return ops.lerp(top, bottom, y - y0)


def _walk_roi(ops, features, boxes, crop, k, s, backward):
    """K1 (and with `backward` K2) on every proposal and channel: the
    crop, the first maximum of each window, and for K2 each pooled
    gradient routed to its winner's four taps."""
    b_, h, w, c = features.shape
    pooled = (crop - k) // s + 1
    for b in range(b_):
        for box in boxes[b]:
            ys = box[0] * (h - 1) + np.arange(crop) * (box[2] - box[0]) * (
                h - 1) / (crop - 1)
            xs = box[1] * (w - 1) + np.arange(crop) * (box[3] - box[1]) * (
                w - 1) / (crop - 1)
            for ch in range(c):
                f = features[b, :, :, ch]
                samples = [[_crop_sample(ops, f, y, x) for x in xs]
                           for y in ys]
                for i in range(pooled):
                    for j in range(pooled):
                        window = [samples[i * s + di][j * s + dj]
                                  for di in range(k) for dj in range(k)]
                        best = window[0]
                        for v in window[1:]:
                            best = ops.max(best, v)
                        if backward:
                            ops.n += 2 + 4 + 4  # y, x weight products; adds
    return ops.n


ROI_CASES = [((1, 5, 6, 2), 2, 4, 2, 2), ((2, 4, 4, 1), 3, 6, 2, 2),
             ((1, 6, 5, 3), 1, 7, 3, 2), ((1, 4, 7, 1), 2, 5, 2, 1)]


@pytest.mark.parametrize("case", ROI_CASES, ids=str)
@pytest.mark.parametrize("backward", [False, True], ids=["K1", "K2"])
def test_roi_flops_count_the_function(case, backward):
    shape, num_p, crop, k, s = case
    rng = np.random.default_rng(0)
    features = rng.normal(size=shape)
    y0, x0 = rng.uniform(0, 0.5, (2, shape[0], num_p))
    boxes = np.stack([y0, x0, y0 + 0.4, x0 + 0.5], -1)
    want = _walk_roi(Ops(), features, boxes, crop, k, s, backward)
    formula = roi_pool.backward_flops if backward else roi_pool.forward_flops
    assert formula(shape[0], num_p, shape[3], crop, k, s) == want


def _walk_pool(shape, kernel, stride, per_tap, per_output):
    """Operations of a SAME pool's walk: every window's in-bounds taps
    (bounds checked one by one) and its per-output operations."""
    n, h, w, c = shape
    out_h, pad_t, _ = pool_grad.same_pads(h, kernel, stride)
    out_w, pad_l, _ = pool_grad.same_pads(w, kernel, stride)
    ops = 0
    for _ in range(n * c):
        for oy in range(out_h):
            for ox in range(out_w):
                for ky in range(kernel):
                    for kx in range(kernel):
                        y, x = oy * stride - pad_t + ky, ox * stride - pad_l + kx
                        if 0 <= y < h and 0 <= x < w:
                            ops += per_tap
                ops += per_output
    return ops


POOL_CASES = [((2, 7, 7, 3), 3, 2), ((1, 4, 4, 2), 3, 1), ((1, 5, 6, 1), 2, 2),
              ((3, 6, 5, 2), 3, 3)]


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
@pytest.mark.parametrize("kernel_id", ["K4 max", "K4 avg", "K5", "K6"])
def test_pool_flops_count_the_function(case, kernel_id):
    shape, kernel, stride = case
    if kernel_id == "K4 max":  # a max per in-bounds tap
        got = pool_grad.pool_fwd_flops(shape, "pool_max", kernel, stride)
        want = _walk_pool(shape, kernel, stride, 1, 0)
    elif kernel_id == "K4 avg":  # an add per tap, a divide per window
        got = pool_grad.pool_fwd_flops(shape, "pool_avg", kernel, stride)
        want = _walk_pool(shape, kernel, stride, 1, 1)
    elif kernel_id == "K5":  # a compare per tap, an add of g per window
        got = pool_grad.maxpool_grad_flops(shape, kernel, stride)
        want = _walk_pool(shape, kernel, stride, 1, 1)
    else:  # a divide per window, an add per tap
        got = pool_grad.avgpool_grad_flops(shape, kernel, stride)
        want = _walk_pool(shape, kernel, stride, 1, 1)
    assert got == want


def _conv_flops(specs_in, h, w, batch):
    """2 N Ho Wo Cin Cout kh kw over the first stage's convolutions."""
    total = 0

    def conv(h, w, cin, cout, k, stride):
        ho, wo = -(-h // stride), -(-w // stride)
        return 2 * batch * ho * wo * cin * cout * k * k, ho, wo

    f, h, w = conv(h, w, 3, 64, 7, 2)  # the composed separable stem
    total += f
    h, w = -(-h // 2), -(-w // 2)  # max-pool 3/s2
    f, h, w = conv(h, w, 64, 64, 1, 1)
    total += f
    f, h, w = conv(h, w, 64, 192, 3, 1)
    total += f
    h, w = -(-h // 2), -(-w // 2)
    cin = 192
    for name in inception_v2.FIRST_BLOCKS:
        cout_total, out_hw = 0, None
        for branch in specs_in[name]:
            bh, bw, c = h, w, cin
            for layer, k, cout, stride in branch:
                if layer.startswith("pool_"):
                    bh, bw = -(-bh // stride), -(-bw // stride)
                    continue
                f, bh, bw = conv(bh, bw, c, cout, k, stride)
                total += f
                c = cout
            cout_total += c
            out_hw = (bh, bw)
        h, w = out_hw
        cin = cout_total
    return total


def test_step_flops_of_the_first_stage_is_the_closed_form():
    rng = np.random.default_rng(0)
    tree = params_lib.from_jax_numpy(
        inception_v2.init_first_stage_params_numpy(rng), "cpu")
    with torch.no_grad():
        prepared = inception_v2.prepare(tree, torch.float32)
        images = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 96, 3)).astype(
            np.float32))
        counted = benchlib.step_flops(inception_v2.first_stage, prepared,
                                      images)
    assert counted["kernels"] == {}
    assert counted["aten"] == counted["total"] == _conv_flops(
        inception_v2._BLOCKS_FIRST, 64, 96, 2)


# -- the command line --------------------------------------------------------


def _run_main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        bench.main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_main_prints_one_line_with_the_jax_keys(monkeypatch, tmp_path):
    monkeypatch.setitem(bench.SHAPES, "tiny", dict(TINY))
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    monkeypatch.setattr(bench, "BASELINE_CPU_FILE",
                        str(tmp_path / "missing.json"))
    (line,) = _run_main(["--device", "cpu", "--shape", "tiny",
                         "--measure_steps", "1"])
    assert JAX_KEYS | {"tflops_per_step_incl_kernels"} <= set(line)
    assert line["unit"] == "images/sec" and line["value"] > 0
    assert line["step_ms"] > 0 and line["tflops_per_step"] > 0
    assert line["mfu"] is None and line["device"].startswith("cpu")
    assert line["vs_baseline"] is None


def test_main_with_second_stage_remat(monkeypatch, tmp_path):
    """``--second_stage_remat`` builds the bench's model with the second
    stage recomputed and says so in the line."""
    monkeypatch.setitem(bench.SHAPES, "tiny", dict(TINY))
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    monkeypatch.setattr(bench, "BASELINE_CPU_FILE",
                        str(tmp_path / "missing.json"))
    built = []
    real = bench.BenchStep.__init__

    def spy(self, *args, **kwargs):
        real(self, *args, **kwargs)
        built.append(self.model._second_stage_remat)

    monkeypatch.setattr(bench.BenchStep, "__init__", spy)
    (line,) = _run_main(["--device", "cpu", "--shape", "tiny",
                         "--measure_steps", "1", "--second_stage_remat"])
    assert built == [True] and line["second_stage_remat"] is True
    assert line["value"] > 0 and line["launches"]


@pytest.mark.parametrize("mode", ["--e2e", "--cpu_baseline"])
def test_second_stage_remat_is_refused_outside_the_step_bench(mode, capsys):
    """``--second_stage_remat`` is an option of the step bench: with
    ``--e2e`` or ``--cpu_baseline`` the command line is refused."""
    with pytest.raises(SystemExit) as exc:
        bench.parse_args([mode, "--second_stage_remat"])
    assert exc.value.code == 2
    assert "option of the step bench" in capsys.readouterr().err
    assert not bench.parse_args([mode]).second_stage_remat


def test_remat_bench_steps_equal_plain_with_dropout():
    """Two tiny bench steps with dropout on (keep 0.5, drawn outside the
    checkpointed blocks): the second stage recomputed gives the plain
    step's losses and params bit for bit."""
    runs = []
    for remat in (False, True):
        step = bench.BenchStep(TINY, "cpu", torch.float32,
                               second_stage_remat=remat)
        losses = [step.run()["loss/total_loss"] for _ in range(2)]
        runs.append((losses, optimizers.flatten_params(
            step.state["params"])))
    (plain_losses, plain), (losses, params) = runs
    assert all(map(torch.equal, losses, plain_losses))
    assert [p for p, _ in params] == [p for p, _ in plain]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(params, plain))


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(bench.SHAPES, "tiny", dict(TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--shape", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--e2e"])


def test_vs_baseline_reads_the_ports_own_file(monkeypatch, tmp_path):
    path = tmp_path / "BASELINE_CPU.json"
    monkeypatch.setattr(bench, "BASELINE_CPU_FILE", str(path))
    value, why = bench.load_cpu_baseline("bench")
    assert value is None and "--cpu_baseline" in why
    path.write_text(json.dumps({"value": 0.05, "host": "h", "cpu": "c",
                                "date": "d", "shape": "bench"}))
    assert bench.load_cpu_baseline("bench") == (
        0.05, "cap2det_tpu_torch/BASELINE_CPU.json (host h, c, d)")
    assert bench.load_cpu_baseline("inc2")[0] is None
    assert not os.path.samefile(os.path.dirname(
        os.path.abspath(bench.__file__)), ROOT)
