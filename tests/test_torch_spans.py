"""The port's spans (``cap2det_tpu_torch/utils/spans.py``) and the
per-layer metrics that read them, on the CPU at ``benchmark/small.py``'s
sizes.

* With no profiler recording, a training step and a ``predict`` enter no
  ``record_function``.
* Under ``torch.profiler`` every span of the step, of ``predict`` and of
  ``train()``'s feed appears, each inside its parent's interval; the
  fold's kernel spans too on the card's path (its launches walked on the
  CPU), each named as a launch counter.
* The step's losses and params, and ``predict``'s outputs, are the same
  bits with the profiler on and off.
* Each reader of ``benchmark/metrics/`` that reads these spans gives the
  stated number on a chrome trace built here (a launch from a second
  thread inside the backward, spans whose names extend another's), and
  nothing on a trace without the program's spans.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness, small
from benchmark.drivers import predict as predict_driver
from benchmark.drivers import train_step as train_driver
from benchmark.yardstick import traffic, weights
from benchmark.yardstick.trace import Trace
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.train import optimizers, trainer

SEED = 2 ** 31 + 11
CONFIG = "coco17_extend_match"  # Mixed_4e trains: K2, K5 and K6 run

STEP_PARENTS = {
    "cap2det/step": None,
    "cap2det/step/forward": "cap2det/step",
    "cap2det/step/backward": "cap2det/step",
    "cap2det/step/update": "cap2det/step",
    "cap2det/model/bn_fold": "cap2det/step/forward",
    "cap2det/kernel/bn_fold": "cap2det/model/bn_fold",
    "cap2det/model/first_stage": "cap2det/step/forward",
    "cap2det/kernel/roi_crop_maxpool": "cap2det/step/forward",
    "cap2det/model/second_stage": "cap2det/step/forward",
    "cap2det/kernel/pool_fwd": "cap2det/model/second_stage",
    "cap2det/model/heads": "cap2det/step/forward",
    "cap2det/model/losses": "cap2det/step/forward",
    "cap2det/kernel/roi_crop_maxpool_grad": "cap2det/step/backward",
    "cap2det/kernel/maxpool_grad": "cap2det/step/backward",
    "cap2det/kernel/avgpool_grad": "cap2det/step/backward",
    "cap2det/kernel/fused_optimizer": "cap2det/step/update",
}
PREDICT_PARENTS = {
    "cap2det/predict": None,
    "cap2det/predict/upload": "cap2det/predict",
    "cap2det/predict/resize": "cap2det/predict",
    "cap2det/predict/forward": "cap2det/predict",
    "cap2det/model/first_stage": "cap2det/predict/forward",
    "cap2det/kernel/roi_crop_maxpool": "cap2det/predict/forward",
    "cap2det/model/second_stage": "cap2det/predict/forward",
    "cap2det/kernel/pool_fwd": "cap2det/model/second_stage",
    "cap2det/model/heads": "cap2det/predict/forward",
    "cap2det/predict/mean": "cap2det/predict",
    "cap2det/postprocess/softmax": "cap2det/predict",
    "cap2det/postprocess/nms": "cap2det/predict",
    "cap2det/kernel/nms": "cap2det/postprocess/nms",
    "cap2det/predict/fetch": "cap2det/predict",
}
FEED_PARENTS = {
    "cap2det/feed/wait": None,
    "cap2det/batch/place": "cap2det/feed/wait",
}


@pytest.fixture(scope="module")
def cell():
    cfg = small.config(CONFIG)
    host = traffic.train_batches(small.mix("train_buckets"), cfg, SEED)
    examples = traffic.eval_images(small.mix("eval_coco"), cfg, SEED)
    return cfg, [host[0][0], host[1][0]], examples[:2]


def _train_program(cfg):
    return train_driver.Program(
        cfg, weights.make_params(cfg["model"], SEED, "cpu"), "cpu")


def _predict_program(cfg):
    return predict_driver.Program(
        cfg, weights.make_params(cfg["model"], SEED, "cpu"), "cpu")


def _profiled(fn):
    """fn()'s result and the user_annotation events of a CPU profile of
    it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _spans(prof):
    with tempfile.TemporaryDirectory(prefix="spans_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _assert_nested(spans, parents):
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name, parent in parents.items():
        assert by_name.get(name), "no %s span" % name
        if parent is None:
            continue
        for e in by_name[name]:
            assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= p["ts"] + p["dur"] for p in by_name[parent]), (
                "%s at %s is in no %s" % (name, e["ts"], parent))


def test_no_record_function_while_no_profiler_records(cell, monkeypatch):
    cfg, batches, examples = cell
    train, predict = _train_program(cfg), _predict_program(cfg)
    real = torch.profiler.record_function
    made = []

    def counted(*args, **kwargs):
        made.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    train.step(batches[0], SEED)
    predict.predict(examples[0])
    assert made == []
    # The count sees the spans once a profiler records.
    _profiled(lambda: train.step(batches[1], SEED))
    assert ("cap2det/step/forward",) in [a[:1] for a in made]


def test_every_step_and_predict_span_nests_in_its_parent(cell):
    cfg, batches, examples = cell
    train, predict = _train_program(cfg), _predict_program(cfg)
    _, spans = _profiled(lambda: [train.step(b, SEED) for b in batches])
    _assert_nested(spans, STEP_PARENTS)
    steps = [e for e in spans if e["name"] == "cap2det/step"]
    assert len(steps) == 2
    _, spans = _profiled(lambda: [predict.predict(e) for e in examples])
    _assert_nested(spans, PREDICT_PARENTS)
    scales = len(cfg["model"]["eval_min_dimension"])
    names = [e["name"] for e in spans]
    assert names.count("cap2det/predict") == 2
    assert names.count("cap2det/predict/resize") == 2 * scales
    assert names.count("cap2det/postprocess/nms") == 2 * (
        1 + cfg["model"]["oicr_iterations"])


def test_the_folds_kernel_spans_nest_and_name_launch_counters(cell,
                                                              monkeypatch):
    """The card's fold path (its launches walked on the CPU): the fold's
    span inside ``cap2det/model/bn_fold`` and its backward's inside
    ``cap2det/step/backward``, once a step each; every kernel span names
    a counter of ``kernels.launch_counts()``."""
    from cap2det_tpu_torch import kernels
    from tests.test_torch_bn_fold import walk_the_kernels

    walk_the_kernels(monkeypatch)
    cfg, batches, _ = cell
    train = _train_program(cfg)
    _, spans = _profiled(lambda: [train.step(b, SEED) for b in batches])
    _assert_nested(spans, dict(STEP_PARENTS, **{
        "cap2det/kernel/bn_fold_grad": "cap2det/step/backward"}))
    names = [e["name"] for e in spans]
    assert names.count("cap2det/kernel/bn_fold") == len(batches)
    assert names.count("cap2det/kernel/bn_fold_grad") == len(batches)
    prefix = "cap2det/kernel/"
    assert {n[len(prefix):] for n in names if n.startswith(prefix)} <= set(
        kernels.launch_counts())


def test_the_profiler_changes_no_bit_of_the_step_or_predict(cell):
    cfg, batches, examples = cell
    off, on = _train_program(cfg), _train_program(cfg)
    want = [off.step(b, SEED) for b in batches]
    got, _ = _profiled(lambda: [on.step(b, SEED) for b in batches])
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            assert torch.equal(w[k], g[k]), k
    for (path, a), (_, b) in zip(
            optimizers.flatten_params(off.state["params"]),
            optimizers.flatten_params(on.state["params"])):
        assert torch.equal(a, b), path
    predictor = _predict_program(cfg)
    want = predictor.predict(examples[0])
    got, _ = _profiled(lambda: predictor.predict(examples[0]))
    assert want.keys() == got.keys()
    for k in want:
        if k == "proposal_scores":
            for s in want[k]:
                assert np.array_equal(want[k][s], got[k][s]), s
        else:
            assert np.array_equal(want[k], got[k]), k


def test_train_profile_steps_carry_the_feed_spans(tmp_path):
    """``train()``'s ``profile_steps`` trace holds the step's spans and the
    wait for the next placed batch, with the placing inside it."""
    classes = ["person", "dog", "car"]
    record = str(tmp_path / "train.record")
    synthetic.write_synthetic_dataset(record, num_examples=4, seed=3,
                                      classes=classes, image_hw=(64, 96),
                                      num_proposals=8)
    labels = synthetic.write_label_file(str(tmp_path / "labels.txt"),
                                        classes)
    pbtxt = small.config(CONFIG)["pbtxt"]
    pbtxt = pbtxt.replace(
        '"seeded synthetic batches (benchmark/yardstick/traffic.py)"',
        '"%s"' % record, 1).replace(
        "extend_match_extractor { label_file: "
        "'benchmark/configs/labels/coco17_extend_match.txt' }",
        "groundtruth_extractor { label_file: '%s' }" % labels)
    trainer.train(schema.loads_pipeline(pbtxt), model_dir=str(tmp_path),
                  max_steps=3, device="cpu", profile_steps=(0, 2))
    with open(tmp_path / "profile" / "trace.json") as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    _assert_nested(spans, {**FEED_PARENTS, **STEP_PARENTS})
    assert [e["name"] for e in spans].count("cap2det/step") == 2


# -- the readers, on a chrome trace built here --------------------------------


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(name, cat, ts, 2, tid=tid, correlation=corr)


def _kernel(ts, dur, corr):
    return _x("kernel_%d" % corr, "kernel", ts, dur, tid=7, correlation=corr)


def _traced(events, units):
    trace = {"traceEvents": [_x(harness.SPAN_WINDOW, "user_annotation", 0,
                                2000)] + events}
    return {"trace": Trace(trace, harness.SPAN_WINDOW), "units": units,
            "kernel_work": {}, "kind": "NVIDIA H100 80GB HBM3",
            "window_s": 1.0, "window_units": 10, "window_flops": 0.0}


def _train_trace():
    """Two steps. Step 1 (0-400): forward 10-200 with two launches and a
    runtime call that launches nothing, backward 200-350 with two
    launches on autograd's thread (tid 2, one through the driver API),
    update 350-390 with one. Between the steps, a copy launched outside
    any step span (the next batch's placing). Step 2 (500-900): forward
    and backward with two launches on the main thread and one on tid 2,
    update with one."""
    return [
        _x("bench/unit", "user_annotation", 0, 450),
        _x("cap2det/step", "user_annotation", 0, 400),
        _x("cap2det/step/forward", "user_annotation", 10, 190),
        _x("bench/prepare", "user_annotation", 12, 50),
        _x("cap2det/model/bn_fold", "user_annotation", 13, 48),
        _launch(20, 1), _kernel(25, 10, 1),
        _launch(30, 6, name="cudaStreamIsCapturing"),
        _launch(100, 2), _kernel(110, 5, 2),
        _x("cap2det/step/backward", "user_annotation", 200, 150),
        _launch(250, 3, tid=2), _kernel(255, 20, 3),
        _launch(260, 4, tid=2, name="cuLaunchKernel", cat="cuda_driver"),
        _kernel(280, 4, 4),
        _x("cap2det/step/update", "user_annotation", 350, 40),
        _x("cap2det/kernel/fused_optimizer", "user_annotation", 355, 30),
        _launch(360, 5), _kernel(365, 3, 5),
        _launch(420, 7, name="cudaMemcpyAsync"),
        _x("Memcpy HtoD", "gpu_memcpy", 425, 2, tid=7, correlation=7),
        _x("bench/unit", "user_annotation", 500, 450),
        _x("cap2det/step", "user_annotation", 500, 400),
        _x("cap2det/step/forward", "user_annotation", 510, 190),
        _launch(520, 8), _kernel(525, 10, 8),
        _x("cap2det/step/backward", "user_annotation", 700, 150),
        _launch(710, 9), _kernel(715, 6, 9),
        _launch(720, 10, tid=2), _kernel(730, 6, 10),
        _x("cap2det/step/update", "user_annotation", 860, 30),
        _launch(865, 11), _kernel(870, 3, 11),
    ]


def _predict_trace():
    """Two images, two scales each. Each image: upload, two resizes with
    a launch each, two forwards with a launch each, the mean, three
    softmax and four NMS spans (a kernel span inside each) of known
    lengths, the fetch. One launch between the images lies in no predict
    span."""
    events = []
    corr = 100
    for start, resize_us, softmax_us, nms_us in (
            (0, (5, 7), (30, 40, 50), (20, 20, 20, 20)),
            (1000, (6, 2), (35, 45, 55), (10, 30, 10, 30))):
        t = start
        events.append(_x("bench/unit", "user_annotation", t, 900))
        events.append(_x("cap2det/predict", "user_annotation", t, 890))
        events.append(_x("cap2det/predict/upload", "user_annotation", t + 1,
                         9))
        t += 10
        for dur in resize_us:
            events.append(_x("cap2det/predict/resize", "user_annotation", t,
                             20))
            events += [_launch(t + 5, corr), _kernel(t + 8, dur, corr)]
            events.append(_x("cap2det/predict/forward", "user_annotation",
                             t + 20, 100))
            events += [_launch(t + 30, corr + 1),
                       _kernel(t + 40, 50, corr + 1)]
            corr += 2
            t += 120
        events.append(_x("cap2det/predict/mean", "user_annotation", t, 10))
        t += 10
        events.append(_x("bench/postprocess", "user_annotation", t, 500))
        for dur in softmax_us:
            events.append(_x("cap2det/postprocess/softmax",
                             "user_annotation", t, dur))
            t += dur
        for dur in nms_us:
            events.append(_x("cap2det/postprocess/nms", "user_annotation",
                             t, dur))
            events.append(_x("cap2det/kernel/nms", "user_annotation", t + 1,
                             dur - 2))
            t += dur
        events.append(_x("cap2det/predict/fetch", "user_annotation",
                         start + 700, 180))
    events += [_launch(950, 999), _kernel(955, 5, 999)]
    return events


@pytest.mark.parametrize("name, events, want", [
    # 190 + 190 us over 2 steps.
    ("forward_host_ms.train", _train_trace(), 0.19),
    ("backward_host_ms.train", _train_trace(), 0.15),
    # 5 launches in step 1 (2 on tid 2), 4 in step 2 (1 on tid 2); the
    # call that launched nothing and the copy between the steps are out.
    ("cuda_launches.train", _train_trace(), 4.5),
    # (30 + 40 + 50) + (35 + 45 + 55) us over 2 images.
    ("softmax_host_ms.predict", _predict_trace(), 0.1275),
    ("nms_host_ms.predict", _predict_trace(), 0.08),
    # the resize kernels: 5 + 7 + 6 + 2 us over 2 images.
    ("resize_device_ms.predict", _predict_trace(), 0.01),
    ("fetch_wait_ms.predict", _predict_trace(), 0.18),
    # 4 launches an image; the one between the images is out.
    ("cuda_launches.predict", _predict_trace(), 4.0),
])
def test_span_readers_give_the_stated_numbers(name, events, want):
    got = harness.metric_reader(name).read(_traced(events, 2))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "forward_host_ms.train", "backward_host_ms.train", "cuda_launches.train",
    "softmax_host_ms.predict", "nms_host_ms.predict",
    "resize_device_ms.predict", "fetch_wait_ms.predict",
    "cuda_launches.predict"])
def test_span_readers_read_nothing_without_the_programs_spans(name):
    """A program without the spans (the parent commit's) reads None: the
    benchmark's own spans alone."""
    events = [e for e in _train_trace() + _predict_trace()
              if not e["name"].startswith("cap2det/")]
    assert harness.metric_reader(name).read(_traced(events, 2)) is None
