"""Benchmark: the Cap2Det training step's throughput on one card (port of
the root ``bench.py``, which stays the JAX package's bench).

    python -m cap2det_tpu_torch.bench [--shape bench|inc2] [--batch N]
        [--measure_steps N] [--device cuda|cpu] [--second_stage_remat]
    python -m cap2det_tpu_torch.bench --e2e [--e2e_min_dim D]
    python -m cap2det_tpu_torch.bench --cpu_baseline

Runs the JAX bench's configuration at paper scale: the port's
``entry._PIPELINE`` model and train config (``__graft_entry__``'s
``_MODEL_PBTXT`` and ``_TRAIN_PBTXT``) with the same overrides, 3 OICR
iterations and a 14x14 initial crop; ``--shape bench``: batch 2, a
1024x1536 canvas, 500 proposals, 80 classes, Mixed_4e trainable (so the
ROI backward, K2, runs); ``--shape inc2``: batch 1, 2000 proposals, 20
classes, the whole first stage frozen as configs/voc07_inc2.pbtxt freezes
it (no K2). InceptionV2 convolutions in bfloat16, Adagrad with the
shipped gradient multipliers, seeded random weights.

The host batch is drawn from ``np.random.RandomState(0)`` in the JAX
bench's order. Its float32 canvas is cast to uint8, the dtype the port's
pipeline hands ``device_batch``: the port has no float16 or
space-to-depth feed. The batch is placed on the card once.

Prints ONE JSON line with the JAX bench's keys (``metric``, ``value``,
``unit``, ``shape``, ``batch``, ``step_ms``, ``tflops_per_step``,
``tflops_per_step_incl_kernels``, ``mfu_lower_bound``, ``mfu``,
``vs_baseline``, ``baseline_source``), the rounds' spread and the host
clock beside the CUDA events (``tools/benchlib.time_rounds``), peak
memory, kernel launches per step, whether the second stage was
recomputed in the backward (``--second_stage_remat``), and the card's
name and power limit.
``tflops_per_step`` is the aten count of one step (convolutions, matmuls
and their backward); ``..._incl_kernels`` adds the kernels' function
counts (``benchlib.step_flops``). ``mfu`` divides the step's FLOPs per
second by the card's dense bfloat16 peak (``benchlib.BF16_PEAK_FLOPS``).
Every expected kernel must launch the expected number of times per step
on the card, or the run fails. On the CPU (``--device cpu``, for tests)
the kernels' plain versions run, nothing counts launches, and ``mfu`` is
null: the CPU has no card peak.

``--cpu_baseline`` measures the same step in float32 on the host CPU and
writes ``cap2det_tpu_torch/BASELINE_CPU.json`` (host, CPU model, date);
``vs_baseline`` divides by that file's rate, and is null, with the
reason, where there is none. ``--e2e`` measures ``train()`` end to end
over synthetic TFRecords, the first step's wait on the feed, and the host
pipeline's rate alone, its records read by the host library's reader (as
``train()`` reads them) and by the Python reader, in turns.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import socket
import statistics
import tempfile
import time

import numpy as np
import torch

from cap2det_tpu_torch import entry, kernels
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

BATCH = 2
NUM_PROPOSALS = 500
NUM_CLASSES = 80
OICR_ITERATIONS = 3
CROP = 14
WARMUP_STEPS = 3
MEASURE_STEPS = 16  # steps per timed round on the card
ROUNDS = 5
CPU_MEASURE_STEPS = 2  # the CPU's step takes a minute at the bench shape
CPU_ROUNDS = 1
STEP_SEED = 1
E2E_RECORDS = 24
E2E_IMAGE_HW = (480, 640)  # COCO-like sources, upscaled onto the canvas
E2E_WARM, E2E_MEASURE = 4, 16
E2E_HOST_WARM, E2E_HOST_BATCHES = 2, 8

SHAPES = {
    "bench": dict(batch=2, canvas_hw=(1024, 1536), num_proposals=500,
                  num_classes=80, full_freeze=False),
    "inc2": dict(batch=1, canvas_hw=(1024, 1536), num_proposals=2000,
                 num_classes=20, full_freeze=True),
}

# The voc07_inc2/voc07_groundtruth training regime: the whole first stage
# frozen (configs/voc07_inc2.pbtxt's train_config).
_FULL_FREEZE_TRAIN_PBTXT = """
train_config {
  max_steps: 100
  learning_rate: 0.01
  learning_rate_decay { decay_steps: 100000 decay_rate: 1.0 staircase: true }
  moving_average_decay: 0.0
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 1.0 }
}
"""

# Kernel launches of one step, by (full_freeze, second_stage_remat):
# Mixed_4e trainable runs K2 and Mixed_5a's max-pool backward; the full
# freeze runs neither. The fused optimizer updates every trainable leaf in
# one launch; the BN fold of every convolution is one launch forward and
# one backward in either regime. With the second stage recomputed, each
# block's recompute launches its pool again, but the full freeze's
# Mixed_5a recompute stops before its pool: no gradient flows into the
# ROIs, so nothing of the pool branch is kept for the backward. A training
# step runs no NMS.
LAUNCHES = {
    (False, False): {"roi_crop_maxpool": 1, "pool_fwd": 3,
                     "roi_crop_maxpool_grad": 1, "maxpool_grad": 2,
                     "avgpool_grad": 1, "fused_optimizer": 1, "nms": 0,
                     "bn_fold": 1, "bn_fold_grad": 1},
    (True, False): {"roi_crop_maxpool": 1, "pool_fwd": 3,
                    "roi_crop_maxpool_grad": 0, "maxpool_grad": 1,
                    "avgpool_grad": 1, "fused_optimizer": 1, "nms": 0,
                    "bn_fold": 1, "bn_fold_grad": 1},
}
LAUNCHES[(False, True)] = dict(LAUNCHES[(False, False)], pool_fwd=6)
LAUNCHES[(True, True)] = dict(LAUNCHES[(True, False)], pool_fwd=5)

BASELINE_CPU_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "BASELINE_CPU.json")


def class_names(num_classes):
    return ["class_%02d" % i for i in range(num_classes)]


def pipeline_text(label_file, full_freeze=False, keep_prob=0.5):
    """The port's model and train config text (``entry._PIPELINE``), its
    train_config swapped for the full first-stage freeze on request."""
    text = entry._PIPELINE % {"keep_prob": keep_prob,
                              "label_file": label_file}
    if full_freeze:
        text = text[:text.index("train_config {")] + _FULL_FREEZE_TRAIN_PBTXT
    return text


def apply_overrides(cfg):
    """The JAX bench's paper-scale head overrides, in place."""
    m = cfg.model.cap2det_model
    object.__setattr__(m, "oicr_iterations", OICR_ITERATIONS)
    object.__setattr__(m.frcnn_options, "initial_crop_size", CROP)
    return cfg


def config(label_file, full_freeze=False, keep_prob=0.5):
    from cap2det_tpu_torch.config import schema

    return apply_overrides(schema.loads_pipeline(
        pipeline_text(label_file, full_freeze, keep_prob)))


def host_batch(batch_size, canvas_hw, num_proposals, num_classes):
    """The JAX bench's seeded host batch (``InputFields`` keys), drawn in
    its order; the canvas cast to uint8."""
    from cap2det_tpu_torch.fields import InputFields

    rs = np.random.RandomState(0)
    h, w = canvas_hw
    shape = (batch_size, num_proposals)
    y0 = rs.uniform(0, 0.5, shape)
    x0 = rs.uniform(0, 0.5, shape)
    image = rs.uniform(0, 255, (batch_size, h, w, 3)).astype(np.float32)
    proposals = np.stack(
        [y0, x0, y0 + rs.uniform(0.1, 0.5, shape),
         x0 + rs.uniform(0.1, 0.5, shape)], -1).astype(np.float32)
    labels = (rs.rand(batch_size, num_classes) < 0.05).astype(np.float32)
    return {
        InputFields.image: image.astype(np.uint8),
        InputFields.proposals: proposals,
        InputFields.num_proposals: np.full((batch_size,), num_proposals,
                                           np.int32),
        InputFields.pseudo_labels: labels,
    }


class BenchStep:
    """The bench's training step, ready to run: ``run()`` takes one step
    on the placed batch and keeps the state and logs."""

    def __init__(self, shape, device, compute_dtype=torch.bfloat16,
                 batch_size=None, keep_prob=0.5, fused=None,
                 second_stage_remat=False):
        from cap2det_tpu_torch.models import registry
        from cap2det_tpu_torch.train import trainer
        import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.batch_size = batch_size or shape["batch"]
        self.full_freeze = shape["full_freeze"]
        with tempfile.TemporaryDirectory(prefix="bench_labels_") as tmp:
            label_file = os.path.join(tmp, "labels.txt")
            with open(label_file, "w") as f:
                f.write("\n".join(class_names(shape["num_classes"])))
            self.cfg = config(label_file, self.full_freeze, keep_prob)
            self.model = registry.build(self.cfg.model, is_training=True,
                                        compute_dtype=compute_dtype,
                                        device=self.device,
                                        second_stage_remat=second_stage_remat)
        self.state, self.tx, _, self.mask = trainer.TrainState.create(
            self.model, self.cfg.train_config, 0, fused=fused)
        self.step = trainer.make_train_step(self.model, self.tx,
                                            self.cfg.train_config, self.mask)
        self.batch = self.model.device_batch(host_batch(
            self.batch_size, shape["canvas_hw"], shape["num_proposals"],
            shape["num_classes"]))
        self.logs = None

    def run(self):
        self.state, self.logs = self.step(self.state, self.batch, STEP_SEED)
        return self.logs

    def loss(self):
        return float(self.logs["loss/total_loss"])


def step_launches(bench_step):
    """Kernel launches of one step, by wrapper."""
    before = kernels.launch_counts()
    bench_step.run()
    benchlib.synchronize(bench_step.device)
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after}


def check_launches(launches, full_freeze, device, second_stage_remat=False):
    """Raises unless each kernel launched as often as the regime needs (on
    the card; on the CPU the plain versions run and nothing counts)."""
    want = LAUNCHES[(full_freeze, second_stage_remat)]
    if torch.device(device).type == "cuda" and launches != want:
        raise AssertionError("kernel launches per step %s, expected %s"
                             % (launches, want))


def load_cpu_baseline(shape_name):
    """(images per second or None, where it came from or why none)."""
    if shape_name != "bench":
        return None, "the CPU floor is measured at the bench shape only"
    try:
        with open(BASELINE_CPU_FILE) as f:
            rec = json.load(f)
        value = float(rec["value"])
    except (OSError, ValueError, KeyError) as e:
        return None, ("no CPU floor (%s: %s); run `python -m "
                      "cap2det_tpu_torch.bench --cpu_baseline` to measure "
                      "one" % (type(e).__name__, e))
    return value, "cap2det_tpu_torch/BASELINE_CPU.json (host %s, %s, %s)" % (
        rec.get("host", "?"), rec.get("cpu", "?"), rec.get("date", "?"))


def run_step_bench(args):
    shape = SHAPES[args.shape]
    device = params_lib.resolve_device("cpu" if args.cpu_baseline
                                       else args.device)
    cuda = device.type == "cuda"
    compute_dtype = torch.float32 if args.cpu_baseline else torch.bfloat16
    steps = args.measure_steps or (MEASURE_STEPS if cuda
                                   else CPU_MEASURE_STEPS)
    rounds = ROUNDS if cuda else CPU_ROUNDS
    fields = benchlib.device_fields(device)

    bench_step = BenchStep(shape, device, compute_dtype, args.batch,
                           second_stage_remat=args.second_stage_remat)
    for _ in range(WARMUP_STEPS):
        bench_step.run()
    if not math.isfinite(bench_step.loss()):
        raise AssertionError("non-finite loss after warm-up: %r"
                             % bench_step.loss())
    launches = step_launches(bench_step)
    check_launches(launches, bench_step.full_freeze, device,
                   args.second_stage_remat)
    flops = benchlib.step_flops(bench_step.run)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    timing = benchlib.time_rounds(bench_step.run, device, steps, rounds,
                                  warmup=0)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if not math.isfinite(bench_step.loss()):
        raise AssertionError("non-finite loss: %r" % bench_step.loss())
    step_s = timing["ms"] / 1e3
    images_per_sec = bench_step.batch_size / step_s

    if args.cpu_baseline:
        cpu, cores = benchlib.host_cpu()
        record = {
            "metric": "cap2det_train_images_per_sec_cpu_f32",
            "value": images_per_sec, "unit": "images/sec",
            "shape": args.shape, "batch": bench_step.batch_size,
            "step_ms": timing["ms"], "step_ms_min": timing["ms_min"],
            "step_ms_max": timing["ms_max"], "rounds": rounds,
            "steps_per_round": steps, "host": socket.gethostname(),
            "cpu": cpu, "cores": cores, "threads": torch.get_num_threads(),
            "torch": torch.__version__,
            "date": datetime.date.today().isoformat(),
            "note": "the bench step in float32 on the host CPU (the kernels' "
                    "plain versions); vs_baseline's floor",
        }
        if args.shape == "bench" and not args.batch:
            with open(BASELINE_CPU_FILE, "w") as f:
                json.dump(record, f, indent=1)
                f.write("\n")
        benchlib.json_line(record)
        return record

    metric = ("cap2det_train_images_per_sec_per_chip" if args.shape == "bench"
              else "cap2det_inc2_train_images_per_sec_per_chip")
    out = {
        "metric": metric, "value": images_per_sec, "unit": "images/sec",
        "shape": args.shape, "batch": bench_step.batch_size,
        "step_ms": timing["ms"], "step_ms_min": timing["ms_min"],
        "step_ms_max": timing["ms_max"], "host_step_ms": timing["host_ms"],
        "host_step_ms_min": timing["host_ms_min"],
        "host_step_ms_max": timing["host_ms_max"], "clock": timing["clock"],
        "rounds": rounds, "steps_per_round": steps,
        "tflops_per_step": flops["aten"] / 1e12,
        "tflops_per_step_incl_kernels": flops["total"] / 1e12,
        "kernel_gflops_per_step": {k: v / 1e9
                                   for k, v in flops["kernels"].items()},
        "mfu_lower_bound": None, "mfu": None,
    }
    if cuda:
        peak_flops = benchlib.bf16_peak_flops(device)
        out["mfu_lower_bound"] = flops["aten"] / step_s / peak_flops
        out["mfu"] = flops["total"] / step_s / peak_flops
        out["peak_tflops"] = peak_flops / 1e12
    else:
        out["mfu_note"] = "no card peak on the CPU"
    baseline, out["baseline_source"] = load_cpu_baseline(args.shape)
    out["vs_baseline"] = images_per_sec / baseline if baseline else None
    out.update(launches=launches, peak_bytes=peak,
               second_stage_remat=args.second_stage_remat,
               compute_dtype=str(compute_dtype).split(".")[-1],
               canvas_hw=list(shape["canvas_hw"]),
               num_proposals=shape["num_proposals"],
               num_classes=shape["num_classes"],
               full_freeze=shape["full_freeze"], **fields)
    benchlib.json_line(out)
    return out


def run_e2e(args):
    """End-to-end throughput: ``train()`` over synthetic TFRecords (the
    feed in its worker process, page-locked copies ahead of the step,
    the step), timed by a hook from step E2E_WARM to E2E_WARM +
    measure; and the host pipeline alone (in this process, the same
    config and seed), its asymptote, with the host library's record
    reader and with the Python one in turns."""
    from cap2det_tpu_torch import native
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.data import synthetic, tfrecord
    from cap2det_tpu_torch.kernels import build
    from cap2det_tpu_torch.text import extractors
    from cap2det_tpu_torch.train import trainer

    device = params_lib.resolve_device(args.device)
    fields = benchlib.device_fields(device)
    measure = args.measure_steps or E2E_MEASURE
    classes = class_names(NUM_CLASSES)
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as work:
        label_file = synthetic.write_label_file(
            os.path.join(work, "labels.txt"), classes)
        record = os.path.join(work, "train.record")
        synthetic.write_synthetic_dataset(
            record, num_examples=E2E_RECORDS, seed=0, classes=classes,
            image_hw=E2E_IMAGE_HW, num_proposals=NUM_PROPOSALS)
        reader_text = """
          cap2det_reader {
            input_pattern: "%s"
            is_training: true
            shuffle_buffer_size: 8
            batch_size: %d
            image_resizer {
              keep_aspect_ratio_resizer { min_dimension: %d }
            }
            preprocess_options { random_flip_left_right_prob: 0.5 }
            max_num_proposals: %d
            batch_resize_scale_value: 1.0
            map_num_parallel_calls: 8
          }
        """ % (record, BATCH, args.e2e_min_dim, NUM_PROPOSALS)
        cfg = apply_overrides(schema.loads_pipeline(
            "train_reader { %s } %s" % (reader_text,
                                        pipeline_text(label_file))))
        object.__setattr__(cfg.train_config, "log_step_count_steps", 10 ** 9)

        def host_rate():
            pipe = pipeline_lib.build_input_pipeline(
                cfg.train_reader, seed=1,
                label_extractor=extractors.build_label_extractor(
                    cfg.model.cap2det_model.label_extractor))
            it = iter(pipe)
            try:
                for _ in range(E2E_HOST_WARM):
                    next(it)
                t0 = time.perf_counter()
                for _ in range(E2E_HOST_BATCHES):
                    next(it)
                return BATCH * E2E_HOST_BATCHES / (time.perf_counter() - t0)
            finally:
                it.close()

        # The feed alone in this process, reading its records through the
        # host library (as train() does) and through the Python reader,
        # in turns.
        readers = {"native": native.read_records_native,
                   "python": lambda path: tfrecord.read_records(path)}
        host_rates = {"native": [], "python": []}
        for name in ("native", "python", "python", "native"):
            native.read_records_native = readers[name]
            try:
                host_rates[name].append(host_rate())
            finally:
                native.read_records_native = readers["native"]

        marks = {}

        def hook(step, state, logs):
            if step == 1:
                marks["first_wait_s"] = logs["input/wait_sec"]
            if step in (E2E_WARM, E2E_WARM + measure):
                loss = float(logs["loss/total_loss"])  # waits for the step
                benchlib.synchronize(device)
                marks[step] = (time.perf_counter(), kernels.launch_counts(),
                               loss)

        trainer.train(cfg, model_dir=None, max_steps=E2E_WARM + measure,
                      seed=2, hooks=[hook], device=device)
    (t_a, k_a, _), (t_b, k_b, loss) = marks[E2E_WARM], marks[
        E2E_WARM + measure]
    if not math.isfinite(loss):
        raise AssertionError("e2e: non-finite loss %r" % loss)
    launches = {k: (k_b[k] - k_a[k]) / measure for k in k_b}
    check_launches(launches, False, device)
    out = {
        "metric": "cap2det_e2e_train_images_per_sec",
        "value": BATCH * measure / (t_b - t_a), "unit": "images/sec",
        "min_dimension": args.e2e_min_dim,
        "host_pipeline_images_per_sec": statistics.median(
            host_rates["native"]),
        "host_pipeline_python_reader_images_per_sec": statistics.median(
            host_rates["python"]),
        "host_pipeline_turns": host_rates,
        "record_reader": "native.read_records_native",
        "host_library_s": build.host_build_info.get("seconds"),
        "host_library_built": build.host_build_info.get("built"),
        "first_step_wait_s": marks["first_wait_s"],
        "host_workers": max(1, min(
            cfg.train_reader.cap2det_reader.map_num_parallel_calls,
            os.cpu_count() or 1)),
        "steps_measured": measure, "launches": launches,
        "note": "e2e = the feed in its worker process + page-locked copies "
                "ahead of the step + the step, steps %d-%d on the host "
                "clock; host_pipeline is the feed alone in this process, "
                "its records read by the host library's reader as train() "
                "reads them (the Python reader's rate beside it, in turns "
                "native, python, python, native); first_step_wait_s is the "
                "first step's wait on the worker"
                % (E2E_WARM + 1, E2E_WARM + measure),
        **fields,
    }
    benchlib.json_line(out)
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--cpu_baseline", action="store_true",
        help="Measure the same step in float32 on the host CPU (the "
             "baseline floor) and write cap2det_tpu_torch/BASELINE_CPU.json.")
    parser.add_argument(
        "--e2e", action="store_true",
        help="Measure train() end to end over synthetic TFRecords instead "
             "of the step on a placed batch.")
    parser.add_argument(
        "--e2e_min_dim", type=int, default=1000,
        help="keep-aspect min_dimension of the --e2e run.")
    parser.add_argument(
        "--shape", choices=sorted(SHAPES), default="bench",
        help="'bench' (batch 2 / P=500 / 80 classes, Mixed_4e trainable) or "
             "'inc2' (batch 1 / P=2000 / 20 classes, the voc07_inc2 "
             "freeze).")
    parser.add_argument("--measure_steps", type=int, default=None,
                        help="steps per timed round")
    parser.add_argument(
        "--batch", type=int, default=None,
        help="Override the shape's batch size (losses are batch means).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument(
        "--second_stage_remat", action="store_true",
        help="Recompute the second stage's Mixed_5 blocks in the backward "
             "instead of keeping their intermediates (the train CLI's "
             "option of that name); the step bench only.")
    args = parser.parse_args(argv)
    if args.second_stage_remat and (args.e2e or args.cpu_baseline):
        parser.error("--second_stage_remat is an option of the step bench, "
                     "not of --e2e or --cpu_baseline")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.e2e:
        return run_e2e(args)
    return run_step_bench(args)


if __name__ == "__main__":
    main()
