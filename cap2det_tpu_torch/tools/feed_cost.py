"""Measures what the input pipeline's threads cost ``train()`` on one GPU.

Runs ``trainer.train`` at configs/coco17_extend_match.pbtxt as shipped
(the records, steps and logging of chip_smoke.py's train_loop phase) in
several variants, in one process, in the order given and then reversed:

  made          batches made beforehand: no thread decodes or resizes
  feed_proc     train() as shipped: the input pipeline in a worker
                process, canvases page-locked on a thread of the trainer
  feed_proc_nopin  as feed_proc, the canvases page-locked by the loop
                itself (``device_batch``)
  feed          the input pipeline on a thread of the training process
                (train()'s feed before it moved to a worker process)
  feed_1t       as feed, its threads running torch's CPU ops on one
                intra-op thread each
  feed_1t_w2    as feed_1t with map_num_parallel_calls 2
  feed_noresize as feed, the canvas resize replaced by a zero canvas of
                the same shape (its numbers say nothing of the model)
  made_busy     as made, while another process runs the input pipeline
                without pause (the feed's work without sharing the
                launching thread's interpreter)

and prints, per run, the medians of a step on the card's timeline (CUDA
events, event to event) and on the host clock, the launching thread's
own CPU time per step (``time.thread_time``), the loop's wait on the
pipeline and its time placing batches, over the steps that are neither a
bucket's first nor wrote metrics or a checkpoint. It also times each
pipeline variant alone (no training), and first probes the interpreter
lock: for each piece of the feed's work, its time alone and the rate at
which the main thread runs Python while a second thread does that work
(1.0: the work leaves the lock free). Run from the repository root:

    python3 -m cap2det_tpu_torch.tools.feed_cost [--steps 40]

One JSON line per run; exits nonzero if a run fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

VARIANTS = ("made", "feed_proc", "feed", "made_busy")
IN_THREAD = ("made", "made_busy", "feed", "feed_1t", "feed_1t_w2",
             "feed_noresize")


def _python_rate(target):
    """Iterations per second of a pure-Python loop run on the main thread
    while a second thread runs `target`."""
    worker = threading.Thread(target=target)
    n, t0 = 0, time.perf_counter()
    worker.start()
    while worker.is_alive():
        n += 1
    return n / (time.perf_counter() - t0)


def _probe(name, fn, calls):
    """fn's time alone, and the main thread's Python rate while a second
    thread calls it, as a share of the rate while the second thread
    sleeps as long."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    alone = time.perf_counter() - t0
    base = _python_rate(lambda: time.sleep(alone))
    rate = _python_rate(lambda: [fn() for _ in range(calls)])
    return {"probe": name, "ms_alone": 1e3 * alone / calls,
            "main_python_rate": rate / base}


def probe_lock(torch, record_path):
    """The interpreter-lock probes of the feed's pieces, one JSON line
    each, on the first record of `record_path`."""
    import hashlib
    import zlib

    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.data import png, tfrecord

    record = next(tfrecord.read_records(record_path))
    encoded = pipeline_lib.parse_example(record)["image_encoded"]
    idat = b"".join(bytes(body) for kind, body in png._chunks(encoded)
                    if kind == b"IDAT")
    image = png.decode_png(encoded)
    threads = torch.get_num_threads()
    blob = bytes(32 << 20)

    def resize(n):
        def run():
            torch.set_num_threads(n)
            pipeline_lib.fit_image_to_canvas(image, (1216, 1824))
        return run

    def python_loop():
        sum(i * i for i in range(200000))

    probes = [("sha256 32 MiB (releases the lock)",
               lambda: hashlib.sha256(blob).digest(), 10),
              ("pure Python loop (holds the lock)", python_loop, 10),
              ("parse_example", lambda: pipeline_lib.parse_example(record),
               20),
              ("zlib.decompress of the PNG data", lambda: zlib.decompress(
                  idat), 20),
              ("png.decode_png", lambda: png.decode_png(encoded), 20),
              ("fit_image_to_canvas 1216x1824, 1 thread", resize(1), 10),
              ("fit_image_to_canvas 1216x1824, %d threads" % threads,
               resize(threads), 10)]
    try:
        for name, fn, calls in probes:
            print(json.dumps(_probe(name, fn, calls)), flush=True)
    finally:
        torch.set_num_threads(threads)


def _drain(started, build, args, kwargs):
    for _ in build(*args, **kwargs):
        started.set()


def _one_intra_op_thread(prep):
    """Wraps InputPipeline._prep_example so that each thread that runs it
    first sets its own intra-op thread count to 1."""
    import torch

    local = threading.local()

    def wrapped(self, task):
        if not getattr(local, "set", False):
            torch.set_num_threads(1)
            local.set = True
        return prep(self, task)

    return wrapped


def _zero_canvas(image, canvas_hw):
    """fit_image_to_canvas's shapes without its resize."""
    import torch

    h, w = image.shape[:2]
    ch, cw = canvas_hw
    scale = min(min(ch, cw) / min(h, w), ch / h, cw / w)
    new_h = max(1, min(ch, int(round(h * scale))))
    new_w = max(1, min(cw, int(round(w * scale))))
    return torch.zeros((ch, cw, 3), dtype=torch.uint8), (new_h, new_w)


class _Patched:
    """The variant's patches of the pipeline module, undone on exit (the
    process-wide intra-op count too, which a thread's
    torch.set_num_threads also sets for threads started later)."""

    def __init__(self, variant, reader, made, busy_args=None):
        self.variant, self.reader, self.made = variant, reader, made
        self.busy_args = busy_args

    def __enter__(self):
        import torch

        from cap2det_tpu_torch.data import pipeline as pipeline_lib

        self.lib, self.threads = pipeline_lib, torch.get_num_threads()
        self.saved = (pipeline_lib.build_input_pipeline,
                      pipeline_lib.in_worker_process,
                      pipeline_lib.fit_image_to_canvas,
                      pipeline_lib.InputPipeline._prep_example,
                      self.reader.map_num_parallel_calls)
        self.busy = None
        if self.variant in IN_THREAD:
            pipeline_lib.in_worker_process = lambda pipe, device: pipe
        if self.variant == "feed_proc_nopin":
            pipeline_lib.in_worker_process = (
                lambda pipe, device: self.saved[1](pipe, "cpu"))
        if self.variant == "made_busy":
            import multiprocessing

            # Started before the patches: the child unpickles the
            # module's own build_input_pipeline.
            context = multiprocessing.get_context("spawn")
            started = context.Event()
            self.busy = context.Process(
                target=_drain, args=(started, self.saved[0]) + self.busy_args,
                daemon=True)
            self.busy.start()
            if not started.wait(300):
                raise RuntimeError("feed_cost: the busy process made no batch")
        if self.variant in ("made", "made_busy"):
            pipeline_lib.build_input_pipeline = lambda *a, **k: self.made
        if self.variant.startswith("feed_1t"):
            pipeline_lib.InputPipeline._prep_example = _one_intra_op_thread(
                self.saved[3])
        if self.variant == "feed_1t_w2":
            self.reader.map_num_parallel_calls = 2
        if self.variant == "feed_noresize":
            pipeline_lib.fit_image_to_canvas = _zero_canvas
        return self

    def __exit__(self, *exc):
        import torch

        if self.busy is not None:
            self.busy.terminate()
            self.busy.join()

        (self.lib.build_input_pipeline, self.lib.in_worker_process,
         self.lib.fit_image_to_canvas, self.lib.InputPipeline._prep_example,
         self.reader.map_num_parallel_calls) = self.saved
        torch.set_num_threads(self.threads)
        return False


def _run(torch, trainer, cfg, model_dir, steps):
    records = []

    def hook(step, state, logs):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        records.append({
            "step": step, "host": time.perf_counter(),
            "cpu": time.thread_time(), "event": end,
            "wait": logs["input/wait_sec"], "place": logs["input/place_sec"],
            "canvas": (int(logs["input/canvas_height"]),
                       int(logs["input/canvas_width"]))})

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0, c0 = time.perf_counter(), time.thread_time()
    trainer.train(cfg, model_dir=model_dir, max_steps=steps, hooks=[hook])
    torch.cuda.synchronize()
    tc = cfg.train_config
    seen, steady = set(), []
    prev = {"event": start, "host": t0, "cpu": c0}
    for r in records:
        row = {"event_ms": prev["event"].elapsed_time(r["event"]),
               "host_ms": 1e3 * (r["host"] - prev["host"]),
               "cpu_ms": 1e3 * (r["cpu"] - prev["cpu"]),
               "wait_ms": 1e3 * r["wait"], "place_ms": 1e3 * r["place"]}
        first = r["canvas"] not in seen
        seen.add(r["canvas"])
        if not (first or r["step"] % tc.save_checkpoints_steps == 0
                or r["step"] % tc.log_step_count_steps == 0):
            steady.append(row)
        prev = r
    out = {"steps": len(records), "steady": len(steady),
           "buckets": len(seen)}
    for key in ("event_ms", "host_ms", "cpu_ms", "wait_ms", "place_ms"):
        out["median_" + key] = float(np.median([r[key] for r in steady]))
    return out


def _feed_alone(pipeline_lib, cfg, label_extractor, batches):
    it = iter(pipeline_lib.in_worker_process(
        pipeline_lib.build_input_pipeline(cfg.train_reader, seed=0,
                                          label_extractor=label_extractor),
        "cuda"))
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        return 1e3 * (time.perf_counter() - t0) / batches
    finally:
        it.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("feed_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.text import extractors
    from cap2det_tpu_torch.train import trainer

    variants = args.variants.split(",")
    chip_smoke.phase_build()
    with tempfile.TemporaryDirectory(prefix="feed_cost_") as tmp:
        pattern = chip_smoke.write_train_records(tmp, 8, (480, 640),
                                                 chip_smoke.SEED + 9)
        cfg = schema.load_pipeline(os.path.join(
            "configs", "coco17_extend_match.pbtxt"))
        reader = cfg.train_reader.cap2det_reader
        reader.input_pattern = [pattern]
        cfg.train_config.save_checkpoints_steps = 10
        cfg.train_config.log_step_count_steps = 5
        extractor = extractors.build_label_extractor(
            cfg.model.cap2det_model.label_extractor)
        it = iter(pipeline_lib.build_input_pipeline(
            cfg.train_reader, seed=0, label_extractor=extractor))
        try:
            made = [next(it) for _ in range(args.steps + 2)]
        finally:
            it.close()

        print(json.dumps({"intra_op_threads": torch.get_num_threads(),
                          "cpus": os.cpu_count(),
                          "usable_cpus": len(os.sched_getaffinity(0))}),
              flush=True)
        probe_lock(torch, sorted(glob.glob(pattern))[0])
        busy_args = ((cfg.train_reader,),
                     {"seed": 1, "label_extractor": extractor})
        for variant in variants:
            if variant in ("made", "made_busy"):
                continue
            with _Patched(variant, reader, made):
                ms = _feed_alone(pipeline_lib, cfg, extractor, args.steps)
            print(json.dumps({"feed_alone": variant,
                              "ms_per_batch": ms}), flush=True)
        for n, variant in enumerate(variants + variants[::-1]):
            with _Patched(variant, reader, made, busy_args):
                line = _run(torch, trainer, cfg,
                            os.path.join(tmp, "run%d" % n), args.steps)
            print(json.dumps(dict({"run": n, "variant": variant}, **line)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
