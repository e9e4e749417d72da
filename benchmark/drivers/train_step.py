"""Driver of the training step: ``train/trainer.make_train_step`` on the
state ``TrainState.create`` would make (``optimizers.build_optimizer``,
fused by default, over the benchmark's weights), each batch through
``Cap2DetModel.device_batch`` (the page-locked copy ``train()`` makes),
one step at a time, as ``train()`` runs them.

Set-up builds the one step object and drives it through its first steps,
one on each bucket canvas (the warm-up). The window then steps the
seeded schedule of buckets for the given seconds and ends in a
synchronise. ``train_images_per_s`` is every image stepped over the
window's time.

The check follows two sets of CHECKED_STEPS steps of that same object,
each on three different batches, with the reference's steps from the
same state: the first steps of set-up, from the seed's weights, and
three more once the window has closed, from the state (params, Adagrad
accumulators, step count) the window left, on canvases the window has
warmed. So a path that only switches on after the first steps is
checked too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import cap2det as ref
from benchmark.yardstick import compare, flops, traffic, weights

CHECKED_STEPS = 3
WINDOW = "window_"  # the prefix of the numbers of the steps after it


class Program:
    """The program's training step object over `params`."""

    def __init__(self, config, params, device):
        import cap2det_tpu_torch.models  # noqa: F401  (registers the model)
        from cap2det_tpu_torch.config import schema
        from cap2det_tpu_torch.models import registry
        from cap2det_tpu_torch.train import optimizers, trainer

        self.pipeline = schema.loads_pipeline(config["pbtxt"])
        self.model = registry.build(self.pipeline.model, is_training=True,
                                    device=device)
        train_config = self.pipeline.train_config
        self.tx, mask, _ = optimizers.build_optimizer(
            train_config, params,
            non_trainable_paths=self.model.non_trainable_paths,
            non_trainable_substrings=self.model.non_trainable_substrings)
        trainer.set_trainable(params, mask)
        self.state = {"params": params, "opt_state": self.tx.init(params),
                      "step": 0}
        self.step_fn = trainer.make_train_step(self.model, self.tx,
                                               train_config, mask)
        self.flatten = optimizers.flatten_params
        self._batch = None

    def step(self, host_batch, seed):
        batch = self.model.device_batch(host_batch)
        self.state, logs = self.step_fn(self.state, batch, seed)
        self._batch = batch  # its page-locked source lives until now
        return logs

    def trainable(self):
        return [(path, leaf) for path, leaf in
                self.flatten(self.state["params"]) if leaf.requires_grad]

    def accumulators(self):
        return {path: s["sum_of_squares"]
                for path, s in self.state["opt_state"]["slots"].items()}

    def snapshot(self):
        """The state on the host: {"params", "accumulators", "count"}."""
        return {"params": weights.to_device(self.state["params"], "cpu"),
                "accumulators": {p: a.detach().to("cpu", copy=True)
                                 for p, a in self.accumulators().items()},
                "count": int(self.state["step"])}


def accumulator_norms(accumulators, before):
    """{leaf: sqrt(sum(acc - acc before))}: the gradient's norm as an
    Adagrad accumulator holds it after one step."""
    return {path: float(torch.sqrt((acc.detach().cpu().double()
                                    - before[path].double()).sum()))
            for path, acc in accumulators.items()}


def change_norms(leaves, start):
    """{leaf: ||leaf - start leaf||} in float64 on the host."""
    return {path: float(torch.linalg.vector_norm(
        leaf.detach().cpu().double() - start[path].double()))
        for path, leaf in leaves}


def _flat(tree):
    return dict(ref.flatten(tree))


def reference_batch(host_batch, device):
    return {"image": torch.as_tensor(host_batch["image"], device=device),
            "proposals": torch.as_tensor(host_batch["proposals"],
                                         device=device),
            "num_proposals": torch.as_tensor(
                host_batch["number_of_proposals"], device=device),
            "labels": torch.as_tensor(host_batch["pseudo_labels"],
                                      device=device)}


def program_steps(program, host_batches, seed):
    """Steps the program once on each of `host_batches` from the state it
    holds: (readings, the state they started from on the host). The
    readings are {"losses", "grad_norms" (the first step's, from the
    accumulators), "change_norms" (over all the steps)}."""
    start = program.snapshot()
    readings = {"losses": []}
    for k, host_batch in enumerate(host_batches):
        logs = program.step(host_batch, seed)
        readings["losses"].append(float(logs["loss/total_loss"]))
        if k == 0:
            readings["grad_norms"] = accumulator_norms(
                program.accumulators(), start["accumulators"])
    readings["change_norms"] = change_norms(program.trainable(),
                                            _flat(start["params"]))
    return readings, start


def reference_steps(config, start, host_batches, seed, device,
                    head_dtype=torch.float32):
    """The reference's steps from the state `start` over the same batches
    and seed: the readings ``compare.train_numbers`` reads."""
    params = weights.to_device(start["params"], device)
    trainer = ref.AdagradTrainer(
        params, config["train"], config["model"], head_dtype=head_dtype,
        accumulators={p: a.to(device) for p, a in
                      start["accumulators"].items()},
        count=start["count"])
    readings = {"losses": []}
    for k, host_batch in enumerate(host_batches):
        readings["losses"].append(
            trainer.step(reference_batch(host_batch, device), seed))
        if k == 0:
            readings["grad_norms"] = accumulator_norms(trainer.accumulators,
                                                       start["accumulators"])
            readings["true_grad_norms"] = trainer.first_grad_norms
    readings["change_norms"] = change_norms(
        [(p, leaf) for p, leaf, _ in trainer.leaves], _flat(start["params"]))
    return readings


def window_flops(config, buckets, units):
    """The reference's operations of the steps `units`: [(bucket, valid
    proposals of the batch)]."""
    counts = flops.cached("train_step", config, [b[2] for b in buckets],
                          flops.train_step_flops)
    return sum(flops.unit_flops(counts, buckets[b][2], valid)
               for b, valid in units)


def setup(ctx, program_cls=Program):
    """The step object, its inputs and its first steps, as a run's
    set-up makes them: a dict the window and the check read."""
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    if torch.device(dev).type == "cuda":
        from cap2det_tpu_torch.kernels import build

        ctx.clock.lap("imports")
        build.library()
        ctx.clock.lap("kernel_library")
    else:
        ctx.clock.lap("imports")
    params = weights.make_params(config["model"], ctx.seed, dev)
    program = program_cls(config, params, dev)
    harness.synchronize(dev)
    ctx.clock.lap("weights")
    host = traffic.train_batches(mix, config, ctx.seed)
    buckets = traffic.train_buckets(config)
    order = list(np.random.default_rng([ctx.seed, 4]).permutation(
        len(buckets)))
    ctx.clock.lap("inputs")
    first = [host[b][0] for b in order[:CHECKED_STEPS]]
    readings, start = program_steps(program, first, ctx.seed)
    for b in order[CHECKED_STEPS:]:
        program.step(host[b][0], ctx.seed)
    harness.synchronize(dev)
    ctx.clock.lap("warmup")
    return {"program": program, "host": host, "buckets": buckets,
            "order": order,
            "phases": [("", start, first, readings)]}


def run(ctx, program_cls=Program):
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    s = setup(ctx, program_cls)
    program, host, buckets = s["program"], s["host"], s["buckets"]
    setup_s = ctx.clock.total()
    card = harness.card(dev)
    ctx.line({"setup_s": setup_s, "pieces": ctx.clock.pieces})

    schedule = traffic.train_schedule(mix, config, ctx.seed, cycles=1)
    uses = {b: 0 for b in range(len(buckets))}

    def next_batch(k):
        b = schedule[k % len(schedule)]
        batch = host[b][uses[b] % len(host[b])]
        uses[b] += 1
        return b, batch

    batch_size = config["train"]["batch_size"]
    before = harness.launch_counts()
    steps, units, starts = 0, [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        starts.append(time.perf_counter())
        b, batch = next_batch(steps)
        program.step(batch, ctx.seed)
        units.append((b, batch["number_of_proposals"]))
        steps += 1
    harness.synchronize(dev)
    window_s = time.perf_counter() - t0
    ctx.line({"steps_per_second": harness.per_second(starts, t0,
                                                     ctx.seconds)})
    launches = harness.per_unit(before, harness.launch_counts(), steps)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if torch.device(dev).type == "cuda" else 0)
    ctx.line({"card": card, "memory_peak_bytes": memory_peak,
              "launches_per_step": launches, "steps": steps,
              "window_s": window_s})
    outcome = {
        "setup_s": setup_s, "card": card, "memory_peak_bytes": memory_peak,
        "attempted": steps, "failed": 0,
        "end_to_end": {"train_images_per_s": steps * batch_size / window_s},
    }

    if ctx.trace:
        def run_units(n):
            for k in range(n):
                with torch.profiler.record_function(harness.SPAN_UNIT):
                    program.step(next_batch(steps + k)[1], ctx.seed)

        trace, work = harness.traced(
            dev, run_units, mix["traced_steps"],
            [(program.model, "prepare", harness.SPAN_PREPARE, None)])
        t = time.perf_counter()
        total = window_flops(config, buckets,
                             [(b, int(valid.sum())) for b, valid in units])
        ctx.line({"reference_flops_s": time.perf_counter() - t})
        outcome["traced"] = {
            "trace": trace, "kernel_work": work, "kind": card["kind"],
            "units": mix["traced_steps"], "window_s": window_s,
            "window_units": steps, "window_flops": total}

    # Three more steps of the same object from the state the window left,
    # on canvases it has warmed; then the program's state is freed, so the
    # reference neither shares nor sets its memory.
    last = [host[b][-1] for b in s["order"][-CHECKED_STEPS:]]
    readings, start = program_steps(program, last, ctx.seed)
    s["phases"].append((WINDOW, start, last, readings))
    del program, s["program"]
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    numbers, phases = {}, []
    for prefix, start, batches, readings in s["phases"]:
        reference = reference_steps(config, start, batches, ctx.seed, dev)
        for name, value in compare.train_numbers(readings,
                                                 reference).items():
            numbers[prefix + name] = value
        phases.append((prefix, start, batches, readings, reference))
    outcome["correct"], outcome["checks"] = compare.verdict(numbers,
                                                            ctx.limits)
    outcome["numbers"], outcome["phases"] = numbers, phases
    return outcome
