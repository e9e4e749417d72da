"""The training loop (port of ``cap2det_tpu/train/trainer.py``).

  pipeline config -> model (registry) -> input pipeline in a worker
  process -> page-locked host batches copied ahead of the step -> train
  step -> metrics and checkpoints at the configured cadence.

The feed runs in its own process because on a thread of this one it
takes the interpreter lock from the thread that launches the step's
small kernels and slows every step (PERF.md §5).

A step: seed a generator from (seed, step) -> ``model.loss`` -> gradients
of the trainable leaves only (frozen leaves have ``requires_grad=False``,
so autograd never builds their cone: under a full first-stage freeze no
ROI backward runs) -> in a process group, the gradients and losses
averaged across the ranks -> the optimizer updates the params in place.

Data parallelism is one process per card in a ``torch.distributed``
group (``parallel/distributed.py``): the JAX trainer's multi-host mesh,
and its single-process mesh over a host's n chips, are both
``torchrun --nproc_per_node=n`` here. JAX's live profiler server
(``profiler_port``) has no counterpart; ``profile_steps`` writes a trace.
"""

from __future__ import annotations

import collections
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline as pipeline_lib
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.parallel import mesh as mesh_lib
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import metrics as metrics_lib
from cap2det_tpu_torch.train import optimizers

log = logging.getLogger("cap2det_torch.trainer")


class TrainState:
    """The state is a plain dict: params, opt_state, step (a Python int),
    and ema when moving averages are enabled."""

    @staticmethod
    def create(model, train_config, seed):
        """(state, optimizer, schedule, trainable_mask) with fresh params
        from `seed`, each leaf's requires_grad set from the mask."""
        params = model.init_params(seed)
        tx, mask, schedule = optimizers.build_optimizer(
            train_config, params,
            non_trainable_paths=model.non_trainable_paths,
            non_trainable_substrings=getattr(model,
                                             "non_trainable_substrings", ()),
        )
        set_trainable(params, mask)
        state = {"params": params, "opt_state": tx.init(params), "step": 0}
        if _ema_decay(train_config) is not None:
            state["ema"] = optimizers.ema_init(params)
        return state, tx, schedule, mask


def _ema_decay(train_config):
    """Effective moving-average decay, or None when disabled. Decay 0.0
    (every shipped config) makes the average equal the live params after
    every step, so it is elided: ``eval_params`` serves the live params."""
    if not train_config.has_field("moving_average_decay"):
        return None
    decay = train_config.moving_average_decay
    return decay if decay > 0.0 else None


def set_trainable(params, trainable_mask):
    """requires_grad of every leaf from the nested bool mask."""
    mask = dict(optimizers.flatten_params(trainable_mask))
    for path, leaf in optimizers.flatten_params(params):
        leaf.requires_grad_(bool(mask[path]))


def step_seed(seed, step, rank=None):
    """The step's generator seed, a function of (seed, step) only, as
    ``jax.random.fold_in(rng, step)`` is: reproducible across restarts.
    With a `rank`, the rank is folded in as well, as JAX folds in the
    data-axis index: each rank draws its own dropout."""
    entropy = [seed, step] if rank is None else [seed, step, rank]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def make_train_step(model, tx, train_config, trainable_mask=None,
                    process_group=None):
    """fn(state, batch, seed) -> (state, logs) for one training step.

    `batch` is ``model.device_batch`` of a host batch. The params are
    updated in place; logs stay tensors on the device until read.

    With a `process_group` (the counterpart of JAX's ``pmean_axis``),
    `batch` is this rank's slice of the global batch: the trainable
    gradients, the total and the logged losses are averaged across the
    ranks before the update, so every rank applies the same update. In a
    group of more than one rank, the step seed also takes the rank. A
    group of one keeps the no-group step's bits.
    """
    ema_decay = _ema_decay(train_config)
    rank = None
    if process_group is not None and mesh_lib.world_size(process_group) > 1:
        rank = mesh_lib.rank(process_group)

    def train_step(state, batch, seed):
        params = state["params"]
        if trainable_mask is not None:
            set_trainable(params, trainable_mask)
        trainable = [(path, leaf)
                     for path, leaf in optimizers.flatten_params(params)
                     if leaf.requires_grad]
        generator = torch.Generator(device=model.device)
        generator.manual_seed(step_seed(seed, state["step"], rank))
        total, loss_dict = model.loss(params, batch, generator=generator,
                                      is_training=True)
        grads = torch.autograd.grad(total, [leaf for _, leaf in trainable],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for (_, leaf), g in zip(trainable, grads)]
        total = total.detach()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        if process_group is not None:
            keys = list(loss_dict)
            reduced = mesh_lib.all_reduce_mean(
                grads + [total] + [loss_dict[k] for k in keys],
                process_group)
            grads, total = reduced[:len(grads)], reduced[len(grads)]
            loss_dict = dict(zip(keys, reduced[len(grads) + 1:]))
        opt_state = tx.apply(
            params, {path: g for (path, _), g in zip(trainable, grads)},
            state["opt_state"])

        new_state = dict(state, opt_state=opt_state, step=state["step"] + 1)
        if ema_decay is not None:
            new_state["ema"] = optimizers.ema_update(state["ema"], params,
                                                     ema_decay)
        logs = {"loss/total_loss": total}
        logs.update({"loss/" + k: v for k, v in loss_dict.items()})
        return new_state, logs

    return train_step


def eval_params(state):
    """Parameters to evaluate or export: the moving average when enabled."""
    return state.get("ema", state["params"])


def _device_prefetch(host_batches, place, timing, depth=2):
    """Keeps `depth` placed batches in flight: the next batch's copy to the
    card (page-locked, ``non_blocking``) is queued before the current step
    runs, so the host never waits on it. A placed batch keeps its
    page-locked source tensors until the loop has queued the step that
    reads it and asked for the next batch. Closing this generator closes
    `host_batches`, which stops the input pipeline.

    Every batch taken adds to timing["wait"] the seconds spent waiting on
    `host_batches` and to timing["place"] the seconds `place` took."""
    buf = collections.deque()
    it = iter(host_batches)

    def fetch():
        t0 = time.perf_counter()
        host = next(it)
        t1 = time.perf_counter()
        placed = place(host)
        timing["wait"] += t1 - t0
        timing["place"] += time.perf_counter() - t1
        return placed

    try:
        try:
            while len(buf) < depth:
                buf.append(fetch())
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(fetch())
            except StopIteration:
                pass
            yield out
    finally:
        if hasattr(it, "close"):
            it.close()


def _pipeline_seed(reader, seed, group):
    """The input pipeline's seed on this rank. Alone, `seed`. In a group,
    the ranks must feed distinct slices of the global batch: the reader's
    shard_indicator partitions the records when the ranks' numerators
    differ (one pbtxt reused on every rank does not), and otherwise each
    rank takes seed + 7919 x rank, which decorrelates shuffling and
    augmentation but samples the same records."""
    rank, world = mesh_lib.rank(group), mesh_lib.world_size(group)
    if world == 1:
        return seed
    shard = reader.cap2det_reader.shard_indicator
    if shard:
        numers = mesh_lib.all_gather_ints(
            [int(shard.split("/")[0])], group)[:, 0].tolist()
        if len(set(numers)) == len(numers):
            log.info("data parallel: per-rank data from shard_indicator %r",
                     shard)
            return seed
        log.warning(
            "shard_indicator %r numerators are not distinct across ranks "
            "(%s) — not a data partition; falling back to per-rank seed "
            "decorrelation", shard, numers)
    pipe_seed = seed + 7919 * rank
    log.warning(
        "data-parallel training without a distinct train_reader."
        "shard_indicator: decorrelating ranks by per-rank pipeline seed %d; "
        "set shard_indicator: '%d/%d' for a disjoint data partition",
        pipe_seed, rank, world)
    return pipe_seed


def _broadcast_state(state, group, device):
    """Rank 0's params, optimizer slots, moving average, step and update
    count on every rank, in place: the other ranks restored nothing."""
    counters = torch.tensor([state["step"], state["opt_state"]["count"]],
                            device=device)
    tree = {"params": state["params"], "slots": state["opt_state"]["slots"],
            "counters": counters}
    if "ema" in state:
        tree["ema"] = state["ema"]
    mesh_lib.broadcast_params(tree, src=0, group=group)
    state["step"], state["opt_state"]["count"] = (int(c) for c in
                                                   counters.tolist())


def _stop_profile(profiler, profile_dir, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def train(
    pipeline_config: schema.Pipeline,
    model_dir=None,
    max_steps=None,
    log_every=None,
    seed=0,
    hooks=(),
    pretrained_checkpoint=None,
    profile_steps=None,
    device="cuda",
):
    """Runs training per the pipeline config. Returns the final state.

    Args:
      hooks: callables hook(step, state, logs) invoked after each step.
        Besides the step's losses (tensors), `logs` holds host floats:
        "input/wait_sec", the seconds the loop waited on the input
        pipeline before the step, "input/place_sec", the seconds it spent
        pinning batches and queuing their copies to the device, and
        "input/canvas_height" / "input/canvas_width", the step's canvas
        (image batches only).
      pretrained_checkpoint: optional converted ImageNet backbone in the
        port's checkpoint format (``checkpoint.restore_params`` reads it);
        overlaid on fresh inits only — resuming from a checkpoint wins
        (reference warm-start semantics, models/utils.py:181-186).
      profile_steps: optional (start, stop) step pair; a torch.profiler
        trace of the steps between them goes to
        <model_dir>/profile/trace.json.
      device: "cuda" (the default; raises without a card) or "cpu". In a
        process group, the rank's device (``distributed.maybe_initialize``
        returns it).

    In a process group (``torch.distributed`` initialised by the caller,
    who also destroys it), every rank runs this loop on its own card with
    JAX's multi-process contract: the reader's batch_size is per rank, so
    the global batch is batch_size x world; each rank feeds distinct data,
    partitioned by the ranks' distinct shard_indicator numerators or else
    decorrelated by a pipeline seed of seed + 7919 x rank; rank 0's state
    (after a restore or a pretrained overlay) is broadcast once; each step
    averages the gradients and losses across the ranks. Only rank 0 writes
    checkpoints, metrics and a profile; the other ranks wait at the next
    collective. Ranks may hold batches of different canvas buckets in one
    step: only gradients, shaped as the params, are reduced. Every rank
    must reach max_steps: a rank whose feed ends early leaves the others
    waiting in the all-reduce until the group's timeout.
    """
    device = params_lib.resolve_device(device)
    model_dir = model_dir or pipeline_config.model_dir
    train_config = pipeline_config.train_config
    max_steps = max_steps or train_config.max_steps
    log_every = log_every or train_config.log_step_count_steps
    group = dist.group.WORLD if dist.is_initialized() else None
    world = mesh_lib.world_size(group)
    chief = mesh_lib.rank(group) == 0

    model = registry.build(pipeline_config.model, is_training=True,
                           device=device)
    reader = pipeline_config.train_reader
    pipe = pipeline_lib.build_input_pipeline(
        reader, seed=_pipeline_seed(reader, seed, group),
        **model.pipeline_kwargs())
    state, tx, schedule, trainable_mask = TrainState.create(
        model, train_config, seed)

    if pretrained_checkpoint and hasattr(model, "load_pretrained"):
        converted = params_lib.from_jax_numpy(
            ckpt_lib.restore_params(pretrained_checkpoint), device)
        state["params"] = model.load_pretrained(state["params"], converted)
        set_trainable(state["params"], trainable_mask)
        if "ema" in state:
            state["ema"] = optimizers.ema_init(state["params"])
        log.info("loaded pretrained backbone from %s", pretrained_checkpoint)

    manager = None
    writer = None
    if model_dir and chief:
        os.makedirs(model_dir, exist_ok=True)
        manager = ckpt_lib.CheckpointManager(
            model_dir, keep_max=train_config.keep_checkpoint_max)
        restored = manager.restore(state)
        if restored is not None:
            state = restored
            log.info("restored checkpoint at step %d", state["step"])
        writer = metrics_lib.MetricsWriter(model_dir)
    if group is not None:
        _broadcast_state(state, group, device)

    train_step = make_train_step(model, tx, train_config, trainable_mask,
                                 process_group=group)
    batch_size = reader.cap2det_reader.batch_size * world
    step = state["step"]
    t_start = time.time()
    t_window, window_steps, window_examples = time.time(), 0, 0
    profile_dir = os.path.join(model_dir or ".", "profile")
    profiler, profiled = None, False

    timing = {}
    batches = _device_prefetch(pipeline_lib.in_worker_process(pipe, device),
                               model.device_batch, timing)
    try:
        while step < max_steps:
            timing.update(wait=0.0, place=0.0)
            batch = next(batches, None)
            if batch is None:
                break
            if profile_steps is not None and chief:
                if not profiled and step == profile_steps[0]:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                    profiled = True
                elif profiler is not None and step >= profile_steps[1]:
                    _stop_profile(profiler, profile_dir, device)
                    profiler = None
            state, logs = train_step(state, batch, seed)
            logs["input/wait_sec"] = timing["wait"]
            logs["input/place_sec"] = timing["place"]
            if "image" in batch:  # a text batch has no canvas
                canvas = batch["image"].shape
                logs["input/canvas_height"] = float(canvas[1])
                logs["input/canvas_width"] = float(canvas[2])
            step += 1
            window_steps += 1
            window_examples += batch_size

            if step % log_every == 0 or step >= max_steps:
                total = float(logs["loss/total_loss"])  # waits for the step
                dt = time.time() - t_window
                rate = window_steps / max(dt, 1e-9)
                examples_rate = window_examples / max(dt, 1e-9)
                lr = float(schedule(step))
                log.info("step %d loss %.5f (%.2f steps/s, %.2f ex/s, "
                         "lr %.5f)", step, total, rate, examples_rate, lr)
                if writer is not None:
                    scalars = {k: float(v) for k, v in logs.items()}
                    scalars["loss/learning_rate"] = lr
                    scalars["global_step/sec"] = rate
                    scalars["examples/sec"] = examples_rate
                    writer.write(step, scalars)
                t_window, window_steps, window_examples = time.time(), 0, 0

            if (manager is not None
                    and step % train_config.save_checkpoints_steps == 0):
                manager.save(step, state)

            for hook in hooks:
                hook(step, state, logs)
    finally:
        batches.close()

    if profiler is not None:
        _stop_profile(profiler, profile_dir, device)
    if manager is not None:
        manager.save(step, state)
        manager.close()
    if writer is not None:
        writer.close()
    log.info("training finished at step %d in %.1fs", step,
             time.time() - t_start)
    return state


def create_train_and_evaluate(pipeline_config, model_dir=None, **kwargs):
    """Name-compatible entry point (reference
    trainer.create_train_and_evaluate)."""
    return train(pipeline_config, model_dir=model_dir, **kwargs)
