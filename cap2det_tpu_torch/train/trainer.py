"""The training step (port of ``cap2det_tpu/train/trainer.py``:
``TrainState``, ``make_train_step``, ``eval_params``).

A step: seed a generator from (seed, step) -> ``model.loss`` -> gradients
of the trainable leaves only (frozen leaves have ``requires_grad=False``,
so autograd never builds their cone: under a full first-stage freeze no
ROI backward runs) -> the optimizer updates the params in place. The loop
around the step, which reads the TFRecord input pipeline and writes
checkpoints and metrics, arrives with the data slice.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch.train import optimizers


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


def step_seed(seed, step):
    """The step's generator seed, a function of (seed, step) only, as
    ``jax.random.fold_in(rng, step)`` is: reproducible across restarts."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def make_train_step(model, tx, train_config, trainable_mask=None):
    """fn(state, batch, seed) -> (state, logs) for one training step.

    `batch` is ``model.device_batch`` of a host batch. The params are
    updated in place; logs stay tensors on the device until read.
    """
    ema_decay = _ema_decay(train_config)

    def train_step(state, batch, seed):
        params = state["params"]
        if trainable_mask is not None:
            set_trainable(params, trainable_mask)
        trainable = [(path, leaf)
                     for path, leaf in optimizers.flatten_params(params)
                     if leaf.requires_grad]
        generator = torch.Generator(device=model.device)
        generator.manual_seed(step_seed(seed, state["step"]))
        total, loss_dict = model.loss(params, batch, generator=generator,
                                      is_training=True)
        grads = torch.autograd.grad(total, [leaf for _, leaf in trainable],
                                    allow_unused=True)
        grads = {path: torch.zeros_like(leaf) if g is None else g
                 for (path, leaf), g in zip(trainable, grads)}
        opt_state = tx.apply(params, grads, state["opt_state"])

        new_state = dict(state, opt_state=opt_state, step=state["step"] + 1)
        if ema_decay is not None:
            new_state["ema"] = optimizers.ema_update(state["ema"], params,
                                                     ema_decay)
        logs = {"loss/total_loss": total.detach()}
        logs.update({"loss/" + k: v.detach() for k, v in loss_dict.items()})
        return new_state, logs

    return train_step


def eval_params(state):
    """Parameters to evaluate or export: the moving average when enabled."""
    return state.get("ema", state["params"])
