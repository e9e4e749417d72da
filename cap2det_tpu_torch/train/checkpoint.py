"""Checkpoints and best-model promotion (the port's copy of
``cap2det_tpu/train/checkpoint.py``, in the port's own format).

Layout: ``<model_dir>/ckpt/<step>/state.pt``, one ``torch.save`` of a
dict of CPU tensors and plain Python values:

  * ``params`` (and ``ema`` when kept): the JAX package's layout, through
    ``params.to_jax_numpy`` (a pure permutation, so a round trip is
    bit-exact), as tensors;
  * ``opt_state``: the optimizer's update ``count`` (an int) and its
    per-leaf slots, keyed by param path, in the port's layout;
  * ``step``: an int.

Files load with ``weights_only=True``, which refuses numpy arrays: every
array is saved as a tensor. Retention keeps the newest ``keep_max`` steps
(TrainConfig.keep_checkpoint_max, reference train/trainer.py:221-226).
Best-model promotion mirrors core/training_utils.py:233-308: a
``saved_info.txt`` with ``step<TAB>metric`` in the saved-ckpts dir, the
winning checkpoint copied beside it.
"""

from __future__ import annotations

import os
import shutil

import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.train.optimizers import flatten_params

STATE_FILE = "state.pt"


def _ckpt_root(model_dir):
    return os.path.join(os.path.abspath(model_dir), "ckpt")


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _jax_layout_tensors(tree):
    return _map(torch.from_numpy, params_lib.to_jax_numpy(tree))


def _to_saved(state):
    saved = {
        "params": _jax_layout_tensors(state["params"]),
        "opt_state": {
            "count": int(state["opt_state"]["count"]),
            "slots": {path: {k: v.detach().cpu() for k, v in slots.items()}
                      for path, slots in state["opt_state"]["slots"].items()},
        },
        "step": int(state["step"]),
    }
    if "ema" in state:
        saved["ema"] = _jax_layout_tensors(state["ema"])
    return saved


def _to_live(saved, state_like):
    """A saved dict as a live state on `state_like`'s device, each param
    leaf's requires_grad taken from `state_like`'s."""
    like = flatten_params(state_like["params"])
    device = like[0][1].device
    params = params_lib.from_jax_numpy(saved["params"], device)
    for (_, new), (_, old) in zip(flatten_params(params), like):
        new.requires_grad_(old.requires_grad)
    state = {
        "params": params,
        "opt_state": {
            "count": int(saved["opt_state"]["count"]),
            "slots": {path: {k: v.to(device) for k, v in slots.items()}
                      for path, slots in saved["opt_state"]["slots"].items()},
        },
        "step": int(saved["step"]),
    }
    if "ema" in saved:
        state["ema"] = params_lib.from_jax_numpy(saved["ema"], device)
    return state


def _steps(root):
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(root, d, STATE_FILE)))


class CheckpointManager:
    def __init__(self, model_dir, keep_max=5):
        self._root = _ckpt_root(model_dir)
        self._keep_max = keep_max
        os.makedirs(self._root, exist_ok=True)

    def save(self, step, state):
        """Writes `state` (live tensors on any device) as step `step`; a
        step already saved is kept as it is. Returns whether it wrote."""
        step = int(step)
        if step in self.all_steps():
            return False
        final = self.checkpoint_path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_saved(state), os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
        if self._keep_max and self._keep_max > 0:
            for old in self.all_steps()[:-self._keep_max]:
                shutil.rmtree(self.checkpoint_path(old), ignore_errors=True)
        return True

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like=None, step=None):
        """Restores a checkpoint (the newest by default), or returns None
        when there is none. With `state_like` (a live state), returns a
        live state on its device; without, the saved dict as it is."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        saved = _load(os.path.join(self.checkpoint_path(step), STATE_FILE))
        if state_like is None:
            return saved
        return _to_live(saved, state_like)

    def checkpoint_path(self, step):
        return os.path.join(self._root, str(step))

    def all_steps(self):
        return _steps(self._root)

    def close(self):
        pass


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params(path, params):
    """Standalone params save: one file holding the JAX-layout tree."""
    torch.save(_jax_layout_tensors(params), os.path.abspath(path))


def restore_params(path):
    """Restores a JAX-layout params tree of numpy arrays from any of the
    three layouts a user can point a warm-start flag at:

      * a `save_params` file,
      * a trainer checkpoint step dir ``<model_dir>/ckpt/<step>``,
      * a model_dir itself (the newest step is used).

    Train-state files return their 'params' subtree; give the result to
    ``params.from_jax_numpy``.
    """
    path = os.path.abspath(path)
    candidates = [path, os.path.join(path, STATE_FILE)]
    step, step_path = latest_checkpoint(path)
    if step is not None:
        candidates.append(os.path.join(step_path, STATE_FILE))
    for candidate in candidates:
        if os.path.isfile(candidate):
            out = _load(candidate)
            if "params" in out and "step" in out:
                out = out["params"]
            return _map(lambda t: t.numpy(), out)
    raise FileNotFoundError(
        "no restorable checkpoint at %s (tried %s)" % (path, candidates))


def latest_checkpoint(model_dir):
    """Returns (step, path) of the newest checkpoint, or (None, None)."""
    steps = list_checkpoints(model_dir)
    return steps[-1] if steps else (None, None)


def list_checkpoints(model_dir):
    """All retained checkpoints as ascending [(step, path), ...]."""
    root = _ckpt_root(model_dir)
    return [(s, os.path.join(root, str(s))) for s in _steps(root)]


SAVED_INFO = "saved_info.txt"


def save_model_if_it_is_better(
    global_step, model_metric, model_path, saved_ckpts_dir, reverse=False
):
    """Promotes `model_path` into `saved_ckpts_dir` when the metric improves.

    Returns (step_best, metric_best). Matches the reference bookkeeping
    format so tooling reading saved_info.txt keeps working.
    """
    os.makedirs(saved_ckpts_dir, exist_ok=True)
    info_path = os.path.join(saved_ckpts_dir, SAVED_INFO)

    step_best, metric_best = None, None
    if os.path.exists(info_path):
        with open(info_path, "r") as fp:
            step_best, metric_best = fp.readline().strip().split("\t")
        step_best, metric_best = int(step_best), float(metric_best)

    better = (
        metric_best is None
        or (model_metric > metric_best if not reverse
            else model_metric < metric_best)
    )
    if better:
        step_best, metric_best = int(global_step), float(model_metric)
        with open(info_path, "w") as fp:
            fp.write("%d\t%.8f" % (step_best, metric_best))
        for existing in os.listdir(saved_ckpts_dir):
            if existing.startswith("model.ckpt"):
                full = os.path.join(saved_ckpts_dir, existing)
                shutil.rmtree(full, ignore_errors=True)
        dest = os.path.join(saved_ckpts_dir, "model.ckpt-%d" % step_best)
        shutil.copytree(model_path, dest)
    return step_best, metric_best


def get_best_model_checkpoint(saved_ckpts_dir):
    info_path = os.path.join(saved_ckpts_dir, SAVED_INFO)
    with open(info_path, "r") as fp:
        step_best, _ = fp.readline().strip().split("\t")
    path = os.path.join(saved_ckpts_dir, "model.ckpt-%s" % step_best)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path
