"""Optimizer construction from config (port of
``cap2det_tpu/train/optimizers.py``).

The JAX package builds an optax chain; the port writes optax's formulas
as plain tensor arithmetic on the trainable leaves, updated in place:

  * the five Optimizer oneofs, with optax's numerics (adagrad:
    rsqrt(sum g^2 + 1e-7) with the accumulator starting at
    initial_accumulator_value; rmsprop: eps inside the square root;
    adam: bias correction with count+1; sgd/momentum/nesterov as
    ``optax.sgd``), not ``torch.optim``'s;
  * exponential learning-rate decay with optional staircase, read at the
    update count, which starts at 0;
  * per-scope gradient multipliers, a later config entry winning, where
    multiplier 0.0 freezes the subtree;
  * per-leaf gradient-norm clipping;
  * parameter moving averages.

Per leaf the order is the JAX package's: multiplier, clip, then the rule.
"""

from __future__ import annotations

import math

import torch

from cap2det_tpu_torch.config import schema


def flatten_params(params, prefix=""):
    """[(path, leaf)] of a nested dict, keys sorted at every level (the
    order of ``jax.tree_util`` over dicts), paths '/'-joined."""
    out = []
    for key in sorted(params):
        value = params[key]
        path = prefix + str(key)
        if isinstance(value, dict):
            out.extend(flatten_params(value, path + "/"))
        else:
            out.append((path, value))
    return out


def param_path_strings(params):
    """'/'-joined path strings of the leaves, in ``flatten_params`` order."""
    return [path for path, _ in flatten_params(params)]


def unflatten(paths_values):
    """Nested dict from [(path, value)]."""
    out = {}
    for path, value in paths_values:
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def resolve_multiplier(path, multipliers):
    """The effective multiplier for a param path (later config entries
    override earlier ones), or None."""
    value = None
    for m in multipliers:
        if path.startswith(m.scope):
            value = m.multiplier
    return value


def build_learning_rate_schedule(train_config: schema.TrainConfig):
    """count -> learning rate (optax.exponential_decay / constant)."""
    lr = train_config.learning_rate
    if not train_config.has_field("learning_rate_decay"):
        return lambda count: lr
    decay = train_config.learning_rate_decay
    steps, rate, staircase = (decay.decay_steps, decay.decay_rate,
                              decay.staircase)
    if steps <= 0:
        return lambda count: lr

    def schedule(count):
        if count <= 0:
            return lr
        p = count / steps
        return lr * rate ** (math.floor(p) if staircase else p)

    return schedule


class BaseRule:
    """One optimizer kind: per-leaf ``init`` slots and ``update`` of a
    float32 gradient into the step to add, given the learning rate and
    the update count (0 on the first update)."""

    def __init__(self, which, config):
        self.which = which or "sgd"
        self.config = config

    def init(self, leaf):
        c, z = self.config, torch.zeros_like(leaf, dtype=torch.float32)
        if self.which == "adagrad":
            return {"sum_of_squares": torch.full_like(
                z, c.initial_accumulator_value)}
        if self.which == "adam":
            return {"mu": z, "nu": z.clone()}
        if self.which == "rmsprop":
            slots = {"nu": z}
            if c.centered:
                slots["mu"] = z.clone()
            if c.momentum > 0:
                slots["trace"] = z.clone()
            return slots
        if self.which == "momentum":
            return {"trace": z}
        return {}

    def update(self, g, slots, lr, count):
        c = self.config
        if self.which == "adagrad":
            sos = g * g + slots["sum_of_squares"]
            slots["sum_of_squares"] = sos
            scale = torch.where(sos > 0, torch.rsqrt(sos + 1e-7),
                                torch.zeros_like(sos))
            return (scale * g) * -lr
        if self.which == "adam":
            mu = (1 - c.beta1) * g + c.beta1 * slots["mu"]
            nu = (1 - c.beta2) * (g * g) + c.beta2 * slots["nu"]
            slots["mu"], slots["nu"] = mu, nu
            mu_hat = mu / (1 - c.beta1 ** (count + 1))
            nu_hat = nu / (1 - c.beta2 ** (count + 1))
            return (mu_hat / (torch.sqrt(nu_hat) + c.epsilon)) * -lr
        if self.which == "rmsprop":
            nu = (1 - c.decay) * (g * g) + c.decay * slots["nu"]
            slots["nu"] = nu
            if c.centered:
                mu = (1 - c.decay) * g + c.decay * slots["mu"]
                slots["mu"] = mu
                u = g * torch.rsqrt(nu - mu * mu + c.epsilon)
            else:
                u = g * torch.rsqrt(nu + c.epsilon)
            u = u * -lr
            if c.momentum > 0:
                u = u + c.momentum * slots["trace"]
                slots["trace"] = u
            return u
        if self.which == "momentum":
            trace = g + c.momentum * slots["trace"]
            slots["trace"] = trace
            u = g + c.momentum * trace if c.use_nesterov else trace
            return u * -lr
        if self.which == "sgd":
            return g * -lr
        raise ValueError("unknown optimizer %r" % self.which)


def build_base_optimizer(config: schema.Optimizer):
    which = config.which_oneof() if config is not None else None
    if which not in (None, "sgd", "adagrad", "adam", "rmsprop", "momentum"):
        raise ValueError("unknown optimizer %r" % which)
    return BaseRule(which, getattr(config, which) if which else None)


class Optimizer:
    """The whole chain over the trainable leaves: multiplier, per-leaf
    clip, rule, learning rate; ``apply`` updates the params in place."""

    def __init__(self, rule, schedule, multipliers, clip_norm):
        self.rule = rule
        self.schedule = schedule
        self.multipliers = multipliers  # trainable path -> multiplier
        self.clip_norm = clip_norm

    def init(self, params):
        return {
            "count": 0,
            "slots": {path: self.rule.init(leaf)
                      for path, leaf in flatten_params(params)
                      if path in self.multipliers},
        }

    @torch.no_grad()
    def apply(self, params, grads, state):
        """params += update(grads), in place; `grads` maps each trainable
        path to its gradient. Returns the new state (the slots are
        updated in place)."""
        lr = self.schedule(state["count"])
        for path, leaf in flatten_params(params):
            mult = self.multipliers.get(path)
            if mult is None:
                continue
            g = grads[path].float()
            if mult != 1.0:
                g = g * mult
            if self.clip_norm is not None:
                norm = torch.sqrt(torch.sum(torch.square(g)))
                g = g * torch.clamp(
                    self.clip_norm / torch.clamp_min(norm, 1e-12), max=1.0)
            u = self.rule.update(g, state["slots"][path], lr, state["count"])
            leaf.add_(u.to(leaf.dtype))
        return {"count": state["count"] + 1, "slots": state["slots"]}


def build_optimizer(train_config: schema.TrainConfig, params,
                    non_trainable_paths=(), non_trainable_substrings=()):
    """Builds (optimizer, trainable_mask, schedule) for a params tree.

    trainable_mask is a nested dict of bools shaped like params: a leaf is
    frozen when a gradient multiplier of 0.0 resolves for its path or the
    model marks it non-trainable, by path prefix or substring.
    """
    schedule = build_learning_rate_schedule(train_config)
    rule = build_base_optimizer(train_config.optimizer)
    multipliers = {}
    mask = []
    for path, _ in flatten_params(params):
        mult = resolve_multiplier(path, train_config.gradient_multiplier)
        frozen = (any(path.startswith(p) for p in non_trainable_paths)
                  or any(s in path for s in non_trainable_substrings)
                  or mult == 0.0)
        if not frozen:
            multipliers[path] = 1.0 if mult is None else float(mult)
        mask.append((path, not frozen))
    clip_norm = None
    if (train_config.has_field("max_gradient_norm")
            and train_config.max_gradient_norm > 0):
        clip_norm = train_config.max_gradient_norm
    return (Optimizer(rule, schedule, multipliers, clip_norm),
            unflatten(mask), schedule)


def ema_init(params):
    """A detached copy of every leaf (never aliasing the params), nested as
    the params are, leafless blocks (a pool branch's {}) included, as
    ``jax.tree.map`` keeps them: the average is a params tree the model
    can run."""
    return {k: ema_init(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in params.items()}


@torch.no_grad()
def ema_update(ema, params, decay):
    """ema = decay * ema + (1 - decay) * params, in place."""
    flat = dict(flatten_params(params))
    for path, e in flatten_params(ema):
        e.copy_(decay * e + (1.0 - decay) * flat[path])
    return ema
