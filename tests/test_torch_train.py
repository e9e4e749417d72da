"""The port's training step against the JAX package at float32.

Same weights on both sides (a seeded numpy tree, given to JAX as arrays
and to the port through ``params.from_jax_numpy``), the tiny model of
``tests/test_torch_cap2det.py`` (64x64 canvases, P=8, 6x6 crops, 3
classes, 2 OICR iterations), L2 1e-6 on the heads, dropout off
(``dropout_keep_prob: 1.0``). JAX runs on the CPU through its XLA paths;
the port's CPU path runs the plain versions of K1, K2, K4, K5 and K6.
With the second stage recomputed in the backward (the port's
``second_stage_remat=True``, JAX's CAP2DET_SECOND_STAGE_REMAT=1), the
steps agree with JAX's as well, and the port's bits do not move.

The reference's CPU gradients split tied maxima where the port routes
first-tie, but every tie that reaches a pool here is a tie of post-ReLU
zeros, whose gradient the ReLU stops on both sides: the parameter
gradients agree. So this file compares losses and parameter gradients,
never a pool's dx.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import synthetic
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.train import optimizers as jax_optimizers
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.models import frcnn, registry
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
# float32 through ~20 conv layers forward and backward, summed in other
# orders by XLA and PyTorch's CPU kernels (measured ~1e-5 relative).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3  # plus an atol of 1e-4 of the leaf's largest gradient

_MODEL = """
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6 maxpool_kernel_size: 2 maxpool_stride: 2
      dropout_keep_prob: 1.0
    }
    fc_hyperparams {
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 2
    oicr_iou_threshold: 0.5
    oicr_use_proba_r_given_c: %s
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 4 max_total_size: 8
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 4 max_total_size: 8
    }
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
"""

_FREEZE = """
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 1.0 }
"""
_MIXED_4E = _FREEZE + """
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0
  }
"""
TRAIN = {"mixed4e_unfrozen": _MIXED_4E, "full_freeze": _FREEZE}


def _train_config(multipliers, optimizer="adagrad {}", extra=""):
    return ("train_config { learning_rate: 0.01 optimizer { %s } %s %s }"
            % (optimizer, multipliers, extra))


@pytest.fixture(scope="module")
def label_file(tmp_path_factory):
    return synthetic.write_label_file(
        str(tmp_path_factory.mktemp("labels") / "labels.txt"), CLASSES)


_MODELS = {}


def _models(label_file, proba_r_given_c=True, train=_MIXED_4E, remat=False):
    """(jax model, port model, jax train_config, port train_config, numpy
    tree), cached per configuration for the module; `remat` builds the
    port model with ``second_stage_remat``."""
    key = (label_file, proba_r_given_c, train, remat)
    if key not in _MODELS:
        text = (_MODEL % (str(proba_r_given_c).lower(), label_file)
                + _train_config(train))
        jax_cfg, cfg = (jax_schema.loads_pipeline(text),
                        schema.loads_pipeline(text))
        jax_model = jax_registry.build(jax_cfg.model, is_training=True,
                                       compute_dtype=jnp.float32,
                                       use_pallas=False)
        model = registry.build(cfg.model, is_training=True,
                               compute_dtype=torch.float32, device="cpu",
                               second_stage_remat=remat)
        _MODELS[key] = (jax_model, model, jax_cfg.train_config,
                        cfg.train_config, model.init_jax_numpy(0))
    return _MODELS[key]


def _host_batch():
    rng = np.random.default_rng(3)
    y0 = rng.uniform(0, 0.6, (2, 8))
    x0 = rng.uniform(0, 0.6, (2, 8))
    proposals = np.stack([y0, x0, y0 + rng.uniform(0.1, 0.4, (2, 8)),
                          x0 + rng.uniform(0.1, 0.4, (2, 8))],
                         -1).astype(np.float32)
    proposals[1, 5:] = 0.0  # padding slots
    return {
        InputFields.image: rng.integers(0, 256, (2, 64, 64, 3)).astype(
            np.uint8),
        InputFields.proposals: proposals,
        InputFields.num_proposals: np.array([8, 5], np.int32),
        InputFields.pseudo_labels: np.array([[1, 0, 1], [0, 1, 0]],
                                            np.float32),
    }


def _jax_batch(host):
    return {"image": jnp.asarray(host[InputFields.image]),
            "proposals": jnp.asarray(host[InputFields.proposals]),
            "num_proposals": jnp.asarray(host[InputFields.num_proposals]),
            "labels": jnp.asarray(host[InputFields.pseudo_labels])}


def _jax_mask(jax_model, jax_train_config, jax_params):
    _, mask, _ = jax_optimizers.build_optimizer(
        jax_train_config, jax_params,
        non_trainable_paths=jax_model.non_trainable_paths,
        non_trainable_substrings=jax_model.non_trainable_substrings)
    return mask


@pytest.mark.parametrize("proba_r_given_c", [True, False],
                         ids=["proba_r_given_c", "proposal_scores"])
def test_loss_matches_jax(label_file, proba_r_given_c):
    jax_model, model, _, _, tree = _models(label_file, proba_r_given_c)
    host = _host_batch()
    want_total, want = jax.jit(
        lambda p, b: jax_model.loss(p, b, rng=jax.random.PRNGKey(0)))(
            jax.tree.map(jnp.asarray, tree), _jax_batch(host))
    with torch.no_grad():
        total, got = model.loss(params_lib.from_jax_numpy(tree, "cpu"),
                                model.device_batch(host))
    assert set(got) == set(want) == {
        "midn_cross_entropy_loss", "oicr_cross_entropy_loss_at_1",
        "oicr_cross_entropy_loss_at_2", "regularization_loss"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(float(total), float(want_total),
                               rtol=LOSS_RTOL)


def _port_grads(model, params, batch):
    trainable = [(path, leaf)
                 for path, leaf in optimizers.flatten_params(params)
                 if leaf.requires_grad]
    total, _ = model.loss(params, batch)
    grads = torch.autograd.grad(total, [leaf for _, leaf in trainable])
    tree = optimizers.unflatten([(path, g) for (path, _), g
                                 in zip(trainable, grads)])
    return dict(optimizers.flatten_params(params_lib.to_jax_numpy(tree)))


@pytest.mark.parametrize("train", list(TRAIN), ids=list(TRAIN))
def test_trainable_gradients_match_jax(label_file, train):
    """The trainer's masked gradient, jitted: tests/test_frozen_backward.py
    runs it eagerly to compare two JAX programs with each other; against
    the port, the jitted gradient agrees to ~1e-5 of each leaf's largest
    value, and eager dispatch would cost ~40 s of op compiles per run."""
    jax_model, model, jax_tc, tc, tree = _models(label_file,
                                                 train=TRAIN[train])
    host = _host_batch()
    jax_params = jax.tree.map(jnp.asarray, tree)
    jax_mask = _jax_mask(jax_model, jax_tc, jax_params)

    def loss_fn(p):
        p = jax.tree.map(
            lambda leaf, t: leaf if t else jax.lax.stop_gradient(leaf),
            p, jax_mask)
        return jax_model.loss(p, _jax_batch(host),
                              rng=jax.random.PRNGKey(0))[0]

    want = dict(zip(jax_optimizers.param_path_strings(jax_params),
                    jax.tree_util.tree_leaves(jax.jit(jax.grad(loss_fn))(
                        jax_params))))
    want_trainable = dict(zip(
        jax_optimizers.param_path_strings(jax_mask),
        jax.tree_util.tree_leaves(jax_mask)))

    params = params_lib.from_jax_numpy(tree, "cpu")
    _, mask, _ = optimizers.build_optimizer(
        tc, params, model.non_trainable_paths, model.non_trainable_substrings)
    trainer.set_trainable(params, mask)
    got = _port_grads(model, params, model.device_batch(host))

    assert set(got) == {k for k, t in want_trainable.items() if t}
    mixed_4e = [k for k in got if "/Mixed_4e/" in k]
    assert bool(mixed_4e) == (train == "mixed4e_unfrozen")
    assert not any("/BatchNorm/moving_" in k for k in got)
    for key, g in got.items():
        w = np.asarray(want[key])
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=1e-4 * np.abs(w).max() + 1e-8,
            err_msg=key)


_OPTIMIZERS = {
    "sgd": "sgd {}",
    "adagrad": "adagrad { initial_accumulator_value: 0.1 }",
    "adam": "adam { beta1: 0.8 beta2: 0.99 epsilon: 0.001 }",
    "rmsprop": "rmsprop { decay: 0.9 epsilon: 0.01 }",
    "rmsprop_centered_momentum": ("rmsprop { decay: 0.9 epsilon: 0.01 "
                                  "centered: true momentum: 0.5 }"),
    "momentum": "momentum { momentum: 0.9 }",
    "nesterov": "momentum { momentum: 0.9 use_nesterov: true }",
}


@pytest.mark.parametrize("kind", list(_OPTIMIZERS), ids=list(_OPTIMIZERS))
def test_optimizer_matches_optax(kind):
    """Three updates of each optimizer kind with staircase decay, per-leaf
    clipping, a multiplier of 3 on one scope and a freeze inside it."""
    text = _train_config(
        """gradient_multiplier { scope: 'net/a' multiplier: 3.0 }
           gradient_multiplier { scope: 'net/a/frozen' multiplier: 0.0 }""",
        optimizer=_OPTIMIZERS[kind],
        extra="""learning_rate_decay { decay_steps: 2 decay_rate: 0.5
                                       staircase: true }
                 max_gradient_norm: 2.0""")
    rng = np.random.default_rng(5)
    tree = {"net": {
        "a": {"weights": rng.normal(size=(4, 3)).astype(np.float32),
              "frozen": {"weights": rng.normal(size=(3,)).astype(
                  np.float32)}},
        "b": {"weights": rng.normal(size=(2, 2, 3, 5)).astype(np.float32),
              "BatchNorm": {"moving_mean": np.zeros(5, np.float32),
                            "beta": rng.normal(size=5).astype(np.float32)}},
    }}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32) * 0.7, tree) for _ in range(3)]
    substrings = ("/BatchNorm/moving_",)

    jax_tc = jax_schema.loads_pipeline(text).train_config
    jax_params = jax.tree.map(jnp.asarray, tree)
    tx, jax_mask, _ = jax_optimizers.build_optimizer(
        jax_tc, jax_params, non_trainable_substrings=substrings)
    opt_state = tx.init(jax_params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jax_params)
        jax_params = jax.tree.map(lambda p, u: p + u, jax_params, updates)

    params = params_lib.from_jax_numpy(tree, "cpu")
    opt, mask, schedule = optimizers.build_optimizer(
        schema.loads_pipeline(text).train_config, params,
        non_trainable_substrings=substrings)
    assert mask == jax.tree.map(bool, jax_mask)
    assert [schedule(c) for c in range(5)] == pytest.approx(
        [0.01, 0.01, 0.005, 0.005, 0.0025])
    state = opt.init(params)
    for g in grads:
        state = opt.apply(params, dict(optimizers.flatten_params(
            params_lib.from_jax_numpy(g, "cpu"))), state)
    assert state["count"] == 3

    got = dict(optimizers.flatten_params(params_lib.to_jax_numpy(params)))
    want = dict(zip(jax_optimizers.param_path_strings(jax_params),
                    jax.tree_util.tree_leaves(jax_params)))
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("net/a/frozen/weights", "net/b/BatchNorm/moving_mean"):
        np.testing.assert_array_equal(got[key], dict(
            optimizers.flatten_params(tree))[key])


def _jax_train_steps(jax_model, jax_tc, tree, host, steps, jaxpr=False):
    """`steps` steps of JAX's make_train_step, traced afresh, from `tree`
    on `host`: (losses, final params by path, the step's jaxpr text if
    `jaxpr`, else None)."""
    jax_params = jax.tree.map(jnp.asarray, tree)
    tx, jax_mask, _ = jax_optimizers.build_optimizer(
        jax_tc, jax_params,
        non_trainable_paths=jax_model.non_trainable_paths,
        non_trainable_substrings=jax_model.non_trainable_substrings)
    jax_state = {"params": jax_params, "opt_state": tx.init(jax_params),
                 "step": jnp.zeros((), jnp.int32)}
    step_fn = jax_trainer.make_train_step(jax_model, tx, jax_tc, jax_mask)
    args = (_jax_batch(host), jax.random.PRNGKey(0))
    text = str(jax.make_jaxpr(step_fn)(jax_state, *args)) if jaxpr else None
    jax_step = jax.jit(step_fn)
    losses = []
    for _ in range(steps):
        jax_state, logs = jax_step(jax_state, *args)
        losses.append(float(logs["loss/total_loss"]))
    params = dict(zip(jax_optimizers.param_path_strings(jax_state["params"]),
                      jax.tree_util.tree_leaves(jax_state["params"])))
    return losses, params, text


def _port_train_steps(model, tc, tree, host, steps):
    """`steps` port make_train_step steps from `tree` on `host`: (each
    step's logs, the final state, the trainable mask)."""
    params = params_lib.from_jax_numpy(tree, "cpu")
    opt, mask, _ = optimizers.build_optimizer(
        tc, params, model.non_trainable_paths, model.non_trainable_substrings)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step = trainer.make_train_step(model, opt, tc, mask)
    batch = model.device_batch(host)
    logs = []
    for _ in range(steps):
        state, step_logs = step(state, batch, 0)
        logs.append(step_logs)
    return logs, state, mask


def _assert_params_match_jax(state, mask, want, tree):
    """The trainable params agree with JAX's `want` and most of them
    moved; frozen leaves stay bitwise unchanged."""
    got = dict(optimizers.flatten_params(
        params_lib.to_jax_numpy(state["params"])))
    flat_mask = dict(optimizers.flatten_params(mask))
    initial = dict(optimizers.flatten_params(tree))
    changed = 0
    for key, value in got.items():
        if flat_mask[key]:
            # Gradients agree to ~1e-4 relative (GRAD_RTOL's measure); an
            # Adagrad step moves a param by up to lr = 0.01, so 1e-5 is
            # 0.1% of one step.
            np.testing.assert_allclose(value, np.asarray(want[key]),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
            changed += not np.array_equal(value, initial[key])
        else:
            np.testing.assert_array_equal(value, initial[key], err_msg=key)
    assert changed > 0.9 * sum(flat_mask.values())


def test_train_steps_match_jax(label_file):
    """Four make_train_step steps from the same params on the same batch:
    the loss at every step and the final trainable params agree with
    JAX's; frozen leaves stay bitwise unchanged."""
    jax_model, model, jax_tc, tc, tree = _models(label_file)
    host = _host_batch()
    want_losses, want, _ = _jax_train_steps(jax_model, jax_tc, tree, host, 4)
    logs, state, mask = _port_train_steps(model, tc, tree, host, 4)
    for step_logs in logs:
        assert set(step_logs) == {"loss/total_loss",
                                  "loss/midn_cross_entropy_loss",
                                  "loss/oicr_cross_entropy_loss_at_1",
                                  "loss/oicr_cross_entropy_loss_at_2",
                                  "loss/regularization_loss"}
    got_losses = [float(step_logs["loss/total_loss"]) for step_logs in logs]
    assert state["step"] == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]
    _assert_params_match_jax(state, mask, want, tree)


@pytest.mark.parametrize("train", list(TRAIN), ids=list(TRAIN))
def test_remat_train_steps_match_jax_remat(label_file, train, monkeypatch):
    """Two steps of a port model built with ``second_stage_remat=True``
    against JAX's step traced under CAP2DET_SECOND_STAGE_REMAT=1, at
    test_train_steps_match_jax's tolerances, for both freezes."""
    jax_model, model, jax_tc, tc, tree = _models(
        label_file, train=TRAIN[train], remat=True)
    assert model._second_stage_remat
    host = _host_batch()
    monkeypatch.setenv("CAP2DET_SECOND_STAGE_REMAT", "1")
    want_losses, want, jaxpr = _jax_train_steps(jax_model, jax_tc, tree,
                                                host, 2, jaxpr=True)
    assert "remat" in jaxpr  # the variable is read at trace time
    logs, state, mask = _port_train_steps(model, tc, tree, host, 2)
    np.testing.assert_allclose(
        [float(step_logs["loss/total_loss"]) for step_logs in logs],
        want_losses, rtol=1e-4)
    _assert_params_match_jax(state, mask, want, tree)


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
@pytest.mark.parametrize("train", list(TRAIN), ids=list(TRAIN))
def test_remat_changes_no_bit(label_file, train, chunk, monkeypatch):
    """The port with ``second_stage_remat`` against the port without it:
    the trainable gradients, two steps' losses and the updated params
    equal bit for bit, with the second stage whole and in chunks of 4
    ROIs (``extract_features(second_stage_chunk=4)``, 4 chunks)."""
    if chunk:
        monkeypatch.setattr(frcnn, "extract_features", functools.partial(
            frcnn.extract_features, second_stage_chunk=chunk))
    host = _host_batch()
    runs = []
    for remat in (False, True):
        _, model, _, tc, tree = _models(label_file, train=TRAIN[train],
                                        remat=remat)
        params = params_lib.from_jax_numpy(tree, "cpu")
        _, mask, _ = optimizers.build_optimizer(
            tc, params, model.non_trainable_paths,
            model.non_trainable_substrings)
        trainer.set_trainable(params, mask)
        grads = _port_grads(model, params, model.device_batch(host))
        logs, state, _ = _port_train_steps(model, tc, tree, host, 2)
        runs.append((grads, logs, dict(optimizers.flatten_params(
            state["params"]))))
    (plain_grads, plain_logs, plain), (grads, logs, params) = runs
    assert grads.keys() == plain_grads.keys() and len(grads) > 40
    for key, g in grads.items():
        np.testing.assert_array_equal(g, plain_grads[key], err_msg=key)
    for step_logs, plain_step_logs in zip(logs, plain_logs):
        for key, value in step_logs.items():
            assert torch.equal(value, plain_step_logs[key]), key
    for key, value in params.items():
        assert torch.equal(value, plain[key]), key


def test_train_state_create_and_ema(label_file):
    _, model, _, _, _ = _models(label_file)
    text = _train_config(_FREEZE, extra="moving_average_decay: 0.5")
    tc = schema.loads_pipeline(text).train_config
    state, opt, schedule, mask = trainer.TrainState.create(model, tc, 0)
    assert state["step"] == 0 and schedule(0) == pytest.approx(0.01)
    flat = optimizers.flatten_params(state["params"])
    flat_mask = dict(optimizers.flatten_params(mask))
    assert all(leaf.requires_grad == flat_mask[p] for p, leaf in flat)
    assert not any(flat_mask[p] for p, _ in flat
                   if p.startswith("first_stage"))
    ema = dict(optimizers.flatten_params(state["ema"]))
    for path, leaf in flat:  # a copy, not an alias
        assert torch.equal(ema[path], leaf)
        assert ema[path].data_ptr() != leaf.data_ptr()
    ema_tree = optimizers.ema_update(
        state["ema"], {k: v for k, v in state["params"].items()}, 0.5)
    assert trainer.eval_params(state) is state["ema"] is ema_tree
    # Decay 0 (every shipped config) keeps no average.
    tc0 = schema.loads_pipeline(_train_config(
        _FREEZE, extra="moving_average_decay: 0.0")).train_config
    state0 = trainer.TrainState.create(model, tc0, 0)[0]
    assert "ema" not in state0
    assert trainer.eval_params(state0) is state0["params"]


def test_step_seed_depends_on_seed_and_step_only():
    assert trainer.step_seed(0, 3) == trainer.step_seed(0, 3)
    assert len({trainer.step_seed(s, t) for s in (0, 1)
                for t in range(4)}) == 8


def test_dropout_mask_rate_and_scale():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(7)
    out = frcnn.dropout(x, 0.7, gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.7))
    again = frcnn.dropout(x, 0.7, torch.Generator().manual_seed(7))
    assert torch.equal(out, again)


def test_second_stage_chunk(label_file):
    _, model, _, _, tree = _models(label_file)
    host = _host_batch()
    prepared = model.prepare(params_lib.from_jax_numpy(tree, "cpu"))
    batch = model.device_batch(host)
    args = (prepared, batch["image"], batch["proposals"],
            model.options.frcnn_options)
    with torch.no_grad():
        whole = frcnn.extract_features(*args)
        chunked = frcnn.extract_features(*args, second_stage_chunk=4)
        bigger = frcnn.extract_features(*args, second_stage_chunk=64)
        with pytest.raises(ValueError, match="does not divide"):
            frcnn.extract_features(*args, second_stage_chunk=5)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)
    assert torch.equal(bigger, whole)


def test_device_batch_keeps_the_raw_canvas(label_file):
    _, model, _, _, _ = _models(label_file)
    host = _host_batch()
    batch = model.device_batch(host)
    assert batch["image"].dtype == torch.uint8
    assert tuple(batch["image"].shape) == (2, 64, 64, 3)
    assert batch["labels"].dtype == torch.float32
    np.testing.assert_array_equal(batch["num_proposals"].numpy(), [8, 5])
