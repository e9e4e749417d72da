"""The fused flat optimizer (``train/optimizers.FusedOptimizer`` over
``kernels/fused_optimizer.py``), the default of ``build_optimizer`` as in
JAX, on the CPU, where the kernel's plain version runs:

* against JAX's ``build_optimizer(..., fused=True)`` for the seven kinds
  of ``test_torch_train.py``: staircase decay, per-leaf clipping, a
  multiplier of 3 on one scope with a freeze inside it, a BatchNorm
  moving statistic; 3 updates to rtol 1e-5 / atol 1e-6, frozen leaves
  bit-equal;
* against the port's per-leaf chain (``fused=False``) bit for bit, with
  and without clipping, over 4 updates, one gradient channels-last as
  cuDNN returns a 3x3 convolution's weight gradient;
* the state's slots are views of one flat buffer per name; a state whose
  slots are not (a restored one) is packed once;
* checkpoints: 2 fused updates, save, restore, 2 more equal 4 straight
  updates bit for bit; a checkpoint of the per-leaf chain restores into
  the fused optimizer;
* ``make_train_step`` at a tiny Cap2Det: the same losses and params with
  either optimizer, bit for bit;
* the wrapper: its chunk table, the source's parameter structs against
  the host's records, the launch count on the CPU, the errors it raises
  on tensors the kernel does not take, ``update_bytes``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.train import optimizers as jax_optimizers
from cap2det_tpu_torch import kernels
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.kernels import fused_optimizer
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
KINDS = list(_OPTIMIZERS)
SUBSTRINGS = ("/BatchNorm/moving_",)


def _config_text(kind, clip=True):
    return ("""train_config {
      learning_rate: 0.01 optimizer { %s }
      gradient_multiplier { scope: 'net/a' multiplier: 3.0 }
      gradient_multiplier { scope: 'net/a/frozen' multiplier: 0.0 }
      learning_rate_decay { decay_steps: 2 decay_rate: 0.5 staircase: true }
      %s }""" % (_OPTIMIZERS[kind], "max_gradient_norm: 2.0" if clip else ""))


def _tree(rng):
    """A JAX-layout tree: a scaled scope with a frozen leaf inside, a 3x3
    convolution, a BatchNorm moving statistic and a larger 3x3 kernel (its
    norm is clipped, the betas' are not)."""
    return {"net": {
        "a": {"weights": rng.normal(size=(4, 3)).astype(np.float32),
              "frozen": {"weights": rng.normal(size=(3,)).astype(
                  np.float32)}},
        "b": {"weights": rng.normal(size=(2, 2, 3, 5)).astype(np.float32),
              "BatchNorm": {"moving_mean": np.zeros(5, np.float32),
                            "beta": rng.normal(size=5).astype(np.float32)}},
        "c": {"weights": rng.normal(size=(3, 3, 16, 8)).astype(np.float32)},
    }}


def _grads(rng, tree, steps):
    return [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32) * 0.7, tree) for _ in range(steps)]


def _port_grads(g, channels_last=False):
    """The port's {path: gradient}; with `channels_last`, every 4-D one in
    that memory format."""
    out = dict(optimizers.flatten_params(params_lib.from_jax_numpy(g, "cpu")))
    if channels_last:
        out = {k: v.contiguous(memory_format=torch.channels_last)
               if v.dim() == 4 else v for k, v in out.items()}
    return out


def _build(text, params, fused=None):
    return optimizers.build_optimizer(
        schema.loads_pipeline(text).train_config, params,
        non_trainable_substrings=SUBSTRINGS, fused=fused)


def _run(opt, params, grads, state=None):
    state = opt.init(params) if state is None else state
    for g in grads:
        state = opt.apply(params, g, state)
    return state


def _assert_states_equal(params_a, state_a, params_b, state_b):
    for (path, a), (_, b) in zip(optimizers.flatten_params(params_a),
                                 optimizers.flatten_params(params_b)):
        assert torch.equal(a, b), path
    assert state_a["count"] == state_b["count"]
    assert set(state_a["slots"]) == set(state_b["slots"])
    for path, slots in state_a["slots"].items():
        assert set(slots) == set(state_b["slots"][path])
        for name, value in slots.items():
            assert torch.equal(value, state_b["slots"][path][name]), (
                path, name)


def test_build_optimizer_is_fused_unless_asked_not_to_be():
    params = params_lib.from_jax_numpy(_tree(np.random.default_rng(0)),
                                       "cpu")
    text = _config_text("adagrad")
    assert type(_build(text, params)[0]) is optimizers.FusedOptimizer
    assert type(_build(text, params, True)[0]) is optimizers.FusedOptimizer
    assert type(_build(text, params, False)[0]) is optimizers.Optimizer
    fused, mask, _ = _build(text, params)
    assert fused.leaf_set.paths == [
        p for p, trainable in optimizers.flatten_params(mask) if trainable]
    assert fused.leaf_set.multipliers == [3.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_jax_fused(kind):
    """Three updates against JAX's fused flat transform."""
    text = _config_text(kind)
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    grads = _grads(rng, tree, 3)

    jax_tc = jax_schema.loads_pipeline(text).train_config
    jax_params = jax.tree.map(jnp.asarray, tree)
    tx, jax_mask, _ = jax_optimizers.build_optimizer(
        jax_tc, jax_params, non_trainable_substrings=SUBSTRINGS, fused=True)
    opt_state = tx.init(jax_params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jax_params)
        jax_params = jax.tree.map(lambda p, u: p + u, jax_params, updates)

    params = params_lib.from_jax_numpy(tree, "cpu")
    opt, mask, _ = _build(text, params)
    assert isinstance(opt, optimizers.FusedOptimizer)
    assert mask == jax.tree.map(bool, jax_mask)
    state = _run(opt, params, [_port_grads(g) for g in grads])
    assert state["count"] == 3

    got = dict(optimizers.flatten_params(params_lib.to_jax_numpy(params)))
    want = dict(zip(jax_optimizers.param_path_strings(jax_params),
                    jax.tree_util.tree_leaves(jax_params)))
    initial = dict(optimizers.flatten_params(tree))
    for key, trainable in optimizers.flatten_params(mask):
        if trainable:
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
            assert not np.array_equal(got[key], initial[key]), key
        else:
            np.testing.assert_array_equal(got[key], initial[key],
                                          err_msg=key)


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_equals_the_per_leaf_chain(kind, clip):
    """Four updates, params and slots bit for bit; the 4-D gradients
    channels-last."""
    text = _config_text(kind, clip)
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    grads = [_port_grads(g, channels_last=True)
             for g in _grads(rng, tree, 4)]
    runs = []
    for fused in (True, False):
        params = params_lib.from_jax_numpy(tree, "cpu")
        opt, _, _ = _build(text, params, fused)
        runs.append((params, _run(opt, params, grads)))
    _assert_states_equal(*runs[0], *runs[1])
    assert runs[0][1]["count"] == 4


def test_slots_are_views_of_the_flat_buffers():
    text = _config_text("rmsprop_centered_momentum")
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    params = params_lib.from_jax_numpy(tree, "cpu")
    opt, _, _ = _build(text, params)
    leaf_set = opt.leaf_set
    state = opt.init(params)
    names = ("nu", "mu", "trace")
    assert opt.rule.slot_names() == names

    def check(slots):
        bases = {}
        for name in names:
            base = slots[leaf_set.paths[0]][name]._base
            assert base.shape == (leaf_set.total,)
            assert base.dtype == torch.float32 and base.is_contiguous()
            for path, shape, off in zip(leaf_set.paths, leaf_set.shapes,
                                        leaf_set.offsets):
                view = slots[path][name]
                assert view._base is base and view.storage_offset() == off
                assert tuple(view.shape) == shape and view.is_contiguous()
            bases[name] = base
        assert len({b.data_ptr() for b in bases.values()}) == len(names)
        return bases

    bases = check(state["slots"])
    new = opt.apply(params, _port_grads(_grads(rng, tree, 1)[0]), state)
    # Updated in place: the same view objects, written.
    assert new["slots"] is state["slots"] and check(new["slots"]) == bases
    assert float(bases["nu"].abs().sum()) > 0

    # Slots that are no views of it (a restored state) are packed once.
    cloned = {path: {k: v.clone() for k, v in slots.items()}
              for path, slots in new["slots"].items()}
    packed = opt.apply(params, _port_grads(_grads(rng, tree, 1)[0]),
                       {"count": new["count"], "slots": cloned})
    check(packed["slots"])
    assert packed["slots"] is not cloned
    for path in leaf_set.paths:  # the clones were read, not written
        for name in names:
            assert not torch.equal(cloned[path][name],
                                   packed["slots"][path][name])


def _ckpt_state(params, state, step):
    return {"params": params, "opt_state": state, "step": step}


@pytest.mark.parametrize("first_fused", [True, False],
                         ids=["fused", "per_leaf"])
def test_checkpoint_resume_is_bit_exact(tmp_path, first_fused):
    """2 updates (fused, or by the per-leaf chain), a checkpoint, a
    restore, 2 fused updates: equal to 4 straight fused updates."""
    text = _config_text("adam")
    rng = np.random.default_rng(11)
    tree = _tree(rng)
    grads = [_port_grads(g, channels_last=True)
             for g in _grads(rng, tree, 4)]

    straight = params_lib.from_jax_numpy(tree, "cpu")
    opt, _, _ = _build(text, straight)
    want = _run(opt, straight, grads)

    params = params_lib.from_jax_numpy(tree, "cpu")
    first, _, _ = _build(text, params, first_fused)
    state = _run(first, params, grads[:2])
    manager = ckpt_lib.CheckpointManager(str(tmp_path), keep_max=2)
    assert manager.save(2, _ckpt_state(params, state, 2))
    restored = manager.restore(_ckpt_state(params, state, 2))
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 2
    resumed_opt, _, _ = _build(text, restored["params"])
    got = _run(resumed_opt, restored["params"], grads[2:],
               restored["opt_state"])
    _assert_states_equal(straight, want, restored["params"], got)


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
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
train_config {
  learning_rate: 0.01 optimizer { adagrad { } }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 2.0 }
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0
  }
  max_gradient_norm: 0.5
}
"""


def _host_batch():
    rng = np.random.default_rng(3)
    y0 = rng.uniform(0, 0.6, (2, 8))
    x0 = rng.uniform(0, 0.6, (2, 8))
    proposals = np.stack([y0, x0, y0 + rng.uniform(0.1, 0.4, (2, 8)),
                          x0 + rng.uniform(0.1, 0.4, (2, 8))],
                         -1).astype(np.float32)
    proposals[1, 5:] = 0.0
    return {
        InputFields.image: rng.integers(0, 256, (2, 64, 64, 3)).astype(
            np.uint8),
        InputFields.proposals: proposals,
        InputFields.num_proposals: np.array([8, 5], np.int32),
        InputFields.pseudo_labels: np.array([[1, 0, 1], [0, 1, 0]],
                                            np.float32),
    }


def test_train_step_gives_the_per_leaf_chains_bits(tmp_path):
    """Three ``make_train_step`` steps of a tiny Cap2Det (Mixed_4e and the
    second stage trainable, a multiplier of 2, clipping) with each
    optimizer: the same losses and params, bit for bit."""
    label_file = synthetic.write_label_file(str(tmp_path / "labels.txt"),
                                            ["person", "dog", "car"])
    cfg = schema.loads_pipeline(_MODEL % label_file)
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.float32, device="cpu")
    tree = model.init_jax_numpy(0)
    batch = model.device_batch(_host_batch())
    runs = []
    for fused in (True, False):
        params = params_lib.from_jax_numpy(tree, "cpu")
        opt, mask, _ = optimizers.build_optimizer(
            cfg.train_config, params, model.non_trainable_paths,
            model.non_trainable_substrings, fused=fused)
        assert isinstance(opt, optimizers.FusedOptimizer) == fused
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        step = trainer.make_train_step(model, opt, cfg.train_config, mask)
        losses = []
        for _ in range(3):
            state, logs = step(state, batch, 0)
            losses.append(float(logs["loss/total_loss"]))
        runs.append((losses, state))
    assert runs[0][0] == runs[1][0]
    _assert_states_equal(runs[0][1]["params"], runs[0][1]["opt_state"],
                         runs[1][1]["params"], runs[1][1]["opt_state"])
    assert len(runs[0][1]["opt_state"]["slots"]) > 40


def test_chunk_table_covers_every_leaf_once(monkeypatch):
    monkeypatch.setattr(fused_optimizer, "CHUNK", 10)
    monkeypatch.setattr(fused_optimizer, "MAX_LEAVES", 3)
    numels = [25, 0, 10, 3, 31, 1, 20]
    leaf_set = fused_optimizer.LeafSet(
        ["l%d" % i for i in range(7)], [(n,) for n in numels],
        [1.0] * 7)
    assert leaf_set.offsets == [0, 25, 25, 35, 38, 69, 70]
    assert leaf_set.total == 90
    assert [(lo, n) for lo, n, _, _ in leaf_set.groups] == [
        (0, 3), (3, 3), (6, 1)]
    for lo, n, table, spans in leaf_set.groups:
        for local in range(n):
            first, count = spans[local]
            rows = table[first:first + count]
            assert (rows[:, 0] == local).all() and (rows[:, 3] == 0).all()
            # Consecutive chunks of at most CHUNK that tile the leaf.
            assert rows[:, 1].tolist() == list(range(0, numels[lo + local],
                                                     10))
            assert (rows[:, 2] <= 10).all()
            assert rows[:, 2].sum() == numels[lo + local]
        assert sum(c for _, c in spans) == len(table)


def _struct_fields(source, name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    return re.findall(r"^\s+[\w\s\*]+?[\s\*](\w+)(?:\[\w+\])?;", body, re.M)


def test_host_records_mirror_the_kernels_structs():
    """The numpy records the wrapper fills name the source's struct
    fields in order (the C entry reports the offsets on the card)."""
    with open(os.path.join(ROOT, "cap2det_tpu_torch", "csrc",
                           "fused_optimizer.cu")) as f:
        source = f.read()
    assert _struct_fields(source, "Leaf") == list(
        fused_optimizer.LEAF_DTYPE.names)
    assert _struct_fields(source, "Args") == list(
        fused_optimizer.ARGS_DTYPE.names)
    assert "constexpr int kMaxLeaves = %d;" % fused_optimizer.MAX_LEAVES in (
        source)
    assert fused_optimizer.LEAF_DTYPE.itemsize == 48
    assert fused_optimizer.ARGS_DTYPE.itemsize == 3160 < 4096


def test_the_cpu_runs_the_plain_version_and_launches_nothing():
    before = kernels.launch_counts()["fused_optimizer"]
    test_fused_equals_the_per_leaf_chain("adagrad", True)
    assert kernels.launch_counts()["fused_optimizer"] == before == (
        fused_optimizer.launches)


def _meta_case():
    rule = optimizers.build_base_optimizer(schema.loads_pipeline(
        _config_text("adagrad")).train_config.optimizer)
    leaf_set = fused_optimizer.LeafSet(["w", "b"], [(8, 4, 3, 3), (8,)],
                                       [1.0, 1.0])
    params = [torch.empty(8, 4, 3, 3, device="meta"),
              torch.empty(8, device="meta")]
    grads = [torch.empty(8, 4, 3, 3, device="meta"),
             torch.empty(8, device="meta")]
    slots = {"sum_of_squares": torch.empty(leaf_set.total, device="meta")}
    return rule, leaf_set, params, grads, slots


@pytest.mark.parametrize("case", [
    "mixed_devices", "float64_param", "strided_param", "bfloat16_grad",
    "permuted_grad", "short_slot"])
def test_a_tensor_the_kernel_does_not_take_raises(case):
    """Off the CPU there is no plain path: what the kernel does not take
    raises before any launch."""
    rule, leaf_set, params, grads, slots = _meta_case()
    if case == "mixed_devices":
        grads[1] = torch.empty(8)
    elif case == "float64_param":
        params[1] = torch.empty(8, dtype=torch.float64, device="meta")
    elif case == "strided_param":
        params[0] = torch.empty(8, 3, 3, 4, device="meta").permute(0, 3, 1, 2)
    elif case == "bfloat16_grad":
        grads[1] = torch.empty(8, dtype=torch.bfloat16, device="meta")
    elif case == "permuted_grad":
        grads[0] = torch.empty(4, 8, 3, 3, device="meta").transpose(0, 1)
    else:
        slots["sum_of_squares"] = torch.empty(leaf_set.total - 1,
                                              device="meta")
    with pytest.raises((ValueError, TypeError)):
        fused_optimizer.fused_update(rule, leaf_set, params, grads, slots,
                                     0.01, 0)
    assert fused_optimizer.launches == 0


def test_channels_last_gradients_reach_the_launch(monkeypatch):
    """A channels-last gradient is taken (flags and dims for the gather);
    then the launch builds the library, which raises here: no nvcc."""
    rule, leaf_set, params, grads, slots = _meta_case()
    grads[0] = grads[0].contiguous(memory_format=torch.channels_last)
    assert fused_optimizer._grad_flags("w", grads[0], (8, 4, 3, 3)) == (
        fused_optimizer.GRAD_CHANNELS_LAST, 4, 9)
    assert fused_optimizer._grad_flags("b", grads[1], (8,)) == (0, 0, 0)
    monkeypatch.setattr(fused_optimizer.build, "_lib", None)
    monkeypatch.setattr(fused_optimizer.build, "library", lambda: (
        _ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_optimizer.fused_update(rule, leaf_set, params, grads, slots,
                                     0.01, 0)
    assert fused_optimizer.launches == 0


def test_update_bytes():
    # Adagrad at the coco17 trainable set: g, the sum of squares and the
    # param, 20 bytes a parameter.
    assert fused_optimizer.update_bytes(1, 7417427) == 148348540
    assert fused_optimizer.update_bytes(0, 10) == 120
    assert fused_optimizer.update_bytes(3, 10, grad_bytes=2) == 340
