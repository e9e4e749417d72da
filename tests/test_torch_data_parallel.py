"""Data parallelism in the port: a torch.distributed group of spawned
ranks on the CPU (gloo, localhost), against the JAX package.

* A 2-rank step of the tiny Cap2Det of ``tests/test_trainer_spmd.py`` on
  halves of one global batch equals JAX's 2-device ``shard_map`` step on
  the whole batch, and the port's one-process step, within that test's
  tolerances; an all-reduce placed after the update trips them.
* The ranks draw distinct, deterministic step seeds; a group of one keeps
  the no-group step's bits.
* ``maybe_initialize``'s settings from the launchers' variables.
* ``train()`` on 2 ranks: only rank 0 writes, and without distinct
  shard_indicator numerators each rank feeds from its own seed.
* ``entry.dryrun_multichip(2, device="cpu")``.

Spawned ranks import this module, and a rank must not import JAX: JAX is
imported inside the tests, in the parent process only. Ranks write their
results to files that the parent reads.
"""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cap2det_tpu_torch import entry
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.parallel import distributed, mesh as mesh_lib
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
WORLD = 2
TIMEOUT = 240.0  # seconds for a group's ranks to finish
# tests/test_trainer_spmd.py::test_real_model_spmd_parity's bounds.
PARAM_TOL = 1e-4
ACC_REL_TOL = 1e-3
LOSS_RTOL = 1e-5

_PIPELINE = """
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 1.0
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      op: FC
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 2
    oicr_iou_threshold: 0.6
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 10 max_total_size: 20
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 10 max_total_size: 20
    }
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
train_config {
  learning_rate: 0.001
  learning_rate_decay { decay_steps: 10 decay_rate: 0.5 staircase: true }
  optimizer { adagrad {} }
  max_steps: 10
  moving_average_decay: 0.0
}
"""


def _global_batch(n_images, num_proposals=8, hw=(64, 96), seed=0):
    """tests/test_trainer_spmd.py's global batch, uint8 canvases."""
    rs = np.random.RandomState(seed)
    h, w = hw
    y0 = rs.uniform(0, 0.5, (n_images, num_proposals))
    x0 = rs.uniform(0, 0.5, (n_images, num_proposals))
    return {
        InputFields.image: rs.randint(0, 256, (n_images, h, w, 3)).astype(
            np.uint8),
        InputFields.proposals: np.stack(
            [y0, x0,
             y0 + rs.uniform(0.1, 0.5, (n_images, num_proposals)),
             x0 + rs.uniform(0.1, 0.5, (n_images, num_proposals))],
            -1).astype(np.float32),
        InputFields.num_proposals: np.full((n_images,), num_proposals,
                                           np.int32),
        InputFields.pseudo_labels: (rs.rand(n_images, 3) < 0.4).astype(
            np.float32),
    }


def _rank_slice(host_batch):
    rank, world = mesh_lib.rank(), mesh_lib.world_size()
    n = len(host_batch[InputFields.image]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in host_batch.items()}


def _fresh(model, train_config, tree):
    params = params_lib.from_jax_numpy(tree, "cpu")
    tx, mask, _ = optimizers.build_optimizer(
        train_config, params, model.non_trainable_paths,
        model.non_trainable_substrings)
    trainer.set_trainable(params, mask)
    return {"params": params, "opt_state": tx.init(params), "step": 0}, tx, mask


def _jax_layout(state, mask):
    """(trainable params, Adagrad accumulators) as {path: numpy array} in
    the JAX layout."""
    flat_mask = dict(optimizers.flatten_params(mask))
    params = {p: v for p, v in optimizers.flatten_params(
        params_lib.to_jax_numpy(state["params"])) if flat_mask[p]}
    slots = dict(optimizers.flatten_params(params_lib.to_jax_numpy(
        optimizers.unflatten([(p, s["sum_of_squares"]) for p, s
                              in state["opt_state"]["slots"].items()]))))
    return params, slots


def _port_step(model, train_config, tree, host_batch, group):
    state, tx, mask = _fresh(model, train_config, tree)
    step = trainer.make_train_step(model, tx, train_config, mask,
                                   process_group=group)
    state, logs = step(state, model.device_batch(host_batch), 0)
    params, slots = _jax_layout(state, mask)
    return {"loss": float(logs["loss/total_loss"]), "params": params,
            "slots": slots}


def _misplaced_step(model, train_config, tree, host_batch, group):
    """The all-reduce after each rank's own (non-linear) Adagrad update:
    wrong, and the bounds must say so."""
    state, tx, mask = _fresh(model, train_config, tree)
    trainable = [(p, leaf) for p, leaf
                 in optimizers.flatten_params(state["params"])
                 if leaf.requires_grad]
    total, _ = model.loss(state["params"], model.device_batch(host_batch))
    grads = torch.autograd.grad(total, [leaf for _, leaf in trainable])
    opt_state = tx.apply(state["params"],
                         {p: g for (p, _), g in zip(trainable, grads)},
                         state["opt_state"])
    live = ([leaf for _, leaf in trainable]
            + [opt_state["slots"][p]["sum_of_squares"] for p, _ in trainable])
    with torch.no_grad():
        for t, mean in zip(live, mesh_lib.all_reduce_mean(live, group)):
            t.copy_(mean)
    params, slots = _jax_layout(state, mask)
    return {"params": params, "slots": slots}


class _RngProbeModel:
    """tests/test_trainer_spmd.py's probe: the gradient of w * u is the
    uniform draw u from the step's generator."""

    device = torch.device("cpu")

    def loss(self, params, batch, generator=None, is_training=True):
        u = torch.rand((), generator=generator)
        return params["w"] * u + 0.0 * batch["x"].sum(), {"u": u}


def _probe_step(group):
    """One SGD step at learning rate 1 of the probe: (-w, logged u)."""
    train_config = schema.loads_pipeline(
        "train_config { learning_rate: 1.0 optimizer { sgd {} } }"
    ).train_config
    params = {"w": torch.zeros((), requires_grad=True)}
    tx, _, _ = optimizers.build_optimizer(train_config, params)
    step = trainer.make_train_step(_RngProbeModel(), tx, train_config,
                                   process_group=group)
    state, logs = step({"params": params, "opt_state": tx.init(params),
                        "step": 0}, {"x": torch.ones(2, 3)}, 7)
    return -float(state["params"]["w"].detach()), float(logs["loss/u"])


def _parity_rank(device, config_text, tree, host_batch, out_dir):
    torch.set_num_threads(1)
    group = dist.group.WORLD
    cfg = schema.loads_pipeline(config_text)
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.float32, device=device)
    mine = _rank_slice(host_batch)
    result = {
        "good": _port_step(model, cfg.train_config, tree, mine, group),
        "bad": _misplaced_step(model, cfg.train_config, tree, mine, group),
        "probe": [_probe_step(group) for _ in range(2)],
    }
    path = os.path.join(out_dir, "rank%d.pkl" % mesh_lib.rank())
    with open(path, "wb") as f:
        pickle.dump(result, f)


def _max_abs(a, b):
    return max(float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
               for k in b)


def _max_rel(a, b):
    return max(float(np.linalg.norm(a[k].astype(np.float64) - b[k])
                     / (np.linalg.norm(b[k].astype(np.float64)) + 1e-12))
               for k in b)


def _jax_shard_map_step(config_text, tree, host_batch):
    """JAX's 2-device shard_map step (pmean over the data axis) on the
    whole batch: (loss, {path: param}, {path: accumulator}) of the
    trainable leaves, the accumulators sliced out of the fused optimizer
    state."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cap2det_tpu.config import schema as jax_schema
    from cap2det_tpu.models import registry as jax_registry
    from cap2det_tpu.parallel import mesh as jax_mesh
    from cap2det_tpu.train import optimizers as jax_optimizers
    from cap2det_tpu.train import trainer as jax_trainer
    import cap2det_tpu.models  # noqa: F401  (registers models)

    cfg = jax_schema.loads_pipeline(config_text)
    model = jax_registry.build(cfg.model, is_training=True,
                               compute_dtype=jnp.float32, use_pallas=False)
    params = jax.tree.map(jnp.asarray, tree)
    tx, mask, _ = jax_optimizers.build_optimizer(
        cfg.train_config, params,
        non_trainable_paths=model.non_trainable_paths,
        non_trainable_substrings=model.non_trainable_substrings)
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    mesh = jax_mesh.create_mesh(jax.devices()[:WORLD])
    step = jax.jit(jax.shard_map(
        jax_trainer.make_train_step(model, tx, cfg.train_config, mask,
                                    pmean_axis=jax_mesh.DATA_AXIS),
        mesh=mesh, in_specs=(P(), P(jax_mesh.DATA_AXIS), P()),
        out_specs=(P(), P()), check_vma=False))
    batch = {"image": host_batch[InputFields.image],
             "proposals": host_batch[InputFields.proposals],
             "num_proposals": host_batch[InputFields.num_proposals],
             "labels": host_batch[InputFields.pseudo_labels]}
    state, logs = step(jax.device_put(state, jax_mesh.replicated(mesh)),
                       jax_mesh.shard_batch(mesh, batch),
                       jax.device_put(jax.random.PRNGKey(0),
                                      jax_mesh.replicated(mesh)))
    paths = jax_optimizers.param_path_strings(params)
    trainable = [p for p, t in zip(paths, jax.tree_util.tree_leaves(mask))
                 if t]
    got = dict(zip(paths, jax.tree_util.tree_leaves(
        jax.device_get(state["params"]))))
    sizes = [np.asarray(got[p]).size for p in trainable]
    flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(state["opt_state"])) if np.size(x) == sum(sizes)]
    assert len(flat) == 1  # the fused accumulator vector
    pieces = np.split(flat[0], np.cumsum(sizes)[:-1])
    return (float(logs["loss/total_loss"]),
            {p: np.asarray(got[p]) for p in trainable},
            {p: x.reshape(np.shape(got[p])) for p, x in zip(trainable,
                                                             pieces)})


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The ranks' results, the port's one-process step and JAX's
    2-device step, from the same params and global batch of 4."""
    root = tmp_path_factory.mktemp("data_parallel")
    label_file = synthetic.write_label_file(str(root / "labels.txt"),
                                            CLASSES)
    config_text = _PIPELINE % label_file
    cfg = schema.loads_pipeline(config_text)
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.float32, device="cpu")
    tree = model.init_jax_numpy(3)
    host_batch = _global_batch(2 * WORLD)
    distributed.spawn(_parity_rank, WORLD, args=(
        config_text, tree, host_batch, str(root)), device="cpu",
        timeout=TIMEOUT)
    ranks = []
    for r in range(WORLD):
        with open(root / ("rank%d.pkl" % r), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks,
            "single": _port_step(model, cfg.train_config, tree, host_batch,
                                 None),
            "jax": _jax_shard_map_step(config_text, tree, host_batch)}


def test_two_ranks_match_jax_shard_map_and_one_process(parity):
    good = parity["ranks"][0]["good"]
    other = parity["ranks"][1]["good"]
    assert len(good["params"]) > 50  # the real model, not a probe
    # The all-reduce gives every rank the same update, bit for bit.
    assert other["loss"] == good["loss"]
    for k in good["params"]:
        np.testing.assert_array_equal(other["params"][k], good["params"][k])
        np.testing.assert_array_equal(other["slots"][k], good["slots"][k])
    jax_loss, jax_params, jax_slots = parity["jax"]
    single = parity["single"]
    assert set(good["params"]) == set(jax_params) == set(single["params"])
    for want_loss, want_params, want_slots in (
            (jax_loss, jax_params, jax_slots),
            (single["loss"], single["params"], single["slots"])):
        assert _max_abs(good["params"], want_params) < PARAM_TOL
        assert _max_rel(good["slots"], want_slots) < ACC_REL_TOL
        np.testing.assert_allclose(good["loss"], want_loss, rtol=LOSS_RTOL)


def test_misplaced_all_reduce_trips_the_bounds(parity):
    bad = parity["ranks"][0]["bad"]
    for _, want_params, want_slots in (
            parity["jax"], (None, parity["single"]["params"],
                            parity["single"]["slots"])):
        assert (_max_abs(bad["params"], want_params) > PARAM_TOL
                or _max_rel(bad["slots"], want_slots) > ACC_REL_TOL)


def test_rank_seeds_differ_and_the_step_is_deterministic(parity):
    draws = [float(torch.rand((), generator=torch.Generator().manual_seed(
        trainer.step_seed(7, 0, rank)))) for rank in range(WORLD)]
    assert len(set(draws)) == WORLD
    for result in parity["ranks"]:
        first, again = result["probe"]
        assert first == again  # deterministic
        # The gradient is the mean of the ranks' draws, and so is the
        # logged u.
        np.testing.assert_allclose(first, [np.mean(draws)] * 2, atol=1e-7)
    correlated = float(torch.rand((), generator=torch.Generator().manual_seed(
        trainer.step_seed(7, 0))))
    assert not np.isclose(first[0], correlated, atol=1e-6)


def test_a_group_of_one_keeps_the_no_group_bits(tmp_path):
    label_file = synthetic.write_label_file(str(tmp_path / "labels.txt"),
                                            CLASSES)
    cfg = schema.loads_pipeline(_PIPELINE % label_file)
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.float32, device="cpu")
    tree = model.init_jax_numpy(3)
    host_batch = _global_batch(2)
    want = _port_step(model, cfg.train_config, tree, host_batch, None)
    want_probe = _probe_step(None)
    device = distributed.maybe_initialize(
        "localhost:%d" % distributed.free_port(), 1, 0, device="cpu")
    try:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo" and mesh_lib.world_size() == 1
        got = _port_step(model, cfg.train_config, tree, host_batch,
                         dist.group.WORLD)
        assert _probe_step(dist.group.WORLD) == want_probe
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()
    assert got["loss"] == want["loss"]
    for part in ("params", "slots"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)


_TORCHRUN = {"MASTER_ADDR": "node0", "MASTER_PORT": "29500",
             "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
             "LOCAL_WORLD_SIZE": "4"}
_JAX_LAUNCHER = {"JAX_COORDINATOR_ADDRESS": "node0:1234",
                 "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}


@pytest.mark.parametrize("env,device,cuda_count,want", [
    ({}, "cuda", 1, None),
    (_TORCHRUN, "cuda", 4,
     ("tcp://node0:29500", 8, 5, "nccl", "cuda:1")),
    (_TORCHRUN, "cuda", 2,  # four ranks on two cards share them
     ("tcp://node0:29500", 8, 5, "gloo", "cuda:1")),
    (_TORCHRUN, "cpu", 0, ("tcp://node0:29500", 8, 5, "gloo", "cpu")),
    (_JAX_LAUNCHER, "cuda", 2, ("tcp://node0:1234", 2, 1, "nccl", "cuda:1")),
    (_JAX_LAUNCHER, "cuda", 1, ("tcp://node0:1234", 2, 1, "gloo", "cuda:0")),
    (dict(_JAX_LAUNCHER, **_TORCHRUN), "cpu", 0,  # torchrun's come first
     ("tcp://node0:29500", 8, 5, "gloo", "cpu")),
], ids=["none", "torchrun_card_each", "torchrun_shared_cards", "torchrun_cpu",
        "jax_card_each", "jax_one_card", "both"])
def test_settings_from_the_launchers(env, device, cuda_count, want):
    found = distributed.settings(device=device, environ=env,
                                 cuda_count=cuda_count)
    if want is None:
        assert found is None
        return
    assert (found["init_method"], found["world_size"], found["rank"],
            found["backend"], str(found["device"])) == want


def test_settings_refuse_what_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="world size"):
        distributed.settings(environ={"MASTER_ADDR": "a", "MASTER_PORT": "1"})
    with pytest.raises(ValueError, match="outside"):
        distributed.settings(environ=dict(_JAX_LAUNCHER, JAX_PROCESS_ID="2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.settings(environ=_JAX_LAUNCHER, cuda_count=0)
    for key in list(_TORCHRUN) + list(_JAX_LAUNCHER):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize() is False
    assert not dist.is_initialized()


_TRAIN_READER = """
train_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: true
    shuffle_buffer_size: 4
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    preprocess_options { random_flip_left_right_prob: 0.5 }
    max_num_proposals: 16
    batch_resize_scale_value: 1.0
    shard_indicator: "0/2"
  }
}
train_config {
  max_steps: 2
  learning_rate: 0.01
  optimizer { adagrad {} }
  save_checkpoints_steps: 2
  log_step_count_steps: 1
}
"""


def _train_rank(device, config_text, model_dir, out_dir):
    """train() with spies on what it writes and the pipeline's seed."""
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.train import metrics as metrics_lib

    torch.set_num_threads(1)
    calls = {"save": 0, "write": 0, "seed": None}
    real = (ckpt_lib.CheckpointManager.save, metrics_lib.MetricsWriter.write,
            pipeline_lib.build_input_pipeline)

    def save(self, *a, **k):
        calls["save"] += 1
        return real[0](self, *a, **k)

    def write(self, *a, **k):
        calls["write"] += 1
        return real[1](self, *a, **k)

    def build(reader, seed=0, **k):
        calls["seed"] = seed
        return real[2](reader, seed=seed, **k)

    ckpt_lib.CheckpointManager.save = save
    metrics_lib.MetricsWriter.write = write
    pipeline_lib.build_input_pipeline = build
    losses = []
    state = trainer.train(
        schema.loads_pipeline(config_text), model_dir=model_dir,
        device=device, hooks=[lambda step, st, logs: losses.append(
            float(logs["loss/total_loss"]))])
    digest = hashlib.sha256()
    for _, leaf in optimizers.flatten_params(state["params"]):
        digest.update(leaf.detach().numpy().tobytes())
    calls.update(losses=losses, step=state["step"],
                 params=digest.hexdigest())
    with open(os.path.join(out_dir, "train%d.json" % mesh_lib.rank()),
              "w") as f:
        json.dump(calls, f)


def test_train_on_two_ranks(tmp_path):
    """Two ranks of train() over one model_dir: only rank 0 saves and
    logs, the shared shard_indicator sends each rank to its own pipeline
    seed, and the reduced gradients keep the ranks' params equal."""
    record = str(tmp_path / "train.record")
    synthetic.write_synthetic_dataset(record, num_examples=8, seed=3,
                                      classes=CLASSES, image_hw=(96, 128),
                                      num_proposals=16)
    label_file = synthetic.write_label_file(str(tmp_path / "labels.txt"),
                                            CLASSES)
    model_text = _PIPELINE.split("train_config")[0] % label_file
    config_text = model_text + _TRAIN_READER % {"record": record}
    model_dir = str(tmp_path / "model")
    distributed.spawn(_train_rank, WORLD, args=(
        config_text, model_dir, str(tmp_path)), device="cpu",
        timeout=TIMEOUT)
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / ("train%d.json" % r)) as f:
            ranks.append(json.load(f))
    assert [r["seed"] for r in ranks] == [0, 7919]  # seed + 7919 x rank
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["save"] >= 1 and ranks[0]["write"] == 2
    assert ranks[1]["save"] == ranks[1]["write"] == 0
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert np.all(np.isfinite(ranks[0]["losses"]))
    assert ranks[0]["params"] == ranks[1]["params"]
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert [s for s, _ in ckpt_lib.list_checkpoints(model_dir)] == [2]


def test_dryrun_multichip_on_the_cpu(capsys):
    worst = entry.dryrun_multichip(WORLD, device="cpu", timeout=TIMEOUT)
    assert worst < entry.PARITY_TOL
    assert "dryrun_multichip ok: 2 ranks on cpu" in capsys.readouterr().out


def test_entry_runs_the_tiny_forward():
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert len(out) == 4  # MIDN and three OICR iterations
    for key, scores in out.items():
        assert scores.shape[:2] == (2, 16), key
        assert torch.isfinite(scores).all(), key
