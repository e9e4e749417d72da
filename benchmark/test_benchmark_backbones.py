"""The reference's backbone, found by the configuration's
``model.feature_extractor``, on the CPU: the weights and FLOP counts of
the benchmark's configurations are the pinned ones, and a backbone added
as one new file under ``benchmark/reference/`` runs through the weights,
the FLOP count, the loss and its gradients, the update and prediction
with no other file of the benchmark changed.

    python -m pytest benchmark/test_benchmark_backbones.py -q
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import sys

import pytest
import torch

from benchmark import harness, small
from benchmark.drivers import predict, train_step
from benchmark.reference import cap2det as ref
from benchmark.yardstick import flops, traffic, weights

BENCH = harness.benchmark_file()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2 ** 31 + 23


def leaf_digest(leaf):
    """sha256 of a leaf's shape, dtype and bytes."""
    h = hashlib.sha256(("%s %s" % (tuple(leaf.shape), leaf.dtype)).encode())
    h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _canvases(cfg):
    return ([b[2] for b in traffic.train_buckets(cfg)],
            traffic.eval_canvases(cfg, True)
            + traffic.eval_canvases(cfg, False))


def _rows(counts):
    return [[list(hw), list(n)] for hw, n in counts.items()]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_and_flops_equal_the_pinned_digests(name):
    """``benchmark/pinned/<config>.json``: every leaf of the seed's
    weights (this host's torch draws them on the CPU) and the full-size
    FLOP count of every canvas of both mixes, as the tree gave them
    before the backbone was split out of ``reference/cap2det.py``."""
    pinned = harness.load_json(harness.HERE / "pinned" / (name + ".json"))
    cfg = harness.config(name)
    for seed in pinned["seeds"]:
        got = [(path, leaf_digest(leaf)) for path, leaf in
               ref.flatten(weights.make_params(cfg["model"], seed, "cpu"))]
        assert got == list(zip(pinned["paths"],
                               pinned["leaves"][str(seed)])), seed
    train, scales = _canvases(cfg)
    assert _rows(flops.train_step_flops(cfg, train)) == \
        pinned["train_step_flops"]
    assert _rows(flops.predict_flops(cfg, scales)) == pinned["predict_flops"]


def test_an_unknown_feature_extractor_names_the_missing_file():
    with pytest.raises(ModuleNotFoundError,
                       match="benchmark/reference/no_such_net.py"):
        ref.backbone({"feature_extractor": "no_such_net"})
    model = harness.config(CONFIGS[0])["model"]
    assert ref.backbone(model).__name__ == \
        "benchmark.reference." + model["feature_extractor"]


TOY_NAME = "toy_net"
TOY_FEATURES = 48
TOY = '''
"""A toy backbone: one strided convolution with BatchNorm a stage."""

import torch

from . import cap2det as common

FEATURE_DIM = %d
MEANS = (123.68, 116.779, 103.939)


def param_spec():
    return (common.conv_leaves((common.FIRST_SCOPE, "Toy", "conv1"), 16, 3,
                               3)
            + common.conv_leaves((common.SECOND_SCOPE, "Toy", "conv2"),
                                 FEATURE_DIM, 16, 3)), []


def dense_weights(node):
    return None


def preprocess(images):
    return images.float() - torch.tensor(MEANS, device=images.device)


def _stage(conv, x):
    x = common.conv_relu(conv, x.contiguous().permute(0, 3, 1, 2), 2)
    return x.permute(0, 2, 3, 1).contiguous()


def first_stage(folded, images):
    return _stage(folded["Toy"]["conv1"], images)


def second_stage(folded, rois):
    return _stage(folded["Toy"]["conv2"], rois)
''' % TOY_FEATURES


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """coco17's small configuration with a toy backbone, its module a
    file of its own under ``benchmark.reference``, the first stage
    trainable."""
    path = tmp_path / (TOY_NAME + ".py")
    path.write_text(TOY)
    spec = importlib.util.spec_from_file_location(
        "benchmark.reference." + TOY_NAME, path)
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, module)
    spec.loader.exec_module(module)
    cfg = small.config("coco17_extend_match")
    cfg["model"]["feature_extractor"] = TOY_NAME
    cfg["train"]["gradient_multipliers"] = [
        [ref.FIRST_SCOPE, 0.0], [ref.SECOND_SCOPE, 1.0],
        [ref.FIRST_SCOPE + "/Toy/conv1", 1.0]]
    return cfg


def test_a_backbone_added_as_a_file_runs_every_reference_path(toy):
    cfg = toy
    model, classes = cfg["model"], cfg["model"]["num_classes"]
    params = weights.make_params(model, SEED, "cpu")
    flat = dict(ref.flatten(params))
    conv1 = ref.FIRST_SCOPE + "/Toy/conv1/weights"
    conv2 = ref.SECOND_SCOPE + "/Toy/conv2/weights"
    assert flat[conv1].shape == (16, 3, 3, 3)
    assert flat[conv2].shape == (TOY_FEATURES, 16, 3, 3)
    assert flat["midn/proba_c_given_r/weights"].shape == (classes,
                                                          TOY_FEATURES)
    assert flat["oicr/iter3/weights"].shape == (1 + classes, TOY_FEATURES)
    assert float(flat[conv1].abs().max()) <= 2 * (2.0 / 27) ** 0.5

    # The FLOP count: the first stage is conv1's forward and its weight
    # gradient, and a unit's count is that of its valid proposals.
    canvases = [b[2] for b in traffic.train_buckets(cfg)][:2]
    b = cfg["train"]["batch_size"]
    step = flops.train_step_flops(cfg, canvases)
    scale = flops.predict_flops(cfg, canvases)
    for h, w in canvases:
        conv = 2 * b * (h // 2) * (w // 2) * 16 * 27
        assert flops._first_stage_flops(cfg, (h, w)) == 2 * conv
        q = cfg["train"]["max_num_proposals"] // 2
        assert flops.unit_flops(step, (h, w), b * q) == pytest.approx(
            flops._train_step_flops(cfg, (h, w), q), rel=1e-12)
        assert flops.unit_flops(scale, (h, w), q) == pytest.approx(
            flops.predict_scale_flops(cfg, (h, w), q), rel=1e-12)

    # The loss and its gradients, then the update, from the seed's batch.
    host = traffic.train_batches(small.mix("train_buckets"), cfg, SEED)
    batch = train_step.reference_batch(host[0][0], "cpu")
    leaves = [flat[conv1], flat[conv2], flat["oicr/iter1/weights"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    generator = torch.Generator().manual_seed(SEED)
    total = ref.loss(params, batch, model, generator)
    grads = torch.autograd.grad(total, leaves)
    assert torch.isfinite(total)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
               for g in grads)
    start = {p: leaf.detach().clone() for p, leaf in flat.items()}
    trainer = ref.AdagradTrainer(params, cfg["train"], model)
    losses = [trainer.step(batch, SEED), trainer.step(
        train_step.reference_batch(host[1][0], "cpu"), SEED)]
    assert all(math.isfinite(x) for x in losses)
    moved = {p for p, leaf in ref.flatten(params)
             if not torch.equal(leaf.detach(), start[p])}
    assert {conv1, conv2, "oicr/iter1/weights"} <= moved
    assert not any("/BatchNorm/moving_" in p for p in moved)

    # Prediction, and drivers/predict.py's reference path over it.
    folded = ref.fold_all(params, model, torch.bfloat16)
    images = torch.as_tensor(host[0][0]["image"])
    proposals = torch.as_tensor(host[0][0]["proposals"])
    num = torch.as_tensor(host[0][0]["number_of_proposals"])
    with torch.no_grad():
        preds = ref.predictions(params, folded, images, proposals, num,
                                model)
    p = proposals.shape[1]
    assert preds["oicr_proposal_scores_at_3"].shape == (b, p, 1 + classes)
    assert preds["midn_class_logits"].shape == (b, classes)
    example = traffic.eval_images(small.mix("eval_coco"), cfg, SEED)[0]
    scores, props, n = predict.reference_scores(params, folded, example,
                                                cfg, "cpu")
    dets = predict.reference_detections(scores, props, n, cfg, "cpu")
    assert scores["oicr_proposal_scores_at_1"].shape == (1, p, 1 + classes)
    assert int(dets["num_detections_at_3"]) >= 1
