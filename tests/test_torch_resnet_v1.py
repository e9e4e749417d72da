"""ResNet-101 v1 (``cap2det_tpu_torch/models/resnet_v1.py``, the
``faster_rcnn_resnet101`` backbone) on the CPU against the benchmark's
plain reference (``benchmark/reference/faster_rcnn_resnet101.py``), in
float32 on seeded weights with a random gamma in every BatchNorm:

* the full resnet_v1_101 tree's paths and shapes are the reference's;
* a shallow unit table through the same code: features, the training
  loss and every trainable leaf's gradient (gamma's too); the full 101
  layers' features at the same tiny size;
* ``conv2d_same``'s padding, which TF SAME is not; the fold against an
  unfolded ``F.batch_norm`` at epsilon 1e-5, which epsilon 1e-3 misses;
* the reference's fold in bfloat16 gives the port's bits, forward and
  backward; block4's remat changes no bit; the block spans; the overlay
  of a converted checkpoint; an unknown extractor type raises.

The reference's fold rounds through bfloat16 (the configuration's
convolution dtype), so the float32 comparisons hand the shared fold the
plain kernel ``weights * gamma * sqrt((v + 1e-3) / (v + 1e-5))`` instead;
its ``moving_mean`` stays zero (the reference's limit), the other BN
statistics are drawn away from the init's.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cap2det_tpu_torch.models  # noqa: F401  (registers the model)
from benchmark import harness
from benchmark.reference import cap2det as ref
from benchmark.reference import faster_rcnn_resnet101 as rnet
from benchmark.yardstick import weights
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.kernels import bn_fold
from cap2det_tpu_torch.models import frcnn, registry, resnet_v1

torch.set_num_threads(1)

CONFIG = "coco17_resnet101"
SEED = 2 ** 31 + 13
# block1-block4's units: a projection shortcut opens each block, block1-2
# end in a strided subsample, block3 in a stride-1 identity.
SHALLOW = (2, 2, 2, 2)
CANVAS = (64, 96)
PROPOSALS = 4
# float32 through 10-34 residual units summed in other orders (the ROI
# crop's arithmetic, the fold's two products against one); activations
# near unit scale.
RTOL = 1e-4


def _plain_dense_weights(node):
    bn = node.get("BatchNorm")
    if "weights" not in node or not isinstance(bn, dict):
        return None
    v = bn["moving_variance"]
    factor = bn["gamma"] * torch.sqrt((v + ref.BN_EPSILON) / (v + 1e-5))
    return node["weights"] * factor[:, None, None, None]


@pytest.fixture(scope="module")
def cfg():
    return harness.config(CONFIG)


def _model(cfg, dtype=torch.float32):
    pipe = schema.loads_pipeline(cfg["pbtxt"])
    return registry.build(pipe.model, is_training=True, compute_dtype=dtype,
                          device="cpu")


def _params(cfg, units, seed=SEED):
    """The benchmark's weights of `units`, beta and moving_variance
    drawn away from their init; moving_mean zero."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rnet, "param_spec",
                   functools.partial(rnet.param_spec, units))
        params = weights.make_params(cfg["model"], seed, "cpu")
    rng = np.random.default_rng(seed % 2 ** 32)
    for path, leaf in ref.flatten(params):
        if path.endswith("BatchNorm/beta"):
            leaf.copy_(torch.from_numpy(
                rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)))
        elif path.endswith("moving_variance"):
            leaf.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)))
    return params


def _copy(tree):
    return weights.to_device(tree, "cpu")


def _batch(cfg, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    b, classes = cfg["train"]["batch_size"], cfg["model"]["num_classes"]
    y, x = torch.rand((2, b, PROPOSALS, 2), generator=gen)
    boxes = torch.stack([y.min(-1).values, x.min(-1).values,
                         y.max(-1).values, x.max(-1).values], -1)
    labels = (torch.rand((b, classes), generator=gen) < 0.05).float()
    labels[:, 0] = 1.0
    return {"image": torch.randint(0, 256, (b, *CANVAS, 3), generator=gen,
                                   dtype=torch.uint8),
            "proposals": boxes,
            "num_proposals": torch.tensor([PROPOSALS, PROPOSALS - 1],
                                          dtype=torch.int32),
            "labels": labels}


def _close(a, b, what, floor=1e-12):
    """|a - b| within RTOL of b's largest magnitude, or of `floor` where
    b is round-off (a gradient that cancels, as the MIDN biases')."""
    a, b = a.detach().double(), b.detach().double()
    err = float((a - b).abs().max())
    assert err <= RTOL * max(float(b.abs().max()), floor), (what, err)


def test_param_tree_is_the_references(cfg):
    model = _model(cfg)
    tree = model.init_jax_numpy(0)
    ours = dict(ref.flatten(params_lib.from_jax_numpy(
        {s: tree[s] for s in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE)},
        "cpu")))
    spec, empty = rnet.param_spec()
    assert empty == []
    want = {"/".join(path): shape for path, shape, _ in spec}
    assert sorted(ours) == sorted(want)
    assert all(tuple(ours[p].shape) == want[p] for p in want)
    convs = [p for p in want if p.endswith("/weights")]
    first = [p for p in convs if p.startswith(frcnn.FIRST_SCOPE)]
    assert (len(convs), len(first)) == (104, 94)
    multipliers = [tuple(m) for m in cfg["train"]["gradient_multipliers"]]
    assert sum(ref.trainable(p, multipliers) is not None
               for p in convs) == 80
    assert ("first_stage_feature_extraction/resnet_v1_101/block3/unit_7/"
            "bottleneck_v1/conv2/BatchNorm/gamma") in want
    assert model.feature_dim == rnet.FEATURE_DIM == 2048
    assert ours[frcnn.FIRST_SCOPE + "/resnet_v1_101/conv1/BatchNorm/gamma"
                ].eq(1).all()  # TF's initial gamma


@pytest.fixture
def plain_fold(monkeypatch):
    monkeypatch.setattr(rnet, "dense_weights", _plain_dense_weights)


def _features(cfg, params, prog_params, batch):
    model = _model(cfg)
    got = frcnn.extract_features(model.prepare(prog_params), batch["image"],
                                 batch["proposals"],
                                 model.options.frcnn_options)
    want = ref.extract_features(
        ref.fold_all(params, cfg["model"], torch.float32), batch["image"],
        batch["proposals"], cfg["model"])
    return got, want


def test_shallow_network_loss_and_gradients_are_the_references(
        cfg, plain_fold):
    params = _params(cfg, SHALLOW)
    ours = _copy(params)
    batch = _batch(cfg)
    with torch.no_grad():
        got, want = _features(cfg, params, ours, batch)
    assert got.shape == (2, PROPOSALS, 2048)
    _close(got, want, "features")

    multipliers = [tuple(m) for m in cfg["train"]["gradient_multipliers"]]
    paths = [p for p, _ in ref.flatten(params)
             if ref.trainable(p, multipliers) is not None]
    assert any(p.endswith("block3/unit_2/bottleneck_v1/conv3/BatchNorm/gamma")
               for p in paths)
    assert not any("block2" in p for p in paths)
    losses, grads = [], []
    for tree, loss in (
            (ours, lambda t, g: _model(cfg).loss(t, batch, g)[0]),
            (params, lambda t, g: ref.loss(t, batch, cfg["model"], g,
                                           torch.float32))):
        flat = dict(ref.flatten(tree))
        leaves = [flat[p].requires_grad_() for p in paths]
        total = loss(tree, torch.Generator().manual_seed(7))
        losses.append(total)
        grads.append(torch.autograd.grad(total, leaves))
    _close(losses[0], losses[1], "loss")
    scale = float(np.median([float(g.abs().max()) for g in grads[1]]))
    for path, a, b in zip(paths, *grads):
        assert float(b.abs().max()) > 0, path
        _close(a, b, path, 1e-3 * scale)


def test_full_network_features_are_the_references(cfg, plain_fold):
    params = _params(cfg, None)
    batch = _batch(cfg, SEED + 1)
    with torch.no_grad():
        got, want = _features(cfg, params, _copy(params), batch)
    _close(got, want, "features")


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (3, 1)])
def test_conv2d_same_pads_symmetrically_unlike_tf_same(size, k, stride):
    gen = torch.Generator().manual_seed(size + k)
    x = torch.randn((1, 5, size, size + 3), generator=gen)
    conv = {"weight": torch.randn((6, 5, k, k), generator=gen),
            "bias": torch.randn((6,), generator=gen)}
    got = resnet_v1._conv(conv, x, stride, relu=False)
    p = (k - 1) // 2
    want = F.conv2d(F.pad(x, (p, k - 1 - p, p, k - 1 - p)), conv["weight"],
                    conv["bias"], stride=stride)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    _, top, bottom = ref.same_pads(size, k, stride)
    _, left, right = ref.same_pads(size + 3, k, stride)
    tf_same = F.conv2d(F.pad(x, (left, right, top, bottom)), conv["weight"],
                       conv["bias"], stride=stride)
    if (top, left) == (p, p):  # odd inputs, or stride 1
        assert torch.allclose(tf_same, want, rtol=1e-5, atol=1e-5)
    else:
        assert not torch.allclose(tf_same, want, rtol=1e-2, atol=1e-2)


def test_the_fold_is_batch_norm_at_epsilon_1e5_and_not_1e3():
    rng = np.random.default_rng(3)
    tree = resnet_v1.init_first_stage_params_numpy(
        rng, (("block1", 1, 256, 64, 2),))
    bn = tree[resnet_v1.NET]["conv1"]["BatchNorm"]
    bn["gamma"] = rng.normal(0, 1, 64).astype(np.float32)
    bn["beta"] = rng.normal(0, 1, 64).astype(np.float32)
    bn["moving_mean"] = rng.normal(0, 1, 64).astype(np.float32)
    bn["moving_variance"] = rng.uniform(0.002, 0.02, 64).astype(np.float32)
    params = params_lib.from_jax_numpy(tree, "cpu")
    conv = params[resnet_v1.NET]["conv1"]
    b = conv["BatchNorm"]
    x = torch.randn((1, 3, 22, 31), generator=torch.Generator().manual_seed(1))
    want = F.batch_norm(F.conv2d(x, conv["weights"], stride=2, padding=3),
                        b["moving_mean"], b["moving_variance"], b["gamma"],
                        b["beta"], training=False, eps=1e-5)
    prepared = bn_fold.fold_trees([params], torch.float32,
                                  resnet_v1.BN_EPSILON)[0]
    got = resnet_v1._conv(prepared[resnet_v1.NET]["conv1"], x, 2, relu=False)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    weight, bias = bn_fold.fold([(conv["weights"], b["beta"],
                                  b["moving_mean"], b["moving_variance"],
                                  b["gamma"])], torch.float32, eps=1e-3)[0]
    off = F.conv2d(x, weight, bias, stride=2, padding=3)
    assert not torch.allclose(off, want, rtol=1e-2, atol=1e-2)


def test_the_references_bf16_fold_is_the_ports_bit_for_bit(cfg):
    """``dense_weights`` through the shared fold (epsilon 1e-3, no scale)
    gives the port's folded weights and biases, and from the same
    upstream gradients the port's gradients of the weights, betas and
    gammas (``bn_fold.fold_grad_reference``'s formulas), bit for bit."""
    params = weights.make_params(cfg["model"], SEED, "cpu")
    scope = params[frcnn.SECOND_SCOPE]
    slots = []
    bn_fold.gather(scope, slots)
    convs = [(w, bn["beta"], bn["moving_mean"], bn["moving_variance"],
              bn["gamma"]) for _, _, w, bn in slots]
    leaves = [t for c in convs for t in (c[0], c[1], c[4])]
    for t in leaves:
        t.requires_grad_()
    gen = torch.Generator().manual_seed(5)
    outs = {}
    outs["port"] = [t for pair in bn_fold.fold(convs, torch.bfloat16, 1e-5)
                    for t in pair]
    folded = ref.fold(scope, torch.bfloat16, rnet.dense_weights)
    outs["ref"] = [t for node in _conv_nodes(folded)
                   for t in (node["weight"], node["bias"])]
    upstream = []
    for t in outs["port"]:
        g = torch.randn(t.shape, generator=gen).to(t.dtype)
        if t.dim() == 4 and t.shape[-1] > 1:
            g = g.contiguous(memory_format=torch.channels_last)
        upstream.append(g)
    grads = {}
    for side in ("port", "ref"):
        assert len(outs[side]) == 2 * len(convs) == 20
        grads[side] = torch.autograd.grad(outs[side], leaves, upstream)
    for a, b in zip(outs["port"], outs["ref"]):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    for i, (a, b) in enumerate(zip(grads["port"], grads["ref"])):
        assert torch.equal(a, b), i


def _conv_nodes(tree):
    """The folded convolutions of a tree in the order
    ``bn_fold.gather`` walks it (keys in insertion order)."""
    out = []
    for value in tree.values():
        if "weight" in value:
            out.append(value)
        else:
            out.extend(_conv_nodes(value))
    return out


def test_block4_remat_changes_no_bit(cfg):
    params = _params(cfg, SHALLOW)
    prepared = frcnn.prepare(params, torch.float32)[frcnn.SECOND_SCOPE]
    rois = torch.randn((3, 7, 7, 1024),
                       generator=torch.Generator().manual_seed(2))
    runs = []
    for remat in (False, True):
        x = rois.clone().requires_grad_()
        out = resnet_v1.second_stage(prepared, x, remat=remat)
        runs.append((out, torch.autograd.grad(out.square().sum(), x)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_each_block_opens_its_span_inside_its_stage(cfg):
    params = _params(cfg, SHALLOW)
    model = _model(cfg)
    batch = _batch(cfg)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.predictions(model.prepare(params), batch)
    events = {e.name: e for e in prof.events()}
    for stage, blocks in (("first_stage", ("block1", "block2", "block3")),
                          ("second_stage", ("block4",))):
        outer = events["cap2det/model/" + stage]
        for block in blocks:
            inner = events["cap2det/model/resnet/" + block]
            assert outer.time_range.start <= inner.time_range.start
            assert inner.time_range.end <= outer.time_range.end


def test_load_pretrained_overlays_a_converted_resnet_by_name(cfg):
    params = _params(cfg, SHALLOW)
    rng = np.random.default_rng(4)
    converted = {resnet_v1.NET: {
        "conv1": resnet_v1._conv_numpy(rng, 7, 3, 64)}}
    first = resnet_v1.init_first_stage_params_numpy(
        rng, tuple(b[:1] + (1,) + b[2:] for b in resnet_v1.FIRST_BLOCKS))
    second = resnet_v1.init_second_stage_params_numpy(
        rng, tuple(b[:1] + (1,) + b[2:] for b in resnet_v1.SECOND_BLOCKS))
    for tree in (first, second):
        for name, block in tree[resnet_v1.NET].items():
            if name != "conv1":
                converted[resnet_v1.NET][name] = block
    converted[resnet_v1.NET]["logits"] = {"weights": np.ones((1, 1, 2048, 3),
                                                             np.float32)}
    src = params_lib.from_jax_numpy(converted, "cpu")
    out = frcnn.load_pretrained(params, src)
    net = resnet_v1.NET
    got, before = dict(ref.flatten(out)), dict(ref.flatten(params))
    loaded = dict(ref.flatten({frcnn.FIRST_SCOPE: {net: {
        k: v for k, v in src[net].items() if k not in ("block4", "logits")}},
        frcnn.SECOND_SCOPE: {net: {"block4": src[net]["block4"]}}}))
    assert loaded and set(loaded) < set(got)
    for path, leaf in got.items():
        want = loaded.get(path, before.get(path))
        assert want is not None and torch.equal(leaf, want), path
    # unit_2 of each block is not in the checkpoint: kept from params.
    assert any("unit_2" in p for p in got if p not in loaded)
    assert not any("logits" in p for p in got)


def test_an_unknown_feature_extractor_still_raises(cfg):
    options = schema.loads_pipeline(cfg["pbtxt"]).model.cap2det_model
    assert frcnn.backbone(options.frcnn_options) is resnet_v1
    bad = cfg["pbtxt"].replace("faster_rcnn_resnet101", "faster_rcnn_nas")
    with pytest.raises(ValueError, match="unsupported feature extractor"):
        registry.build(schema.loads_pipeline(bad).model, device="cpu")
