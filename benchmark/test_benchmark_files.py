"""The benchmark's files, on the CPU: every cell finds its configuration,
mix, driver, limits and metric readers by name; inputs and weights come
from the seed; the frozen operation and byte formulas equal the
program's; nothing imports what it may not.

    python -m pytest benchmark/ -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, small
from benchmark.reference import cap2det as ref
from benchmark.yardstick import flops, peaks, traffic, weights, work

BENCH = harness.benchmark_file()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    w = harness.find(BENCH["workloads"], cell, "workload")
    entry = harness.find(BENCH["configs"], w["config"], "config")
    assert entry["file"] == "benchmark/configs/%s.json" % w["config"]
    cfg = harness.config(w["config"])
    assert cfg["name"] == w["config"]
    assert cfg["reduced"] == entry["reduced"]
    mix = harness.mix(w["traffic"])
    assert callable(harness.driver(mix["driver"]).run)
    limits = harness.limits(w["config"], mix["driver"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
        assert m["moves"] in names


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics + BENCH["workloads"]
             + BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
        assert pairs.count((w["config"], w["traffic"])) == 1
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_metric_reader_file_is_named_in_the_benchmark():
    readers = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_values_match_its_pbtxt(name):
    """The plain values the reference reads are the pbtxt's that the
    program reads."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.text import extractors

    cfg = harness.config(name)
    pipe = schema.loads_pipeline(cfg["pbtxt"])
    m = pipe.model.cap2det_model
    model, train = cfg["model"], cfg["train"]
    assert extractors.build_label_extractor(
        m.label_extractor).num_classes == model["num_classes"]
    assert m.oicr_iterations == model["oicr_iterations"]
    assert m.oicr_iou_threshold == model["oicr_iou_threshold"]
    assert m.oicr_use_proba_r_given_c == model["oicr_use_proba_r_given_c"]
    assert m.midn_loss_weight == model["midn_loss_weight"]
    assert m.oicr_loss_weight == model["oicr_loss_weight"]
    hp = m.fc_hyperparams
    assert hp.regularizer.l2_regularizer.weight == model["fc_l2"]
    assert (hp.initializer.truncated_normal_initializer.stddev
            == model["fc_stddev"])
    f = m.frcnn_options
    assert f.feature_extractor.type == model["feature_extractor"]
    assert (f.initial_crop_size, f.maxpool_kernel_size, f.maxpool_stride,
            f.dropout_keep_prob, f.dropout_on_feature_map) == (
        model["initial_crop_size"], model["maxpool_kernel_size"],
        model["maxpool_stride"], model["dropout_keep_prob"],
        model["dropout_on_feature_map"])
    assert list(m.eval_min_dimension) == model["eval_min_dimension"]
    for post, key in ((m.midn_post_processor, "midn_post"),
                      (m.oicr_post_processor, "oicr_post")):
        assert {k: getattr(post, k) for k in model[key]} == model[key]
    reader = pipe.train_reader.cap2det_reader
    assert reader.batch_size == train["batch_size"]
    assert reader.max_num_proposals == train["max_num_proposals"]
    assert list(reader.batch_resize_scale_value) == train["scales"]
    resizer = reader.image_resizer.keep_aspect_ratio_resizer
    assert resizer.min_dimension == train["min_dimension"]
    assert (pipe.eval_reader.cap2det_reader.max_num_proposals
            == cfg["eval"]["max_num_proposals"])
    tc = pipe.train_config
    assert tc.learning_rate == train["learning_rate"]
    assert tc.learning_rate_decay.decay_rate == 1.0
    assert (tc.optimizer.adagrad.initial_accumulator_value
            == train["initial_accumulator_value"])
    assert [[g.scope, g.multiplier] for g in tc.gradient_multiplier] == \
        train["gradient_multipliers"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_come_from_the_seed_in_the_program_layout(name):
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.train import optimizers

    cfg = harness.config(name)
    a = dict(optimizers.flatten_params(
        weights.make_params(cfg["model"], 2 ** 31 + 5, "cpu")))
    b = dict(optimizers.flatten_params(
        weights.make_params(cfg["model"], 2 ** 31 + 5, "cpu")))
    c = dict(optimizers.flatten_params(
        weights.make_params(cfg["model"], 7, "cpu")))
    model = registry.build(schema.loads_pipeline(cfg["pbtxt"]).model,
                           device="cpu")
    want = dict(optimizers.flatten_params(model.init_params(0)))
    assert a.keys() == want.keys()
    assert all(a[k].shape == want[k].shape for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # The probe: the backbone's last drawn leaf of the second stage, a
    # normal truncated at two of its deviations.
    leaves, _ = ref.backbone(cfg["model"]).param_spec()
    path, std = [("/".join(p), std) for p, _, std in leaves
                 if p[0] == ref.SECOND_SCOPE and not isinstance(std, str)][-1]
    assert not torch.equal(a[path], c[path])
    assert float(a[path].abs().max()) <= 2 * std


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_are_the_seeds(cell):
    w = harness.find(BENCH["workloads"], cell, "workload")
    cfg, mix = small.config(w["config"]), small.mix(w["traffic"])

    def inputs(seed):
        if mix["driver"] == "train_step":
            batches = traffic.train_batches(mix, cfg, seed)
            sched = traffic.train_schedule(mix, cfg, seed, 3)
            return [v for b in batches.values() for x in b
                    for v in x.values()] + [np.array(sched)]
        return [v for e in traffic.eval_images(mix, cfg, seed)
                for v in e.values()]

    def same(a, b):
        return len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))

    seed = 2 ** 31 + 11
    assert same(inputs(seed), inputs(seed))
    assert not same(inputs(seed), inputs(seed + 1))


def test_every_seed_gets_the_same_sizes():
    cfg = harness.config("voc07_inc2")
    mix = harness.mix("eval_voc")
    sizes = [sorted((e["image"].shape, len(e["proposals"]))
                    for e in traffic.eval_images(mix, cfg, s))
             for s in (1, 2 ** 31 + 3)]
    assert sizes[0] == sizes[1]
    mix = harness.mix("train_buckets")
    counts = [sorted(traffic.train_schedule(mix, cfg, s, 1))
              for s in (1, 2 ** 31 + 3)]
    assert counts[0] == counts[1]
    canvases = [b[2] for b in traffic.train_buckets(cfg)]
    assert canvases == [(1216, 1824), (1824, 1216), (800, 1216),
                        (1216, 800), (608, 928), (928, 608), (416, 608),
                        (608, 416)]


SHIPPED = [(2, 500, 576, 14), (1, 2000, 576, 14)]
POOLS = [("pool_max", 3, 2, (n, 7, 7, 576)) for n in (1000, 2000)] + [
    (kind, 3, 1, (n, 4, 4, 1024)) for kind in ("pool_avg", "pool_max")
    for n in (1000, 2000)]


def test_frozen_formulas_equal_the_programs():
    import chip_smoke
    from cap2det_tpu_torch.kernels import fused_optimizer, nms, pool_grad
    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.tools import benchlib

    for b, p, c, s in SHIPPED:
        assert work.roi_forward_flops(b, p, c, s) == \
            roi_pool.forward_flops(b, p, c, s)
        assert work.roi_backward_flops(b, p, c, s) == \
            roi_pool.backward_flops(b, p, c, s)
    for kind, k, stride, shape in POOLS:
        assert work.pool_fwd_flops(shape, kind, k, stride) == \
            pool_grad.pool_fwd_flops(shape, kind, k, stride)
        assert work.pool_grad_flops(shape, k, stride) == \
            pool_grad.maxpool_grad_flops(shape, k, stride) == \
            pool_grad.avgpool_grad_flops(shape, k, stride)
    assert work.RULE_FLOPS == fused_optimizer._RULE_FLOPS
    for n_slots, numel in ((1, 7417427), (1, 6002951), (2, 10)):
        assert work.update_bytes(n_slots, numel) == \
            fused_optimizer.update_bytes(n_slots, numel)
    for b, p, c in ((1, 2000, 20), (1, 500, 80), (2, 500, 80)):
        assert work.nms_bytes(b, p, c) == nms.nms_bytes(b, p, c)
        assert b * p * c + work.IOU_FLOPS * 77 == nms.nms_flops(b, p, c, 77)
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.HBM_BYTES_PER_S[kind] == chip_smoke.HBM_BYTES_PER_S
    assert peaks.F32_FLOPS[kind] == chip_smoke.F32_OPS_PER_S
    assert peaks.BF16_PEAK_FLOPS[kind] == benchlib.BF16_PEAK_FLOPS[kind]
    for nbytes, ops in ((552000, 0), (10, 1.02e6 * 25), (7.4e7, 5e7)):
        assert peaks.least_ms(kind, nbytes, ops) == pytest.approx(
            chip_smoke.bound_ms(nbytes, ops)[0], rel=1e-12)


@pytest.mark.parametrize("name", sorted({w["config"] for w in
                                         BENCH["workloads"]}))
def test_model_flops_count_the_valid_proposals_only(name):
    """A unit's count at a number of valid proposals is the reference's
    count of a unit holding just those: padded rows are not counted."""
    cfg = harness.config(name)
    canvases = [b[2] for b in traffic.train_buckets(cfg)][:2]
    b = cfg["train"]["batch_size"]
    q = cfg["train"]["max_num_proposals"] // 3
    step = flops.train_step_flops(cfg, canvases)
    scale = flops.predict_flops(cfg, canvases)
    for hw in canvases:
        assert flops.unit_flops(step, hw, b * q) == pytest.approx(
            flops._train_step_flops(cfg, hw, q), rel=1e-12)
        assert flops.unit_flops(scale, hw, q) == pytest.approx(
            flops.predict_scale_flops(cfg, hw, q), rel=1e-12)
        assert step[hw][1] > 0 and scale[hw][1] > 0


def test_update_flops_equal_the_programs_at_both_trainable_sets():
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import fused_optimizer
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.train import optimizers

    for name in ("coco17_extend_match", "voc07_inc2"):
        cfg = harness.config(name)
        pipe = schema.loads_pipeline(cfg["pbtxt"])
        model = registry.build(pipe.model, device="cpu")
        params = weights.make_params(cfg["model"], 1, "cpu")
        tx, _, _ = optimizers.build_optimizer(
            pipe.train_config, params,
            non_trainable_paths=model.non_trainable_paths,
            non_trainable_substrings=model.non_trainable_substrings)
        got = work.WORK["fused_optimizer"][2](
            {"rule": tx.rule, "leaf_set": tx.leaf_set, "clip_norm": None},
            None)
        assert got == (fused_optimizer.update_bytes(1, tx.leaf_set.total),
                       fused_optimizer.update_flops(tx.rule, tx.leaf_set,
                                                    False))


def test_walk_pairs_equal_the_programs_walk_stats():
    from cap2det_tpu_torch.kernels import nms

    gen = torch.Generator().manual_seed(3)
    scores = torch.rand((1, 64, 5), generator=gen)
    boxes = torch.rand((1, 64, 2), generator=gen).repeat(1, 1, 2)
    boxes[..., 2:] += 0.3
    keep = nms.plain_nms_mask(boxes, scores, 0.2, 0.4, 7)
    assert work.walk_iou_pairs(scores, keep, 0.2, 7) == \
        nms.walk_stats(scores, keep, 0.2, 7)["iou_pairs"]


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def _strings(path):
    tree = ast.parse(Path(path).read_text())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


SOURCES = sorted(harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.ROOT))
                              for p in SOURCES])
def test_nothing_imports_jax_or_the_jax_package(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "cap2det_tpu"}
    if "reference" in path.parts:
        assert "cap2det_tpu_torch" not in top
        assert top <= {"__future__", "importlib", "numpy", "torch"}
    if not path.name.startswith("test_"):
        # Nothing at run time reads the root bench.py, tools/ or configs/.
        assert "chip_smoke" not in top and "bench" not in top
        for s in _strings(path):
            assert not re.match(r"^(\./)?(configs|tools)/|^bench\.py$", s)
        assert "cap2det_tpu_torch.tools" not in set(_imports(path))
        assert "cap2det_tpu_torch.bench" not in set(_imports(path))


def test_forbidden_names_compare_whole_top_level_names():
    assert "cap2det_tpu" in harness.FORBIDDEN
    assert "cap2det_tpu_torch".split(".")[0] not in harness.FORBIDDEN


def test_reference_equals_the_programs_plain_versions():
    """The reference's frozen copies give the bits of the plain versions
    the program's kernels are held to (K1's exact oracle, K2's
    fixed-point oracle, K4-K6's plain pools, the float64 softmax, the
    greedy NMS, the canvas resize)."""
    from cap2det_tpu_torch.data import pipeline
    from cap2det_tpu_torch.kernels import pool_grad
    from cap2det_tpu_torch.ops import nms, roi, softmax

    from benchmark.reference import faster_rcnn_inception_v2 as iv2

    gen = torch.Generator().manual_seed(5)
    feats = torch.randn((2, 9, 11, 16), generator=gen).to(torch.bfloat16)
    y, x = torch.rand((2, 2, 7, 2), generator=gen)
    boxes = torch.stack([y.min(-1).values, x.min(-1).values,
                         y.max(-1).values, x.max(-1).values], -1)
    grad = torch.randn((2, 7, 7, 7, 16), generator=gen).to(torch.bfloat16)
    assert torch.equal(ref.roi_crop_maxpool(feats, boxes, 14, 2, 2),
                       roi.crop_resize_maxpool_exact(feats, boxes, 14, 2, 2))
    assert torch.equal(
        ref.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2, 2),
        roi.crop_resize_maxpool_grad(feats, boxes, grad, 14, 2, 2,
                                     fixed_point=True))
    x = torch.randn((3, 7, 7, 8), generator=gen).to(torch.bfloat16)
    for kind, k, s in (("pool_max", 3, 2), ("pool_avg", 3, 1),
                       ("pool_max", 3, 1)):
        out = iv2.pool_same(x, kind, k, s)
        assert torch.equal(out, pool_grad.pool_same_plain(x, kind, k, s))
        g = torch.randn(out.shape, generator=gen).to(torch.bfloat16)
        if kind == "pool_max":
            assert torch.equal(iv2.maxpool_grad(x, g, k, s),
                               pool_grad.maxpool_grad_plain(x, g, k, s))
        else:
            assert torch.equal(
                iv2.avgpool_grad(x.shape, x.dtype, g, k, s),
                pool_grad.avgpool_grad_plain(x.shape, x.dtype, g, k, s))
    logits = torch.randn((1, 50, 21), generator=gen) * 4
    assert torch.equal(ref.softmax64(logits), softmax.softmax(logits))
    scores = torch.rand((1, 50, 6), generator=gen)
    props = torch.rand((1, 50, 2), generator=gen).repeat(1, 1, 2)
    props[..., 2:] += 0.25
    post = {"score_thresh": 0.1, "iou_thresh": 0.4, "max_size_per_class": 5,
            "max_total_size": 12}
    for a, b in zip(ref.multiclass_nms(props, scores, post),
                    nms.batch_multiclass_nms(props, scores, 0.1, 0.4, 5, 12)):
        assert torch.equal(a, b)
    image = torch.randint(0, 256, (37, 53, 3), generator=gen,
                          dtype=torch.uint8)
    assert torch.equal(ref.resize_bilinear_u8(image, 61, 80),
                       pipeline.resize_bilinear_u8(image, 61, 80))
    assert ref.compute_canvas(800) == pipeline.compute_canvas(800)
