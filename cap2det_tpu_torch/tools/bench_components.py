"""Stage-by-stage timing of the Cap2Det training step on the card (port of
``tools/bench_components.py``).

Times each stage of the bench workload (``cap2det_tpu_torch/bench.py``'s
step, batch, weights and shapes) on its own with CUDA events
(``benchlib.time_rounds``: the median over rounds, with their min and
max) and prints one JSON line per component, then a summary line. The
names are the JAX tool's, with ``pallas`` read as ``kernel`` (the
port's CUDA kernels) and ``xla`` as ``plain`` (their plain PyTorch
versions): train_step, first_stage_fwd, first_stage_fwdbwd_4e,
optimizer, roi_kernel_fwd, roi_kernel_fwdbwd (on the card only, as the
JAX tool runs its Pallas kernels on the TPU only), roi_plain_fwd,
roi_plain_fwdbwd, second_stage_fwd, second_stage_fwdbwd, features_fwd,
heads_fwdbwd, heads_fc_fwdbwd, heads_midn_fwdbwd, heads_oicr_assign_fwd
and heads_oicr_ce_fwdbwd.

The stages read weights that ``Cap2DetModel.prepare`` made once (the BN
fold, the cast), except the fwdbwd stages, which fold inside as the
training loss does; JAX's stages fold inside their jit.

    python -m cap2det_tpu_torch.tools.bench_components [--steps N]
        [--components a,b,...] [--proposals P] [--batch B] [--classes C]
        [--full_freeze] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cap2det_tpu_torch import bench
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

CANVAS_HW = (1024, 1536)
CROP = bench.CROP
ROUNDS = 3
COMPONENTS = ("train_step", "first_stage", "first_stage_fwdbwd_4e",
              "optimizer", "roi_kernel", "roi_plain", "second_stage",
              "features", "heads", "heads_parts")


def _trains(path):
    """Whether the step trains a leaf: never a BN's moving statistics
    (``Cap2DetModel.non_trainable_substrings``), which the fold takes as
    frozen."""
    from cap2det_tpu_torch.models import cap2det

    return not any(s in "/" + path for s in
                   cap2det.Cap2DetModel.non_trainable_substrings)


def _detached(tree, trainable):
    """(a copy of the nested dict `tree` whose leaves are detached,
    requiring grad where trainable(path), the list of those leaves). The
    empty dicts of parameterless branches stay."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + "/" + k if path else k)
                    for k, v in node.items()}
        leaf = node.detach().requires_grad_(trainable(path))
        if leaf.requires_grad:
            leaves.append(leaf)
        return leaf

    return walk(tree, ""), leaves


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=8,
                        help="calls per timed round")
    parser.add_argument("--components", default="",
                        help="comma-separated subset of %s" % (COMPONENTS,))
    parser.add_argument("--proposals", type=int, default=bench.NUM_PROPOSALS)
    parser.add_argument("--batch", type=int, default=bench.BATCH)
    parser.add_argument("--classes", type=int, default=bench.NUM_CLASSES)
    parser.add_argument(
        "--full_freeze", action="store_true",
        help="Freeze the whole first stage (the voc07_inc2 regime: no "
             "Mixed_4e re-enable), so train_step runs no ROI backward.")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.models import frcnn, inception_v2, wsod
    from cap2det_tpu_torch.ops import losses as loss_ops
    from cap2det_tpu_torch.ops import masked
    from cap2det_tpu_torch.ops import roi as roi_ops

    device = params_lib.resolve_device(args.device)
    cuda = device.type == "cuda"
    fields = benchlib.device_fields(device)
    want = set(args.components.split(",")) if args.components else None
    unknown = (want or set()) - set(COMPONENTS)
    if unknown:
        raise SystemExit("unknown components %s; choose from %s"
                         % (sorted(unknown), COMPONENTS))

    def enabled(name):
        return want is None or name in want

    batch_size, num_p, num_classes = args.batch, args.proposals, args.classes
    shape = dict(batch=batch_size, canvas_hw=CANVAS_HW, num_proposals=num_p,
                 num_classes=num_classes, full_freeze=args.full_freeze)
    step = bench.BenchStep(shape, device)
    model, state = step.model, step.state
    params = state["params"]
    fo = model.options.frcnn_options
    oicr_iterations = model.options.oicr_iterations
    with torch.no_grad():
        prepared = model.prepare(params)
    image, boxes = step.batch["image"], step.batch["proposals"]
    labels = step.batch["labels"]

    rs = np.random.RandomState(1)
    h, w = CANVAS_HW
    depth = inception_v2.FIRST_STAGE_DEPTH
    pooled = (CROP - 2) // 2 + 1

    def normal(shape, dtype):
        return torch.from_numpy(rs.normal(0, 1, shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    feat = normal((batch_size, h // 16, w // 16, depth), torch.bfloat16)
    rois = normal((batch_size * num_p, pooled, pooled, depth),
                  torch.bfloat16)
    prop_feats = normal((batch_size, num_p, 1024), torch.float32)

    results = {}

    def record(name, fn):
        timing = benchlib.time_rounds(fn, device, args.steps, ROUNDS)
        results[name] = timing["ms"]
        benchlib.json_line({"component": name, **timing, **fields})

    if enabled("train_step"):
        record("train_step", step.run)

    if enabled("first_stage"):
        def first():
            with torch.no_grad():
                return inception_v2.first_stage(
                    prepared[frcnn.FIRST_SCOPE],
                    inception_v2.preprocess(image.float()))
        record("first_stage_fwd", first)

    # The first stage's forward and Mixed_4e's gradients, all below it
    # frozen: what the bench step pays for its first stage.
    if enabled("first_stage_fwdbwd_4e"):
        def first_4e():
            tree, leaves = _detached(params[frcnn.FIRST_SCOPE],
                                     lambda path: "/Mixed_4e/" in path
                                     and _trains(path))
            out = inception_v2.first_stage(
                inception_v2.prepare(tree, step.compute_dtype),
                inception_v2.preprocess(image.float()))
            return torch.autograd.grad(out.float().sum(), leaves)
        record("first_stage_fwdbwd_4e", first_4e)

    if enabled("optimizer"):
        from cap2det_tpu_torch.train import optimizers

        zeros = {path: torch.zeros_like(leaf) for path, leaf
                 in optimizers.flatten_params(params) if leaf.requires_grad}
        record("optimizer", lambda: step.tx.apply(params, zeros,
                                                  state["opt_state"]))

    def roi_fwdbwd(fn):
        def run():
            f = feat.detach().requires_grad_(True)
            out = fn(f, boxes, CROP, 2, 2)
            # Nonlinear in the output, as the JAX tool's loss is.
            return torch.autograd.grad((out.float() ** 2).sum(), f)
        return run

    if enabled("roi_kernel") and cuda:
        record("roi_kernel_fwd", lambda: roi_pool.roi_crop_maxpool(
            feat, boxes, CROP, 2, 2))
        record("roi_kernel_fwdbwd", roi_fwdbwd(roi_pool.roi_crop_maxpool))

    if enabled("roi_plain"):
        record("roi_plain_fwd", lambda: roi_ops.crop_resize_maxpool(
            feat, boxes, CROP, 2, 2))
        record("roi_plain_fwdbwd", roi_fwdbwd(roi_ops.crop_resize_maxpool))

    if enabled("second_stage"):
        def second():
            with torch.no_grad():
                return inception_v2.second_stage(
                    prepared[frcnn.SECOND_SCOPE], rois)
        record("second_stage_fwd", second)

        def second_fwdbwd():
            tree, leaves = _detached(params[frcnn.SECOND_SCOPE], _trains)
            out = inception_v2.second_stage(
                inception_v2.prepare(tree, step.compute_dtype), rois)
            return torch.autograd.grad(out.float().sum(), leaves)
        record("second_stage_fwdbwd", second_fwdbwd)

    if enabled("features"):
        def features():
            with torch.no_grad():
                return frcnn.extract_features(prepared, image, boxes, fo,
                                              is_training=False)
        record("features_fwd", features)

    num = step.batch["num_proposals"]
    heads = {"midn": params["midn"], "oicr": params["oicr"]}

    if enabled("heads"):
        def heads_fwdbwd():
            hp, leaves = _detached(heads, lambda path: True)
            mask = masked.sequence_mask(num, maxlen=num_p)
            class_logits, _, proba = wsod.midn_head(hp["midn"], prop_feats,
                                                    mask)
            total = loss_ops.sigmoid_cross_entropy(labels,
                                                   class_logits).mean()
            scores_0 = torch.cat([torch.zeros_like(proba[..., :1]), proba],
                                 dim=-1)
            for i in range(oicr_iterations):
                scores_1 = wsod.fc(hp["oicr"]["iter%d" % (i + 1)], prop_feats)
                total = total + 0.5 * wsod.oicr_loss(
                    labels, boxes, scores_0, scores_1, mask,
                    iou_threshold=0.6)
                scores_0 = torch.softmax(scores_1, dim=-1)
            return torch.autograd.grad(total, leaves)
        record("heads_fwdbwd", heads_fwdbwd)

    if enabled("heads_parts"):
        pmask = torch.ones((batch_size, num_p), device=device)
        scores_prev = torch.from_numpy(rs.rand(
            batch_size, num_p, 1 + num_classes).astype(np.float32)).to(device)
        scores_next = normal((batch_size, num_p, 1 + num_classes),
                             torch.float32)

        def fc_fwdbwd():
            pf = prop_feats.detach().requires_grad_(True)
            total = (wsod.fc(heads["midn"]["proba_r_given_c"], pf).sum()
                     + wsod.fc(heads["midn"]["proba_c_given_r"], pf).sum())
            for i in range(oicr_iterations):
                total = total + wsod.fc(heads["oicr"]["iter%d" % (i + 1)],
                                        pf).sum()
            return torch.autograd.grad(total, pf)
        record("heads_fc_fwdbwd", fc_fwdbwd)

        def midn_fwdbwd():
            pf = prop_feats.detach().requires_grad_(True)
            logits, _, _ = wsod.midn_head(heads["midn"], pf, pmask)
            loss = loss_ops.sigmoid_cross_entropy(labels, logits).mean()
            return torch.autograd.grad(loss, pf)
        record("heads_midn_fwdbwd", midn_fwdbwd)

        def assign():
            with torch.no_grad():
                return wsod.oicr_target_assignment(labels, boxes,
                                                   scores_prev, pmask, 0.6)
        record("heads_oicr_assign_fwd", assign)

        targets = assign()

        def ce_fwdbwd():
            sn = scores_next.detach().requires_grad_(True)
            ce = loss_ops.softmax_cross_entropy(targets, sn)
            loss = masked.masked_avg(ce, pmask, dim=1).mean()
            return torch.autograd.grad(loss, sn)
        record("heads_oicr_ce_fwdbwd", ce_fwdbwd)

    benchlib.json_line({"summary": results, **fields})
    return results


if __name__ == "__main__":
    main()
