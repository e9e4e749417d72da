"""Plain Cap2Det: the Faster-RCNN split around a backbone found by name,
the ROI crop and pool, MIDN and OICR heads, their losses, multi-scale
prediction and class-wise greedy NMS, in plain PyTorch operations.

A frozen copy of the plain versions the measured program keeps beside
its kernels, written against the benchmark's own configuration values:
TF SAME padding, frozen BatchNorm folded into each convolution (eps
1e-3), the ROI crop with TF ``crop_and_resize`` sampling and a VALID
max-pool; the heads, losses and the float64 softmax of the postprocess.
Convolutions run in the dtype the configuration states for them; the
rest in float32, or in ``head_dtype`` where a caller asks for a lower
precision (the comparison's control).

The backbone is ``benchmark/reference/<model["feature_extractor"]>.py``
(``backbone``). It defines ``FEATURE_DIM`` (the width of the pooled
proposal features), ``param_spec()`` (its leaves in both scopes, and
its empty branches), ``dense_weights(node)`` (the dense kernel of a
convolution node that holds no plain ``weights``, or None),
``preprocess(images)``, ``first_stage(folded, images)`` and
``second_stage(folded, rois)``.

Weights are a nested dict of tensors in PyTorch layout (convolutions
OIHW, fully connected [out, in]); ``param_spec`` lists them.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPSILON = 0.001
FIRST_SCOPE = "first_stage_feature_extraction"
SECOND_SCOPE = "second_stage_feature_extraction"


def backbone(model):
    """The reference's backbone module that the configuration names."""
    name = model["feature_extractor"]
    module = "%s.%s" % (__package__, name)
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            "no reference backbone for feature_extractor %r: "
            "benchmark/reference/%s.py is missing" % (name, name),
            name=module) from None


# ---------------------------------------------------------------------------
# The weights: names, shapes and their initial distributions
# ---------------------------------------------------------------------------


def bn_leaves(prefix, cout):
    """The frozen BatchNorm leaves of the convolution at `prefix`."""
    return [(prefix + ("BatchNorm", "beta"), (cout,), "zeros"),
            (prefix + ("BatchNorm", "moving_mean"), (cout,), "zeros"),
            (prefix + ("BatchNorm", "moving_variance"), (cout,), "ones")]


def conv_leaves(prefix, cout, cin, k):
    """A k x k convolution's He-scaled weights and its BatchNorm."""
    return ([(prefix + ("weights",), (cout, cin, k, k),
              (2.0 / (k * k * cin)) ** 0.5)] + bn_leaves(prefix, cout))


def param_spec(model):
    """([(path, shape, init)], [path of an empty pool-only branch]): the
    backbone's leaves, then the heads over its ``FEATURE_DIM``.

    ``init`` is "zeros", "ones", or the standard deviation of a normal
    truncated at two deviations: sqrt(2 / fan_in) for a convolution (He),
    ``model["fc_stddev"]`` for a fully connected layer."""
    net = backbone(model)
    features = net.FEATURE_DIM
    num_classes, fc_stddev = model["num_classes"], model["fc_stddev"]
    leaves, empty = net.param_spec()
    for name in ("proba_r_given_c", "proba_c_given_r"):
        leaves += [(("midn", name, "weights"), (num_classes, features),
                    fc_stddev),
                   (("midn", name, "biases"), (num_classes,), "zeros")]
    for i in range(model["oicr_iterations"]):
        key = "iter%d" % (i + 1)
        leaves += [(("oicr", key, "weights"), (1 + num_classes, features),
                    fc_stddev),
                   (("oicr", key, "biases"), (1 + num_classes,), "zeros")]
    return leaves, empty


def nest(paths_values, empty=()):
    """A nested dict from [(path tuple, value)], with `empty` branches as
    empty dicts."""
    out = {}
    for path in empty:
        node = out
        for key in path:
            node = node.setdefault(key, {})
    for path, value in paths_values:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def flatten(tree, prefix=""):
    """[(path string, leaf)] with keys sorted at every level."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        path = prefix + str(key)
        if isinstance(value, dict):
            out.extend(flatten(value, path + "/"))
        else:
            out.append((path, value))
    return out


# ---------------------------------------------------------------------------
# Convolutions: the BN fold and TF SAME padding
# ---------------------------------------------------------------------------


def same_pads(size, kernel, stride):
    """(out, pad_before, pad_after) of TF SAME padding along one axis."""
    out = -(-size // stride)
    pad_total = max((out - 1) * stride + kernel - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def fold_bn(w, bn, dtype):
    """A convolution's frozen BatchNorm folded into its weights `w` and a
    bias, in `dtype`."""
    inv = torch.rsqrt(bn["moving_variance"] + BN_EPSILON)
    w = (w * inv[:, None, None, None]).to(dtype)
    return {"weight": w.contiguous(memory_format=torch.channels_last),
            "bias": (bn["beta"] - bn["moving_mean"] * inv).to(dtype)}


def fold(params, dtype, dense_weights):
    """Every convolution's frozen BatchNorm folded into its weights and
    bias in `dtype`. A node is a convolution where it holds ``weights``,
    or where `dense_weights` (the backbone's) composes it into one dense
    kernel."""
    out = {}
    for key, value in params.items():
        w = dense_weights(value)
        if w is None and "weights" in value:
            w = value["weights"]
        out[key] = (fold(value, dtype, dense_weights) if w is None
                    else fold_bn(w, value["BatchNorm"], dtype))
    return out


def conv_relu(conv, x, stride):
    """ReLU of a folded convolution of NCHW x with TF SAME padding."""
    w = conv["weight"]
    k = w.shape[-1]
    _, pt, pb = same_pads(x.shape[2], k, stride)
    _, pl, pr = same_pads(x.shape[3], k, stride)
    padding = (pt, pl)
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = 0
    out = F.conv2d(x.to(w.dtype), w, conv["bias"], stride=stride,
                   padding=padding)
    return torch.relu_(out)


# ---------------------------------------------------------------------------
# ROI crop (TF crop_and_resize sampling) + VALID max-pool
# ---------------------------------------------------------------------------

_CHUNK_BYTES = 256 * 1024 * 1024


def _sample_coords(starts, ends, crop_size, extent):
    h_max = float(extent - 1)
    if crop_size > 1:
        i = torch.arange(crop_size, dtype=torch.float32, device=starts.device)
        step = i * (ends - starts)[..., None]
        step = step * h_max / torch.tensor(float(crop_size - 1),
                                           device=starts.device)
        coords = starts[..., None] * h_max + step
    else:
        coords = ((starts + ends) * 0.5 * h_max)[..., None]
    inside = ((coords >= 0.0) & (coords <= h_max)).float()
    idx = torch.clamp(torch.floor(coords), 0.0, float(extent - 2))
    frac = (coords - idx) * inside
    return idx.long(), (1.0 - frac) * inside, frac * inside


def _sample_grid(features, boxes, crop_size):
    batch, height, width, _ = features.shape
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    yi, ya, yb = _sample_coords(y1, y2, crop_size, height)
    xi, xa, xb = _sample_coords(x1, x2, crop_size, width)
    bi = torch.arange(batch, device=features.device)[:, None, None, None]
    rows = (yi[..., :, None], yi[..., :, None] + 1)
    cols = (xi[..., None, :], xi[..., None, :] + 1)
    wy = (ya[..., :, None, None], yb[..., :, None, None])
    wx = (xa[..., None, :, None], xb[..., None, :, None])
    return bi, rows, cols, wy, wx


def _crop_samples(features, boxes, crop_size):
    bi, rows, cols, wy, wx = _sample_grid(features, boxes, crop_size)

    def corner(r, c):
        return features[bi, rows[r], cols[c]].float()

    t0 = corner(0, 0) * wy[0] + corner(1, 0) * wy[1]
    t1 = corner(0, 1) * wy[0] + corner(1, 1) * wy[1]
    return t0 * wx[0] + t1 * wx[1]


def _max_pool_valid(x, kernel, stride):
    h, w = x.shape[-3:-1]
    out_h = (h - kernel) // stride + 1
    out_w = (w - kernel) // stride + 1
    acc = None
    for i in range(kernel):
        for j in range(kernel):
            view = x[..., i:i + (out_h - 1) * stride + 1:stride,
                     j:j + (out_w - 1) * stride + 1:stride, :]
            acc = view if acc is None else torch.maximum(acc, view)
    return acc


def roi_crop_maxpool(features, boxes, crop_size, pool_kernel, pool_stride):
    """[B, H, W, C] features, [B, P, 4] normalized boxes -> pooled crops
    [B, P, S', S', C] in the features' dtype, chunked over proposals."""
    channels = features.shape[-1]
    chunk = max(1, _CHUNK_BYTES // (6 * crop_size * crop_size * channels * 4))
    outs = [_max_pool_valid(_crop_samples(features, boxes[:, p:p + chunk],
                                          crop_size), pool_kernel,
                            pool_stride)
            for p in range(0, boxes.shape[1], chunk)]
    return torch.cat(outs, dim=1).to(features.dtype)


# The backward's sums in 64-bit fixed point, units of 2^-32: exact, so
# the same in every run and in any order of the proposals.
FIXED_SCALE = 2.0 ** 32


def _roi_grad_chunk(features, boxes, grad, dfeat, crop_size, pool_kernel,
                    pool_stride):
    """Adds one chunk of proposals' dF into dfeat [B*H*W, C] int64: each
    pooled gradient to the first maximal crop sample of its window
    (row-major), then (g * wy) * wx to each of the sample's four taps,
    every contribution rounded to 2^-32 on its own."""
    _, height, width, _ = features.shape
    bi, rows, cols, wy, wx = _sample_grid(features, boxes, crop_size)
    channels = dfeat.shape[-1]
    samples = _crop_samples(features, boxes, crop_size)
    pooled = grad.shape[2]
    span = (pooled - 1) * pool_stride + 1
    taps = [(slice(i, i + span, pool_stride), slice(j, j + span, pool_stride))
            for i in range(pool_kernel) for j in range(pool_kernel)]
    views = [samples[..., ti, tj, :] for ti, tj in taps]
    best = views[0]
    for v in views[1:]:
        best = torch.maximum(best, v)
    gf = grad.float()
    taken = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    for (ti, tj), v in zip(taps, views):
        hit = (v >= best) & ~taken
        taken |= hit
        g_tap = gf * hit
        for r in (0, 1):
            dy = g_tap * wy[r][..., ti, :, :]
            for c in (0, 1):
                contribution = dy * wx[c][..., tj, :]
                q = torch.round(contribution * FIXED_SCALE).long()
                flat = ((bi * height + rows[r][..., ti, :]) * width
                        + cols[c][..., tj])
                dfeat.index_add_(
                    0, flat.expand(contribution.shape[:-1]).reshape(-1),
                    q.reshape(-1, channels))


def roi_crop_maxpool_grad(features, boxes, grad, crop_size, pool_kernel,
                          pool_stride):
    """dF of ``roi_crop_maxpool`` in the features' dtype, summed exactly in
    fixed point and converted once (times 2^-32 in float32)."""
    batch, height, width, channels = features.shape
    dfeat = torch.zeros((batch * height * width, channels),
                        dtype=torch.int64, device=features.device)
    chunk = max(1, _CHUNK_BYTES // (10 * crop_size * crop_size * channels * 4))
    for p in range(0, boxes.shape[1], chunk):
        _roi_grad_chunk(features, boxes[:, p:p + chunk],
                        grad[:, p:p + chunk], dfeat, crop_size, pool_kernel,
                        pool_stride)
    dfeat = dfeat.to(torch.float32) * (1.0 / FIXED_SCALE)
    return dfeat.reshape(features.shape).to(features.dtype)


class _RoiCropMaxpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, boxes, crop_size, pool_kernel, pool_stride):
        ctx.conf = (crop_size, pool_kernel, pool_stride)
        ctx.save_for_backward(features, boxes)
        if features.is_meta:  # shapes only: the FLOP count's pass
            s = (crop_size - pool_kernel) // pool_stride + 1
            return features.new_empty((*boxes.shape[:2], s, s,
                                       features.shape[-1]))
        return roi_crop_maxpool(features, boxes, crop_size, pool_kernel,
                                pool_stride)

    @staticmethod
    def backward(ctx, grad):
        features, boxes = ctx.saved_tensors
        if features.is_meta:
            return features.new_empty(features.shape), None, None, None, None
        return (roi_crop_maxpool_grad(features, boxes, grad.contiguous(),
                                      *ctx.conf), None, None, None, None)


# ---------------------------------------------------------------------------
# Features, heads, losses
# ---------------------------------------------------------------------------


def sequence_mask(lengths, maxlen):
    rng = torch.arange(maxlen, device=lengths.device)
    return (rng < lengths[..., None]).to(torch.float32)


def dropout(x, keep_prob, generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    divisor = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros_like(x))


def extract_features(folded, images, proposals, model, is_training=False,
                     generator=None, mean_dtype=torch.float32):
    """[B, P, FEATURE_DIM] pooled proposal features in `mean_dtype`."""
    net = backbone(model)
    batch, num_p = proposals.shape[:2]
    keep_prob = model["dropout_keep_prob"]
    features = net.first_stage(folded[FIRST_SCOPE],
                               net.preprocess(images))
    if is_training and model["dropout_on_feature_map"]:
        features = dropout(features, keep_prob, generator)
    rois = _RoiCropMaxpool.apply(features, proposals.float().contiguous(),
                                 model["initial_crop_size"],
                                 model["maxpool_kernel_size"],
                                 model["maxpool_stride"])
    s = rois.shape[2]
    rois = rois.reshape(batch * num_p, s, s, rois.shape[-1])
    box_features = net.second_stage(folded[SECOND_SCOPE], rois)
    pooled = box_features.to(mean_dtype).mean(dim=(1, 2))
    if is_training and keep_prob < 1.0:
        pooled = dropout(pooled, keep_prob, generator)
    return pooled.reshape(batch, num_p, -1)


def _fc(p, x):
    return F.linear(x, p["weights"].to(x.dtype), p["biases"].to(x.dtype))


def midn_head(params, features, proposal_mask):
    mask = proposal_mask[..., None]
    logits_r_given_c = _fc(params["proba_r_given_c"], features)
    logits_c_given_r = _fc(params["proba_c_given_r"], features)
    proba_r_given_c = torch.softmax(mask * logits_r_given_c
                                    - 1e10 * (1.0 - mask), dim=1)
    proba_r_given_c = mask * proba_r_given_c
    class_logits = torch.sum(logits_c_given_r * proba_r_given_c * mask,
                             dim=1)
    proposal_scores = torch.sigmoid(class_logits)[:, None, :] * proba_r_given_c
    return class_logits, proposal_scores, proba_r_given_c


def pairwise_iou(boxes1, boxes2):
    ymin1, xmin1, ymax1, xmax1 = boxes1[..., :, None, :].unbind(-1)
    ymin2, xmin2, ymax2, xmax2 = boxes2[..., None, :, :].unbind(-1)
    ih = (torch.minimum(ymax1, ymax2)
          - torch.maximum(ymin1, ymin2)).clamp_min(0.0)
    iw = (torch.minimum(xmax1, xmax2)
          - torch.maximum(xmin1, xmin2)).clamp_min(0.0)
    inter = ih * iw
    a1 = (ymax1 - ymin1).clamp_min(0.0) * (xmax1 - xmin1).clamp_min(0.0)
    a2 = (ymax2 - ymin2).clamp_min(0.0) * (xmax2 - xmin2).clamp_min(0.0)
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(union))


def oicr_targets(labels, proposals, scores_prev, proposal_mask,
                 iou_threshold):
    """[B, P, 1+C] row-normalized pseudo labels of one refinement: each
    labelled class's most confident proposal and those overlapping it by
    at least the threshold; background where no class fires."""
    data = scores_prev[:, :, 1:]
    mask = proposal_mask[..., None]
    axis_min = data.amin(dim=1, keepdim=True)
    seed_idx = torch.argmax((data - axis_min) * mask, dim=1)  # [B, C]
    seed_boxes = torch.gather(proposals, 1,
                              seed_idx[..., None].expand(-1, -1, 4))
    iou = pairwise_iou(proposals, seed_boxes)
    target = (iou >= iou_threshold).float() * (labels[:, None, :] > 0)
    bkg = (target.sum(dim=-1, keepdim=True) <= 0).float()
    proposal_labels = torch.cat([bkg, target], dim=-1)
    return proposal_labels / proposal_labels.sum(dim=-1, keepdim=True)


def sigmoid_cross_entropy(labels, logits):
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def oicr_loss(labels, proposals, scores_prev, scores_next, proposal_mask,
              iou_threshold):
    targets = oicr_targets(labels, proposals, scores_prev.detach().float(),
                           proposal_mask, iou_threshold)
    targets = targets.detach().to(scores_next.dtype)
    ce = -torch.sum(targets * torch.log_softmax(scores_next, dim=-1), dim=-1)
    mask = proposal_mask.to(ce.dtype)
    sums = torch.sum(ce * mask, dim=1, keepdim=True)
    counts = torch.sum(mask, dim=1, keepdim=True).clamp_min(1e-10)
    return (sums / counts).squeeze(1).mean()


def predictions(params, folded, images, proposals, num_proposals, model,
                is_training=False, generator=None,
                head_dtype=torch.float32):
    """The MIDN and OICR scores of a batch, the heads in `head_dtype`."""
    mask = sequence_mask(num_proposals, proposals.shape[1])
    features = extract_features(folded, images, proposals, model,
                                is_training, generator, head_dtype)
    hmask = mask.to(head_dtype)
    class_logits, proposal_scores, proba = midn_head(params["midn"],
                                                     features, hmask)
    preds = {"midn_class_logits": class_logits,
             "midn_proba_r_given_c": proba,
             "oicr_proposal_scores_at_0": proposal_scores,
             "proposal_mask": mask}
    for i in range(model["oicr_iterations"]):
        preds["oicr_proposal_scores_at_%d" % (i + 1)] = _fc(
            params["oicr"]["iter%d" % (i + 1)], features)
    return preds


def fold_all(params, model, conv_dtype):
    """The tree the forward reads: both stages folded, heads as they are."""
    dense = backbone(model).dense_weights
    return {**params, **{scope: fold(params[scope], conv_dtype, dense)
                         for scope in (FIRST_SCOPE, SECOND_SCOPE)}}


def loss(params, batch, model, generator, conv_dtype=torch.bfloat16,
         head_dtype=torch.float32):
    """The training loss of a batch {"image" [B,H,W,3] uint8, "proposals"
    [B,P,4], "num_proposals" [B], "labels" [B,C]}: MIDN sigmoid CE, each
    OICR refinement's CE against detached targets, the heads' L2."""
    preds = predictions(params, fold_all(params, model, conv_dtype),
                        batch["image"], batch["proposals"],
                        batch["num_proposals"], model, True, generator,
                        head_dtype)
    labels = batch["labels"].float().to(head_dtype)
    mask = preds["proposal_mask"]
    proposals = batch["proposals"].float()
    terms = [sigmoid_cross_entropy(labels, preds["midn_class_logits"]).mean()
             * model["midn_loss_weight"]]
    scores_0 = preds["oicr_proposal_scores_at_0"]
    if model["oicr_use_proba_r_given_c"]:
        scores_0 = preds["midn_proba_r_given_c"]
    scores_0 = torch.cat([torch.zeros_like(scores_0[..., :1]), scores_0], -1)
    for i in range(model["oicr_iterations"]):
        scores_1 = preds["oicr_proposal_scores_at_%d" % (i + 1)]
        terms.append(oicr_loss(labels.float(), proposals, scores_0, scores_1,
                               mask, model["oicr_iou_threshold"])
                     * model["oicr_loss_weight"])
        scores_0 = torch.softmax(scores_1, dim=-1)
    total = sum(terms)
    if model["fc_l2"] > 0:
        reg = 0.0
        for path, leaf in flatten({"midn": params["midn"],
                                   "oicr": params["oicr"]}):
            if path.endswith("weights"):
                reg = reg + torch.sum(torch.square(leaf.to(head_dtype)))
        total = total + model["fc_l2"] * 0.5 * reg
    return total.float()


# ---------------------------------------------------------------------------
# Training: the step and the update
# ---------------------------------------------------------------------------


def step_seed(seed, step):
    """The seed of a step's dropout generator: a function of (seed,
    step) only."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def multiplier(path, multipliers):
    value = None
    for scope, mult in multipliers:
        if path.startswith(scope):
            value = mult
    return value


def trainable(path, multipliers):
    """The gradient multiplier of a trainable leaf, or None when frozen
    (a multiplier of 0, or a BatchNorm moving statistic)."""
    mult = multiplier(path, multipliers)
    if "/BatchNorm/moving_" in path or mult == 0.0:
        return None
    return 1.0 if mult is None else float(mult)


class AdagradTrainer:
    """The configuration's update over the trainable leaves of `params`
    (updated in place): each gradient times its multiplier, the squares
    summed into an accumulator from `initial_accumulator_value`, the step
    -lr * g * rsqrt(sum + 1e-7). It starts from `accumulators` and at step
    `count` where given (a state that a run has reached), else from the
    initial value at step 0."""

    def __init__(self, params, train, model, conv_dtype=torch.bfloat16,
                 head_dtype=torch.float32, accumulators=None, count=0):
        self.params = params
        self.train = train
        self.model = model
        self.conv_dtype = conv_dtype
        self.head_dtype = head_dtype
        multipliers = [tuple(m) for m in train["gradient_multipliers"]]
        self.leaves = []
        for path, leaf in flatten(params):
            mult = trainable(path, multipliers)
            leaf.requires_grad_(mult is not None)
            if mult is not None:
                self.leaves.append((path, leaf, mult))
        self.accumulators = {
            path: (torch.full_like(leaf, train["initial_accumulator_value"])
                   if accumulators is None else accumulators[path])
            for path, leaf, _ in self.leaves}
        self.count = count
        self.first_grad_norms = None

    def step(self, batch, seed):
        generator = torch.Generator(device=batch["image"].device)
        generator.manual_seed(step_seed(seed, self.count))
        total = loss(self.params, batch, self.model, generator,
                     self.conv_dtype, self.head_dtype)
        grads = torch.autograd.grad(total, [leaf for _, leaf, _ in
                                            self.leaves], allow_unused=True)
        if self.first_grad_norms is None:
            self.first_grad_norms = {
                path: 0.0 if g is None else float(torch.linalg.vector_norm(
                    g.double()))
                for (path, _, _), g in zip(self.leaves, grads)}
        lr = self.train["learning_rate"]
        with torch.no_grad():
            for (path, leaf, mult), g in zip(self.leaves, grads):
                g = torch.zeros_like(leaf) if g is None else g.float()
                if mult != 1.0:
                    g = g * mult
                sos = g * g + self.accumulators[path]
                self.accumulators[path] = sos
                scale = torch.where(sos > 0, torch.rsqrt(sos + 1e-7),
                                    torch.zeros_like(sos))
                leaf.add_(((scale * g) * -lr).to(leaf.dtype))
        self.count += 1
        return float(total.detach())


# ---------------------------------------------------------------------------
# Multi-scale prediction and the postprocess
# ---------------------------------------------------------------------------


def _round_up(x, m):
    return int(-(-x // m) * m)


def compute_canvas(min_dimension, scale=1.0, aspect_cap=1.5, multiple=32):
    """(short side, long side) of a scale bucket's fixed canvas."""
    short = _round_up(round(min_dimension * scale), multiple)
    long = _round_up(round(min_dimension * scale * aspect_cap), multiple)
    return short, long


def _linear_coeffs(src, dst, clamp_weights, device):
    scale = 1.0 / (dst / src)
    pos = ((torch.arange(dst, dtype=torch.float64, device=device) + 0.5)
           * scale - 0.5).to(torch.float32)
    first = torch.floor(pos)
    frac = pos - first
    first = first.to(torch.int64)
    if clamp_weights:
        low, high = first < 0, first >= src - 1
        first = torch.where(low, 0, torch.where(high, src - 1, first))
        frac = torch.where(low | high, 0.0, frac)
    w1 = torch.round(frac * 2048)
    w0 = torch.round((1.0 - frac) * 2048)
    return (first.clamp(0, src - 1), (first + 1).clamp(0, src - 1),
            w0.to(torch.int32), w1.to(torch.int32))


def resize_bilinear_u8(image, new_h, new_w):
    """[H, W, C] uint8 -> [new_h, new_w, C] uint8 with cv2.INTER_LINEAR's
    fixed-point arithmetic."""
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, new_w, True, image.device)
    y0, y1, b0, b1 = _linear_coeffs(h, new_h, False, image.device)
    src = image.to(torch.int32)
    rows = (src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]) >> 4
    out = ((rows[y0] * b0[:, None, None]) >> 16) + (
        (rows[y1] * b1[:, None, None]) >> 16)
    return ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)


def fit_image_to_canvas(image, canvas_hw):
    ch, cw = canvas_hw
    h, w = image.shape[:2]
    scale = min(min(ch, cw) / min(h, w), ch / h, cw / w)
    new_h = max(1, min(ch, int(round(h * scale))))
    new_w = max(1, min(cw, int(round(w * scale))))
    canvas = torch.zeros((ch, cw, 3), dtype=torch.uint8, device=image.device)
    canvas[:new_h, :new_w] = resize_bilinear_u8(image, new_h, new_w)
    return canvas, (new_h, new_w)


_INV_LN2 = 1.44269504088896338700e+00
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_TAYLOR = [1.0]
for _n in range(1, 14):
    _TAYLOR.append(_TAYLOR[-1] / _n)
_TAYLOR.reverse()


def softmax64(logits):
    """float32 softmax over the last axis, computed in float64 by basic
    operations in a fixed order (the same bits on every device)."""
    x = logits.to(torch.float64)
    x = (x - x.max(dim=-1, keepdim=True).values).clamp_min(-110.0)
    k = torch.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, _TAYLOR[0])
    for c in _TAYLOR[1:]:
        p = p * r + c
    e = p * ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    total = e[..., 0]
    for c in range(1, e.shape[-1]):
        total = total + e[..., c]
    return (e / total[..., None]).to(torch.float32)


def _per_image_nms(boxes, scores, iou_thresh, score_thresh, max_per_class):
    num_p, _ = scores.shape
    iou = pairwise_iou(boxes, boxes)
    order = torch.argsort(-scores.T, dim=-1, stable=True)
    keep = torch.gather(scores.T > score_thresh, 1, order)
    overlap = iou[order[:, :, None], order[:, None, :]] > iou_thresh
    overlap &= torch.ones(num_p, num_p, dtype=torch.bool,
                          device=boxes.device).triu_(1)
    for i in range(num_p):
        keep &= ~(overlap[:, i, :] & keep[:, i:i + 1])
    keep &= torch.cumsum(keep, dim=1) <= max_per_class
    out = torch.zeros_like(keep)
    out.scatter_(1, order, keep)
    return out.T


def multiclass_nms(boxes, scores, post):
    """Greedy per-class NMS, the per-class cap, then each image's global
    top-``max_total_size`` by score (ties to the lower flat index);
    1-based classes."""
    selected = torch.stack([
        _per_image_nms(b, s, post["iou_thresh"], post["score_thresh"],
                       post["max_size_per_class"])
        for b, s in zip(boxes, scores)])
    num_b, num_p, num_c = scores.shape
    max_total = post["max_total_size"]
    neg_inf = torch.tensor(-float("inf"), dtype=scores.dtype,
                           device=scores.device)
    flat = torch.where(selected, scores, neg_inf).reshape(num_b, -1)
    k = min(max_total, num_p * num_c)
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    box_idx, class_idx = top_idx // num_c, top_idx % num_c
    det_boxes = torch.gather(boxes, 1, box_idx[..., None].expand(-1, -1, 4))
    valid = torch.isfinite(top_scores)
    det_scores = torch.where(valid, top_scores, 0.0)
    det_classes = torch.where(valid, class_idx.to(scores.dtype) + 1.0, 0.0)
    det_boxes = torch.where(valid[..., None], det_boxes, 0.0)
    num = valid.sum(dim=-1).to(torch.int32)
    pad = max_total - k
    if pad:
        det_boxes = F.pad(det_boxes, (0, 0, 0, pad))
        det_scores = F.pad(det_scores, (0, pad))
        det_classes = F.pad(det_classes, (0, pad))
    return num, det_boxes, det_scores, det_classes


def postprocess(score_mean, proposals, num_proposals, model):
    """Detections of each OICR iteration from the mean scores: iteration
    0 as scored by MIDN, later ones through the softmax less the
    background; padded proposals zeroed."""
    valid = sequence_mask(num_proposals, proposals.shape[1])[:, :, None]
    out = {}
    for i in range(1 + model["oicr_iterations"]):
        scores = score_mean["oicr_proposal_scores_at_%d" % i]
        post = model["midn_post"] if i == 0 else model["oicr_post"]
        if i:
            scores = softmax64(scores)[:, :, 1:]
        scores = scores * valid
        num, boxes, det_scores, classes = multiclass_nms(proposals, scores,
                                                         post)
        out["num_detections_at_%d" % i] = num
        out["detection_boxes_at_%d" % i] = boxes
        out["detection_scores_at_%d" % i] = det_scores
        out["detection_classes_at_%d" % i] = classes
    return out


def score_mean(params, folded, image, proposals_true, model, evaluation,
               head_dtype=torch.float32):
    """Each OICR iteration's proposal scores averaged over the
    evaluation scales, for one decoded image [H, W, 3] uint8 on the device
    and its true-image-normalized proposals [n, 4]: (means, the padded
    proposals [1, P, 4], the number of valid ones [1])."""
    dev = image.device
    h, w = image.shape[:2]
    max_p = evaluation["max_num_proposals"]
    n = min(len(proposals_true), max_p)
    props = torch.zeros((max_p, 4), dtype=torch.float32, device=dev)
    props[:n] = torch.as_tensor(np.asarray(proposals_true[:n], np.float32),
                                device=dev)
    num = torch.tensor([n], dtype=torch.int32, device=dev)
    total = None
    scales = model["eval_min_dimension"]
    for min_dim in scales:
        short, long = compute_canvas(min_dim, 1.0, evaluation["aspect_cap"],
                                     evaluation["canvas_multiple"])
        ch, cw = (short, long) if w >= h else (long, short)
        canvas, (new_h, new_w) = fit_image_to_canvas(image, (ch, cw))
        fy, fx = new_h / ch, new_w / cw
        scale_vec = torch.tensor([fy, fx, fy, fx], dtype=torch.float32,
                                 device=dev)
        preds = predictions(params, folded, canvas[None],
                            (props * scale_vec)[None], num, model,
                            head_dtype=head_dtype)
        scores = {k: v.float() for k, v in preds.items()
                  if k.startswith("oicr_proposal_scores_at_")}
        total = scores if total is None else {k: total[k] + scores[k]
                                              for k in total}
    divisor = torch.tensor(float(len(scales)), device=dev)
    return {k: v / divisor for k, v in total.items()}, props[None], num
