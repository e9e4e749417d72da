"""The BN fold (``cap2det_tpu_torch/kernels/bn_fold.py``) on the CPU.

The card's path (``bn_fold._fold_kernels``: the plan, the
``torch.autograd.Function``, its views and gradients) runs here on CPU
tensors with its two launches replaced by a walk of the plan's chunk
tables with the kernels' index arithmetic (``csrc/bn_fold.cu``, mirrored
in ``walk_the_kernels``); CPU tensors otherwise take the former
per-convolution chain, ``fold_reference``.

* ``inception_v2.prepare`` / ``frcnn.prepare`` fold both stages in one
  ``bn_fold.fold`` call and give what the former chain (copied here as
  the oracle) gave: the same tree, values, dtypes and channels-last
  strides, the composed stem included, on either path.
* Gradients through the card's path equal those through the chain bit
  for bit under coco17_extend_match's trainable set (Mixed_4e and
  Mixed_5) and voc07_inc2's (the first stage frozen); frozen
  convolutions' outputs take no part in the graph; whole training steps
  give the same bits.
* ``FoldPlan``'s offsets, chunks and alignment; the walk writes every
  output once.
* ResNet-101's 104 convolutions, each with a gamma, at epsilon 1e-5, in
  one fold: the walked kernels equal ``fold_reference`` bit for bit
  forward, and gamma's gradient, summed in ``channel_sum``'s order, too;
  the plain versions' scale and epsilon arguments against their
  formulas and autograd.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cap2det_tpu_torch import kernels
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.kernels import bn_fold
from cap2det_tpu_torch.models import frcnn, inception_v2, resnet_v1


# -- the former fold, kept as the oracle ------------------------------------


def _fold_bn(w, bn, compute_dtype):
    """Frozen-statistics BN folded into an OIHW conv: {weight, bias} with
    conv(x, weight) + bias == BN(conv(x, w)), cast to compute_dtype, the
    weight in channels_last."""
    inv = torch.rsqrt(bn["moving_variance"] + 0.001)
    w = (w * inv[:, None, None, None]).to(compute_dtype)
    return {
        "weight": w.contiguous(memory_format=torch.channels_last),
        "bias": (bn["beta"] - bn["moving_mean"] * inv).to(compute_dtype),
    }


def _chain_prepare(params, compute_dtype):
    out = {}
    for key, value in params.items():
        if "depthwise_weights" in value:
            out[key] = _fold_bn(bn_fold.compose_separable(value),
                                value["BatchNorm"], compute_dtype)
        elif "weights" in value:
            out[key] = _fold_bn(value["weights"], value["BatchNorm"],
                                compute_dtype)
        else:
            out[key] = _chain_prepare(value, compute_dtype)
    return out


# -- seeded trees -----------------------------------------------------------

SCOPES = (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE)


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _trainable(regime):
    """Which leaves of both stages train: coco17_extend_match's Mixed_4e
    and second stage, voc07_inc2's second stage, or none."""
    def trains(path):
        if path[-1] not in ("weights", "beta", "depthwise_weights",
                            "pointwise_weights"):
            return False
        if regime == "coco17":
            return path[0] == frcnn.SECOND_SCOPE or "Mixed_4e" in path
        if regime == "voc07":
            return path[0] == frcnn.SECOND_SCOPE
        return regime == "all"
    return trains


@pytest.fixture(scope="module")
def tree():
    """Both stages' seeded params with BN statistics drawn away from the
    init's, so every inv, bias and product is a real one."""
    rng = np.random.default_rng(5)
    numpy_tree = {
        frcnn.FIRST_SCOPE: inception_v2.init_first_stage_params_numpy(rng),
        frcnn.SECOND_SCOPE: inception_v2.init_second_stage_params_numpy(rng),
    }
    for path, leaf in _leaves(numpy_tree):
        if path[-1] == "moving_variance":
            leaf[...] = rng.uniform(0.01, 2.0, leaf.shape)
        elif path[-1] in ("moving_mean", "beta"):
            leaf[...] = rng.normal(0.0, 1.0, leaf.shape)
    return params_lib.from_jax_numpy(numpy_tree, "cpu")


def _with_trainable(tree, regime):
    """The shared tree with `regime`'s leaves requiring a gradient."""
    trains = _trainable(regime)
    for path, leaf in _leaves(tree):
        leaf.requires_grad_(trains(path))
    return tree


def _convs(params):
    slots = []
    for scope in SCOPES:
        bn_fold.gather(params[scope], slots)
    return [(w, bn["beta"], bn["moving_mean"], bn["moving_variance"])
            for _, _, w, bn in slots]


# -- the kernels' walk of the tables, mirrored ------------------------------


def _flat(t):
    """t's storage as a flat tensor of its dtype and t's offset in it."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0), t.storage_offset()


def _walk_fold(plan, convs, dtype, eps=bn_fold.BN_EPSILON):
    """csrc/bn_fold.cu fold_kernel's arithmetic over plan.fwd_chunks: the
    output buffer, the scale buffer and how often each output was
    written. `convs`: (weights, beta, mean, var, gamma or None) each."""
    out = torch.zeros(plan.out_total, dtype=dtype)
    scale_buf = torch.zeros(plan.scale_total)
    written = torch.zeros(plan.out_total, dtype=torch.int32)
    for conv, start, length, kind in plan.fwd_chunks.tolist():
        row = plan.table[conv]
        w, beta, mean, var, gamma = (None if t is None else t.detach()
                                     for t in convs[conv])

        def scale(o):
            inv = torch.rsqrt(var[o] + eps)
            return inv if gamma is None else gamma[o] * inv

        j = torch.arange(start, start + length)
        if kind == bn_fold.BIAS:
            at = int(row["out_b"]) + j
            out[at] = (beta[j] - mean[j] * scale(j)).to(dtype)
            scale_buf[int(row["scale"]) + j] = scale(j)
            if row["inv"] >= 0:
                scale_buf[int(row["inv"]) + j] = torch.rsqrt(var[j] + eps)
        else:
            cin, taps = int(row["in_channels"]), int(row["taps"])
            o = j // (cin * taps)
            r = j - o * cin * taps
            s, ci = r // cin, r % cin
            flat, base = _flat(w)
            v = flat[base + o * int(row["w_stride_o"])
                     + ci * int(row["w_stride_i"]) + s]
            at = int(row["out_w"]) + j
            out[at] = (v * scale(o)).to(dtype)
        written[at] += 1
    return out, scale_buf, written


def _walk_gamma(row, g, gb, w, mean, scale_buf, channels):
    """fold_grad_kernel's gamma chunk: per output channel a warp's 32
    lanes each add their elements (j, j + 32, ...) in turn, then the lanes
    are added pairwise (xor 16, 8, 4, 2, 1)."""
    cin, taps = int(row["in_channels"]), int(row["taps"])
    n = cin * taps
    channels_last = (not g.is_contiguous()) or taps == 1
    j = torch.arange(n)
    s, ci = j // cin, j % cin
    o = channels[:, None]
    gflat, gbase = _flat(g)
    wflat, wbase = _flat(w)
    gv = gflat[gbase + o * n + (j if channels_last else ci * taps + s)]
    wv = wflat[wbase + o * int(row["w_stride_o"])
               + ci * int(row["w_stride_i"]) + s]
    prod = gv.float() * wv
    lanes = torch.zeros((len(channels), 32))
    for k in range(0, n, 32):
        part = prod[:, k:k + 32]
        lanes[:, :part.shape[1]] = lanes[:, :part.shape[1]] + part
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ off]
    acc = lanes[:, 0]
    if gb is not None:
        acc = acc - gb[channels].float() * mean[channels]
    return acc * scale_buf[int(row["inv"]) + channels]


def _walk_fold_grad(plan, g_w, g_b, aux, scale_buf):
    """fold_grad_kernel's arithmetic over plan.bwd_chunks."""
    grad = torch.zeros(plan.grad_total)
    written = torch.zeros(plan.grad_total, dtype=torch.int32)
    for conv, start, length, kind in plan.bwd_chunks.tolist():
        row = plan.table[conv]
        j = torch.arange(start, start + length)
        if kind == bn_fold.BIAS:
            at = int(row["grad_b"]) + j
            grad[at] = g_b[conv][j].float()
        elif kind == bn_fold.GAMMA:
            at = int(row["grad_g"]) + j
            grad[at] = _walk_gamma(row, g_w[conv], g_b[conv], *aux[conv],
                                   scale_buf, j)
        else:
            g = g_w[conv]
            cin, taps = int(row["in_channels"]), int(row["taps"])
            o = j // (cin * taps)
            r = j - o * cin * taps
            ci, s = r // taps, r % taps
            gather = (not g.is_contiguous()) and taps > 1
            flat, base = _flat(g)
            src = (o * cin * taps + s * cin + ci) if gather else j
            at = int(row["grad_w"]) + j
            grad[at] = (flat[base + src].float()
                        * scale_buf[int(row["scale"]) + o])
        written[at] += 1
    return grad, written


def walk_the_kernels(monkeypatch):
    """Routes ``bn_fold.fold`` through the card's path for CPU tensors,
    its launches replaced by the walks (and counted as launches)."""
    from cap2det_tpu_torch.utils.spans import span

    def launch(plan, convs, out, scale, eps):
        got, got_scale, written = _walk_fold(plan, convs, out.dtype, eps)
        assert int(written.max()) == 1
        out.copy_(got)
        if scale is not None:
            scale.copy_(got_scale)
        bn_fold.launches += 1

    def launch_grad(plan, g_w, g_b, aux, scale, grad, dtype):
        for i, g in enumerate(g_w):
            if g is not None:
                bn_fold._grad_flags(i, g, plan.shapes[i], dtype)
        got, written = _walk_fold_grad(plan, g_w, g_b, aux, scale)
        assert int(written.max()) == 1
        grad.copy_(got)
        bn_fold.grad_launches += 1

    def fold(convs, dtype=torch.bfloat16, eps=bn_fold.BN_EPSILON):
        if not convs:
            return []
        convs = [tuple(c) + (None,) * (5 - len(c)) for c in convs]
        with span("cap2det/kernel/bn_fold"):
            return bn_fold._fold_kernels(convs, dtype, eps)

    monkeypatch.setattr(bn_fold, "launches", bn_fold.launches)
    monkeypatch.setattr(bn_fold, "grad_launches", bn_fold.grad_launches)
    monkeypatch.setattr(bn_fold, "_launch", launch)
    monkeypatch.setattr(bn_fold, "_launch_grad", launch_grad)
    monkeypatch.setattr(bn_fold, "fold", fold)


@pytest.fixture(params=["chain", "kernels"])
def path(request, monkeypatch):
    """The CPU's path, or the card's with its launches walked."""
    if request.param == "kernels":
        walk_the_kernels(monkeypatch)
    return request.param


@pytest.fixture
def kernels_walked(monkeypatch):
    walk_the_kernels(monkeypatch)


# -- prepare against the chain ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_prepare_equals_the_per_conv_chain(tree, dtype, path):
    params = _with_trainable(tree, "none")
    got = frcnn.prepare(params, dtype)
    want = {scope: _chain_prepare(params[scope], dtype) for scope in SCOPES}
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert len(got_leaves) == 2 * 69
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype == dtype, path
        assert a.shape == b.shape and a.stride() == b.stride(), path
        assert torch.equal(a, b), path
    # One stage alone, as the tools prepare it, is the same.
    first = inception_v2.prepare(params[frcnn.FIRST_SCOPE], dtype)
    for (path, a), (_, b) in zip(_leaves(first),
                                 _leaves(want[frcnn.FIRST_SCOPE])):
        assert a.stride() == b.stride() and torch.equal(a, b), path


def test_prepared_convs_are_views_of_one_aligned_buffer(tree,
                                                        kernels_walked):
    params = _with_trainable(tree, "none")
    outs = [t for _, t in _leaves(frcnn.prepare(params, torch.bfloat16))]
    storage = outs[0].untyped_storage().data_ptr()
    for t in outs:
        assert t.untyped_storage().data_ptr() == storage
        assert (t.storage_offset() * t.element_size()) % 512 == 0


@pytest.mark.parametrize("regime", ["coco17", "voc07"])
def test_gradients_equal_the_chain(tree, regime, kernels_walked):
    params = _with_trainable(tree, regime)
    before = (bn_fold.launches, bn_fold.grad_launches)
    trains = _trainable(regime)
    trainable = [(p, leaf) for p, leaf in _leaves(params) if trains(p)]
    want_convs = {"coco17": 26, "voc07": 19}[regime]
    assert len(trainable) == 2 * want_convs
    grads = {}
    for name, prep in (
            ("fold", lambda: frcnn.prepare(params, torch.bfloat16)),
            ("chain", lambda: {s: _chain_prepare(params[s], torch.bfloat16)
                               for s in SCOPES})):
        prepared = list(_leaves(prep()))
        # Frozen convolutions' outputs are no part of the graph.
        diff = [(p, t) for p, t in prepared if t.requires_grad]
        assert len(diff) == 2 * want_convs
        gen = torch.Generator().manual_seed(3)
        upstream = []
        for _, t in diff:
            g = torch.randn(t.shape, generator=gen).to(t.dtype)
            if t.dim() == 4 and t.shape[-1] > 1:  # as cuDNN gives it
                g = g.contiguous(memory_format=torch.channels_last)
            upstream.append(g)
        grads[name] = torch.autograd.grad([t for _, t in diff],
                                          [leaf for _, leaf in trainable],
                                          upstream)
    assert (bn_fold.launches - before[0],
            bn_fold.grad_launches - before[1]) == (1, 1)
    for (path, leaf), a, b in zip(trainable, grads["fold"], grads["chain"]):
        assert a.dtype == torch.float32 and a.shape == leaf.shape, path
        assert torch.equal(a, b), path
    for g in grads["fold"]:
        if g.dim() == 4:
            assert g.is_contiguous()  # as the fused optimizer takes it


def test_trainable_stem_gradients_equal_the_chain(tree, kernels_walked):
    """The composed stem trains too (no shipped config unfreezes it): its
    weight is an einsum's strided output, differentiated through."""
    params = _with_trainable(tree, "all")
    stem = params[frcnn.FIRST_SCOPE]["InceptionV2"]["Conv2d_1a_7x7"]
    leaves = [stem["depthwise_weights"], stem["pointwise_weights"],
              stem["BatchNorm"]["beta"]]
    grads = []
    for prep in (lambda: inception_v2.prepare(params[frcnn.FIRST_SCOPE]),
                 lambda: _chain_prepare(params[frcnn.FIRST_SCOPE],
                                        torch.bfloat16)):
        out = prep()["InceptionV2"]["Conv2d_1a_7x7"]
        gen = torch.Generator().manual_seed(4)
        loss = sum((out[k].float() * torch.randn(out[k].shape,
                                                 generator=gen)).sum()
                   for k in ("weight", "bias"))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_fold_under_no_grad_builds_no_graph(tree, kernels_walked):
    params = _with_trainable(tree, "coco17")
    before = (bn_fold.launches, bn_fold.grad_launches)
    with torch.no_grad():
        outs = [t for _, t in _leaves(frcnn.prepare(params))]
    assert not any(t.requires_grad for t in outs)
    with torch.inference_mode():
        again = [t for _, t in _leaves(frcnn.prepare(params))]
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    assert (bn_fold.launches - before[0],
            bn_fold.grad_launches - before[1]) == (2, 0)


def test_only_the_cpu_path_differentiates_the_moving_statistics(
        monkeypatch):
    w = torch.randn(4, 3, 1, 1, requires_grad=True)
    beta, mean = torch.randn(4), torch.randn(4)
    var = (torch.rand(4) + 0.5).requires_grad_()
    weight, _ = bn_fold.fold([(w, beta, mean, var)])[0]
    (g,) = torch.autograd.grad(weight.float().sum(), [var])
    assert g.abs().min() > 0  # the chain's gradient, as before
    walk_the_kernels(monkeypatch)
    with pytest.raises(ValueError, match="moving statistics"):
        bn_fold.fold([(w, beta, mean, var)])
    assert bn_fold.fold([]) == []


def test_the_cpu_path_launches_nothing(tree):
    counts = kernels.launch_counts()
    assert {"bn_fold", "bn_fold_grad"} <= set(counts)
    params = _with_trainable(tree, "voc07")
    prepared = list(_leaves(frcnn.prepare(params)))
    loss = sum(t.float().sum() for _, t in prepared if t.requires_grad)
    loss.backward()
    after = kernels.launch_counts()
    assert (after["bn_fold"], after["bn_fold_grad"]) == (
        counts["bn_fold"], counts["bn_fold_grad"])
    for _, leaf in _leaves(params):
        leaf.grad = None


# -- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("regime", ["coco17", "voc07", "none"])
def test_plan_offsets_chunks_and_alignment(tree, regime):
    params = _with_trainable(tree, regime)
    convs = _convs(params)
    ws = [c[0] for c in convs]
    grad_w = [w.requires_grad for w in ws]
    grad_b = [c[1].requires_grad for c in convs]
    plan = bn_fold.plan(ws, grad_w, grad_b)
    assert plan is bn_fold.plan(ws, grad_w, grad_b)  # made once
    table = plan.table
    assert len(table) == 69
    spans = {"out": [], "grad": []}
    scale_at = 0
    for i, (w, row) in enumerate(zip(ws, table)):
        o, c, kh, kw = w.shape
        assert (row["out_channels"], row["in_channels"], row["taps"]) == (
            o, c, kh * kw)
        assert (row["w_stride_o"], row["w_stride_i"]) == w.stride()[:2]
        spans["out"] += [(row["out_w"], w.numel()), (row["out_b"], o)]
        assert row["scale"] == scale_at and row["inv"] == -1
        scale_at += o
        assert (row["grad_w"] >= 0) == grad_w[i]
        assert (row["grad_b"] >= 0) == grad_b[i]
        if grad_w[i]:
            spans["grad"].append((row["grad_w"], w.numel()))
        if grad_b[i]:
            spans["grad"].append((row["grad_b"], o))
    assert plan.scale_total == max(scale_at, 1)
    for name, total in (("out", plan.out_total), ("grad", plan.grad_total)):
        at = 0
        for start, n in spans[name]:
            assert start % bn_fold.ALIGN == 0 and start >= at
            at = start + n
        assert at <= total
    # 16-byte stores: each view's first element on a 16-byte boundary in
    # either dtype, and each chunk starts on a group of VEC outputs.
    assert bn_fold.ALIGN % bn_fold.VEC == 0 and bn_fold.CHUNK % bn_fold.VEC == 0
    for chunks, want in ((plan.fwd_chunks, [(True, True)] * 69),
                         (plan.bwd_chunks, list(zip(grad_w, grad_b)))):
        covered = {}
        for conv, start, length, kind in chunks.tolist():
            n = ws[conv].numel() if kind == bn_fold.WEIGHT else ws[conv].shape[0]
            assert 0 < length <= bn_fold.CHUNK
            assert start % bn_fold.VEC == 0 and start + length <= n
            covered.setdefault((conv, kind), []).append((start, length))
        for conv, (w_on, b_on) in enumerate(want):
            for kind, on in ((bn_fold.WEIGHT, w_on), (bn_fold.BIAS, b_on)):
                n = (ws[conv].numel() if kind == bn_fold.WEIGHT
                     else ws[conv].shape[0])
                got = sorted(covered.get((conv, kind), []))
                if not on:
                    assert not got
                    continue
                assert got[0][0] == 0 and sum(l for _, l in got) == n
                assert all(a + la == b for (a, la), (b, _) in zip(got, got[1:]))
    assert len(plan.fwd_chunks) < 2 ** 31


def test_plan_refuses_more_convolutions_than_a_launch_takes():
    structure = tuple(((((8, 8, 1, 1)), (8, 1, 1, 1)), False)
                      for _ in range(bn_fold.MAX_CONVS + 1))
    none = (False,) * len(structure)
    with pytest.raises(ValueError, match="at most"):
        bn_fold.FoldPlan(structure, none, none, none)
    assert len(bn_fold.FoldPlan(structure[1:], none[1:], none[1:],
                                none[1:]).table) == bn_fold.MAX_CONVS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_the_kernels_walk_of_the_tables_equals_the_plain_version(tree,
                                                                 dtype):
    params = _with_trainable(tree, "coco17")
    convs = _convs(params)
    tensors = [t for c in convs for t in c]
    plan = bn_fold.plan(tensors[0::4], [t.requires_grad
                                        for t in tensors[0::4]],
                        [t.requires_grad for t in tensors[1::4]])
    out, inv_buf, written = _walk_fold(
        plan, [tuple(c) + (None,) for c in convs], dtype)
    views = plan.outputs(out)
    with torch.no_grad():
        want = [t for c in convs
                for t in bn_fold.fold_reference(*c, dtype)]
    for a, b in zip(views, want):
        assert a.stride() == b.stride() and torch.equal(a, b)
    # Each output written once; the alignment padding never.
    assert int(written.max()) == 1
    assert int(written.sum()) == sum(t.numel() for t in want)

    gen = torch.Generator().manual_seed(6)
    g_w, g_b = [], []
    for w, beta, _, _ in convs:
        g = torch.randn(w.shape, generator=gen).to(dtype)
        if w.shape[-1] > 1 and len(g_w) % 2:  # both layouts, by turns
            g = g.contiguous(memory_format=torch.channels_last)
        g_w.append(g)
        g_b.append(torch.randn(beta.shape, generator=gen).to(dtype))
    grad, written = _walk_fold_grad(plan, g_w, g_b, None, inv_buf)
    assert int(written.max()) == 1
    got = plan.gradients(grad)
    for i, (w, beta, mean, var) in enumerate(convs):
        inv = torch.rsqrt(var.detach() + bn_fold.BN_EPSILON)
        dw, dbeta, dgamma = bn_fold.fold_grad_reference(g_w[i], g_b[i], inv)
        assert dgamma is None and got[3 * i + 2] is None
        if plan.grad_w[i]:
            assert torch.equal(got[3 * i], dw)
        else:
            assert got[3 * i] is None
        if plan.grad_b[i]:
            assert torch.equal(got[3 * i + 1], dbeta)
        else:
            assert got[3 * i + 1] is None


@pytest.mark.parametrize("config", ["coco17_extend_match", "voc07_inc2"])
def test_train_steps_through_the_kernels_equal_the_chain(monkeypatch,
                                                         config):
    """Two training steps at ``benchmark/small.py``'s sizes, the fold
    through the card's path against the chain: the same losses and
    params bit for bit, one fold and one backward a step."""
    from benchmark import small
    from benchmark.drivers import train_step as train_driver
    from benchmark.yardstick import traffic, weights
    from cap2det_tpu_torch.train import optimizers

    seed = 2 ** 31 + 17
    cfg = small.config(config)
    host = traffic.train_batches(small.mix("train_buckets"), cfg, seed)
    batches = [host[0][0], host[1][0]]
    runs = []
    for walked in (False, True):
        if walked:
            walk_the_kernels(monkeypatch)
        program = train_driver.Program(
            cfg, weights.make_params(cfg["model"], seed, "cpu"), "cpu")
        before = (bn_fold.launches, bn_fold.grad_launches)
        losses = [program.step(b, seed)["loss/total_loss"] for b in batches]
        runs.append((losses, optimizers.flatten_params(
            program.state["params"])))
        if walked:
            assert (bn_fold.launches - before[0],
                    bn_fold.grad_launches - before[1]) == (2, 2)
    (want_losses, want), (losses, got) = runs
    assert all(map(torch.equal, losses, want_losses))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), path


# -- a scale and an epsilon: ResNet-101 ---------------------------------------


def test_fold_reference_takes_a_scale_and_an_epsilon():
    gen = torch.Generator().manual_seed(11)
    w = torch.randn((6, 4, 3, 3), generator=gen)
    beta, mean, gamma = (torch.randn(6, generator=gen) for _ in range(3))
    var = torch.rand(6, generator=gen) * 0.01 + 1e-4
    for eps, g in ((1e-5, gamma), (1e-5, None), (1e-3, gamma)):
        weight, bias = bn_fold.fold_reference(w, beta, mean, var,
                                              torch.float32, g, eps)
        inv = torch.rsqrt(var + eps)
        scale = inv if g is None else g * inv
        assert torch.equal(weight, (w * scale[:, None, None, None])
                           .contiguous(memory_format=torch.channels_last))
        assert weight.stride() == w.contiguous(
            memory_format=torch.channels_last).stride()
        assert torch.equal(bias, beta - mean * scale)
    # The default is InceptionV2's epsilon, and no scale.
    assert all(map(torch.equal,
                   bn_fold.fold_reference(w, beta, mean, var, torch.float32),
                   bn_fold.fold_reference(w, beta, mean, var, torch.float32,
                                          None, 1e-3)))


def test_fold_grad_reference_is_autograd_of_the_plain_fold():
    """dweights and dbeta are autograd's bits through the plain ops;
    dgamma, summed in ``channel_sum``'s order, is within float32
    round-off of autograd's, and exactly the walk of the kernel's warp."""
    gen = torch.Generator().manual_seed(12)
    w = torch.randn((40, 24, 3, 3), generator=gen)
    beta, mean, gamma = (torch.randn(40, generator=gen) for _ in range(3))
    var = torch.rand(40, generator=gen) + 0.1
    leaves = [t.clone().requires_grad_() for t in (w, beta, gamma)]
    inv = torch.rsqrt(var + 1e-5)
    scale = leaves[2] * inv
    weight = (leaves[0] * scale[:, None, None, None]).to(torch.bfloat16)
    bias = (leaves[1] - mean * scale).to(torch.bfloat16)
    g_w = torch.randn(weight.shape, generator=gen).to(torch.bfloat16)
    g_w = g_w.contiguous(memory_format=torch.channels_last)
    g_b = torch.randn(bias.shape, generator=gen).to(torch.bfloat16)
    want = torch.autograd.grad((weight, bias), leaves, (g_w, g_b))
    dw, dbeta, dgamma = bn_fold.fold_grad_reference(
        g_w, g_b, (gamma * inv), w, mean, inv)
    assert torch.equal(dw, want[0]) and torch.equal(dbeta, want[1])
    torch.testing.assert_close(dgamma, want[2], rtol=1e-5, atol=1e-5)
    row = {"in_channels": 24, "taps": 9, "w_stride_o": 24 * 9,
           "w_stride_i": 9, "inv": 0}
    walked = _walk_gamma(row, g_w, g_b, w, mean, inv, torch.arange(40))
    assert torch.equal(dgamma, walked)
    # Without a gamma there is no dgamma; either gradient may be missing.
    assert bn_fold.fold_grad_reference(g_w, None, inv)[1:] == (None, None)


@pytest.fixture(scope="module")
def resnet_tree():
    """ResNet-101's both stages, seeded, with every BN statistic and gamma
    drawn away from the init's."""
    rng = np.random.default_rng(6)
    numpy_tree = {
        frcnn.FIRST_SCOPE: resnet_v1.init_first_stage_params_numpy(rng),
        frcnn.SECOND_SCOPE: resnet_v1.init_second_stage_params_numpy(rng),
    }
    for path, leaf in _leaves(numpy_tree):
        if path[-1] == "moving_variance":
            leaf[...] = rng.uniform(0.01, 2.0, leaf.shape)
        elif path[-1] in ("moving_mean", "beta", "gamma"):
            leaf[...] = rng.normal(0.0, 1.0, leaf.shape)
    return params_lib.from_jax_numpy(numpy_tree, "cpu")


def _resnet_trains(path):
    """coco17_resnet101's trainable leaves: block3's and block4's
    weights, betas and gammas."""
    return (path[-1] in ("weights", "beta", "gamma")
            and (path[0] == frcnn.SECOND_SCOPE or "block3" in path))


def test_resnet_folds_in_one_launch_each_way_as_the_plain_version(
        resnet_tree, kernels_walked):
    for path, leaf in _leaves(resnet_tree):
        leaf.requires_grad_(_resnet_trains(path))
    trainable = [(p, leaf) for p, leaf in _leaves(resnet_tree)
                 if leaf.requires_grad]
    assert len(trainable) == 3 * 80
    runs = {}
    for name in ("kernels", "plain"):
        before = (bn_fold.launches, bn_fold.grad_launches)
        if name == "kernels":
            prepared = frcnn.prepare(resnet_tree, torch.bfloat16)
        else:
            slots = []
            trees = [bn_fold.gather(resnet_tree[s], slots)
                     for s in SCOPES]
            for out, key, w, bn in slots:
                weight, bias = bn_fold.fold_reference(
                    w, bn["beta"], bn["moving_mean"], bn["moving_variance"],
                    torch.bfloat16, bn["gamma"], resnet_v1.BN_EPSILON)
                out[key] = {"weight": weight, "bias": bias}
            prepared = dict(zip(SCOPES, trees))
        outs = list(_leaves(prepared))
        diff = [t for _, t in outs if t.requires_grad]
        gen = torch.Generator().manual_seed(13)
        upstream = []
        for t in diff:
            g = torch.randn(t.shape, generator=gen).to(t.dtype)
            if t.dim() == 4 and t.shape[-1] > 1:
                g = g.contiguous(memory_format=torch.channels_last)
            upstream.append(g)
        grads = torch.autograd.grad(diff, [leaf for _, leaf in trainable],
                                    upstream)
        runs[name] = (outs, len(diff), grads,
                      (bn_fold.launches - before[0],
                       bn_fold.grad_launches - before[1]))
    (outs, n_diff, grads, launched) = runs["kernels"]
    (want, want_diff, want_grads, _) = runs["plain"]
    assert launched == (1, 1)
    assert len(outs) == 2 * 104 and n_diff == want_diff == 2 * 80
    for (path, a), (_, b) in zip(outs, want):
        assert a.stride() == b.stride() and torch.equal(a, b), path
    for (path, _), a, b in zip(trainable, grads, want_grads):
        assert a.dtype == torch.float32 and torch.equal(a, b), path
    for _, leaf in _leaves(resnet_tree):
        leaf.requires_grad_(False)
