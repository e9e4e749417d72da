"""Each cell's run end to end at small sizes on the CPU (the program's
plain versions stand in for its kernels), its result line, the
comparison with the reference, the control, and the faults that must
turn ``correct`` false. The harness's look for a card is skipped: the
tests call ``run.run`` on the CPU.

On the CPU the program's ROI crop is its dense plain version, which
differs from the kernel's sample arithmetic (the reference's) by about a
bfloat16 step, so the agreement test holds the CPU run to CPU_LIMITS:
a few times the readings of these seeds here. The control and the
faults are held to the committed limits of each cell, which the card's
readings set.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness, run, small
from benchmark.yardstick import compare, traffic

BENCH = harness.benchmark_file()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [c for c in CELLS if c.endswith(".train_step")]
PREDICT = [c for c in CELLS if c.endswith(".predict")]
SEED = 2 ** 31 + 21
CPU_LIMITS = {"train_step": {"loss_gap": 1e-4, "grad_gap": 1e-2,
                             "change_gap": 5e-2, "window_loss_gap": 1e-4,
                             "window_grad_gap": 1e-2,
                             "window_change_gap": 5e-2},
              "predict": {"score_gap": 5e-3, "nms_mismatch": 0}}
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _files(cell, limits=None):
    w = harness.find(BENCH["workloads"], cell, "workload")
    files = {"config": small.config(w["config"]),
             "mix": small.mix(w["traffic"])}
    if limits is not None:
        files["limits"] = limits[files["mix"]["driver"]]
    return w, files


def _run(cell, trace=0, limits=None, seed=SEED):
    w, files = _files(cell, limits)
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(BENCH, w, seed, 0.3, trace, "cpu",
                 harness.SetupClock(time.perf_counter()), out, err, files)
    return rc, json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_ends_in_one_result_line(cell, trace):
    rc, line, err = _run(cell, trace, CPU_LIMITS)
    assert rc == 0
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in per_layer}
        assert line["metrics"]  # the host spans read on the CPU too
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    checks = [ln for ln in err.splitlines() if ln.startswith("check ")]
    assert err.splitlines()[-len(checks):] == checks
    assert [c.split()[1] for c in checks] == list(line["checks"])


def test_perturbed_outputs_fail_the_comparison():
    reference = {"losses": [1.0, 0.9, 0.8],
                 "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
                 "change_norms": {"a": 0.1, "b": 0.2, "c": 1e-3},
                 "true_grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9}}
    same = compare.train_numbers(reference, reference)
    assert same == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    moved = dict(reference, losses=[1.0, 0.9, 0.8 * (1 + 1e-3)])
    assert compare.train_numbers(moved, reference)["loss_gap"] == \
        pytest.approx(1e-3)
    # A leaf whose reference gradient is round-off is left out of the
    # change, whatever it reads.
    odd = dict(reference, change_norms={"a": 0.1, "b": 0.2, "c": 5.0})
    assert compare.train_numbers(odd, reference)["change_gap"] == 0.0
    scores = {"k": np.array([[0.5, 0.25]], np.float32)}
    assert compare.score_gap(scores, scores) == 0.0
    assert compare.score_gap({"k": scores["k"] + 1e-3}, scores) == \
        pytest.approx(2e-3, rel=1e-3)
    dets = {"s": np.array([0.5, 0.25], np.float32)}
    assert compare.mismatches(dets, dets) == 0
    assert compare.mismatches({"s": np.array([0.5, 0.2501], np.float32)},
                              dets) == 1
    ok, rows = compare.verdict({"x": 0.0, "y": 1.0}, {"x": 0, "y": 2.0})
    assert ok and rows == [("x", 0.0, 0), ("y", 1.0, 2.0)]
    assert not compare.verdict({"x": 1e-9}, {"x": 0})[0]
    assert not compare.verdict({"x": float("nan")}, {"x": 1.0})[0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_committed_limits(cell):
    """The reference in bfloat16 where the configuration states float32,
    in the program's place, fails a number of the cell."""
    w, files = _files(cell)
    if cell in TRAIN:
        rows = calibrate.train_rows(w, [], [SEED], "cpu", files, seconds=0.3)
    else:
        rows = calibrate.predict_rows(w, [], [SEED], "cpu", files)
    control = [numbers for kind, _, numbers in rows if kind == "control"]
    limits = harness.limits(w["config"], files["mix"]["driver"])
    assert control and not compare.verdict(control[0], limits)[0], control


def _broken_run(cell, monkeypatch, target, attribute, replacement):
    monkeypatch.setattr(target, attribute, replacement)
    rc, line, _ = _run(cell)
    assert rc == 0
    return line


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        cell, monkeypatch):
    from cap2det_tpu_torch.train import optimizers

    def unchanged(self, params, grads, state):
        return {"count": state["count"] + 1, "slots": state["slots"]}

    line = _broken_run(cell, monkeypatch, optimizers.FusedOptimizer, "apply",
                       unchanged)
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_fault_that_starts_after_the_warm_up_is_not_correct(
        cell, monkeypatch):
    """An update that leaves the state unchanged only once set-up's steps
    are done: the first steps read right, the steps after the window do
    not."""
    from cap2det_tpu_torch.train import optimizers

    real = optimizers.FusedOptimizer.apply
    warm = len(traffic.train_buckets(_files(cell)[1]["config"]))

    def late(self, params, grads, state):
        if state["count"] < warm:
            return real(self, params, grads, state)
        return {"count": state["count"] + 1, "slots": state["slots"]}

    monkeypatch.setattr(optimizers.FusedOptimizer, "apply", late)
    rc, line, _ = _run(cell, limits=CPU_LIMITS)
    assert rc == 0 and line["correct"] is False
    limits = CPU_LIMITS["train_step"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert line["checks"][name]["value"] <= limits[name]
    assert line["checks"]["window_grad_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from cap2det_tpu_torch.models import cap2det

    real = cap2det.Cap2DetModel.device_batch

    def half(self, host_batch):
        return real(self, {k: v[:len(v) // 2] for k, v in
                           host_batch.items()})

    line = _broken_run("coco17_extend_match.train_step", monkeypatch,
                       cap2det.Cap2DetModel, "device_batch", half)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", PREDICT)
def test_an_answer_altered_where_it_is_made_is_not_correct(cell,
                                                           monkeypatch):
    from cap2det_tpu_torch.models import cap2det

    real = cap2det.Cap2DetModel.postprocess

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        key = "detection_scores_at_%d" % self.options.oicr_iterations
        scores = out[key].clone()
        scores.view(-1)[0] = torch.nextafter(scores.view(-1)[0],
                                             torch.tensor(2.0))
        return {**out, key: scores}

    line = _broken_run(cell, monkeypatch, cap2det.Cap2DetModel,
                       "postprocess", altered)
    assert line["correct"] is False
    assert line["checks"]["nms_mismatch"]["value"] >= 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    """A short run of each cell through its command, from the root of
    the checkout: its result line is correct."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""
