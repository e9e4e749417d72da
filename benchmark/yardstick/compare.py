"""The numbers that decide ``correct``, each against its limit.

Training (two sets of three steps of the window's own step object
against the reference's three steps from the same state, batches and
seed: the first steps of set-up, and, under the prefix ``window_``, three
steps from the state the window left):

* ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the steps;
* ``grad_gap``: the first gradient's norm as the optimizer got it, worked
  out from its accumulator after one step (sqrt(sum(acc - acc0))) on both
  sides; the worst leaf's |program - reference| over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap``: the norm of each leaf's change over the three steps,
  compared the same way; leaves whose first reference gradient is under a
  thousandth of the median leaf's are left out (their change is round-off).

Prediction (a sample of the window's images, drawn from the seed, the
image with the most proposals in it):

* ``score_gap``: the worst |program - reference| of each OICR
  iteration's four-scale mean scores over that iteration's largest
  reference score, over the sampled images;
* ``nms_mismatch``: the detection values (counts, boxes, scores,
  classes) in which the program's postprocess differs from the
  reference's postprocess of the program's own mean scores: an exact
  comparison;
* ``detection_mismatch``: the same against the reference's detections
  end to end, its postprocess of its own mean scores. It is compared
  only where the two sides' mean scores agree bit for bit (a cell's
  limits file lists it): where they differ by rounding, a tie between
  two boxes may break the other way, and that is no fault.
"""

from __future__ import annotations

import statistics

import numpy as np

SMALL_LEAF = 1e-3  # of the median leaf's first gradient norm


def leaf_gaps(program, reference, keep=None):
    """{leaf: |p - r| / max(r, median r)} over the leaves in `keep` (all
    by default)."""
    median = statistics.median(reference.values())
    return {path: abs(program[path] - r) / max(r, median, 1e-30)
            for path, r in reference.items()
            if keep is None or path in keep}


def worst_leaf_gap(program, reference, keep=None):
    return max(leaf_gaps(program, reference, keep).values(), default=0.0)


def kept_leaves(reference):
    """The leaves whose first reference gradient is at least SMALL_LEAF
    of the median leaf's."""
    true = reference["true_grad_norms"]
    floor = SMALL_LEAF * statistics.median(true.values())
    return {path for path, n in true.items() if n >= floor}


def train_numbers(program, reference):
    """`program` and `reference`: {"losses": [...], "grad_norms": {leaf:
    norm}, "change_norms": {leaf: norm}}; the reference also
    "true_grad_norms" (its first step's gradients themselves)."""
    losses = max(abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(program["losses"], reference["losses"]))
    keep = kept_leaves(reference)
    return {
        "loss_gap": losses,
        "grad_gap": worst_leaf_gap(program["grad_norms"],
                                   reference["grad_norms"]),
        "change_gap": worst_leaf_gap(program["change_norms"],
                                     reference["change_norms"], keep),
    }


def score_gap(program_scores, reference_scores):
    """Worst relative gap of the mean scores of one image, over the
    iterations: {key: array [P, C']} each."""
    worst = 0.0
    for key, r in reference_scores.items():
        r = np.asarray(r, np.float64)
        p = np.asarray(program_scores[key], np.float64)
        worst = max(worst, float(np.abs(p - r).max())
                    / max(float(np.abs(r).max()), 1e-30))
    return worst


def mismatches(program, reference):
    """How many detection values differ: {key: array} each."""
    count = 0
    for key, r in reference.items():
        p = np.asarray(program[key])
        r = np.asarray(r)
        if p.shape != r.shape:
            count += max(p.size, r.size)
        else:
            count += int(np.sum(p != r))
    return count


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): correct when every number is
    finite and within its limit (a limit of 0 asks for equality)."""
    rows = [(name, numbers[name], limits[name]) for name in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
