"""Small sizes of the cells for the tests on the CPU: the same
configurations and mixes with tiny canvases and few proposals."""

from __future__ import annotations

import copy

from benchmark import harness


def config(name, proposals=4):
    cfg = copy.deepcopy(harness.config(name))
    cfg["train"].update(min_dimension=32, max_num_proposals=proposals)
    cfg["eval"].update(max_num_proposals=proposals)
    cfg["model"]["eval_min_dimension"] = [64, 32]
    cfg["dataset"]["valid_proposals"] = [proposals - 1, proposals]
    cfg["pbtxt"] = (cfg["pbtxt"]
                    .replace("max_num_proposals: 500",
                             "max_num_proposals: %d" % proposals)
                    .replace("max_num_proposals: 2000",
                             "max_num_proposals: %d" % proposals)
                    .replace("eval_min_dimension: 1200\n", "")
                    .replace("eval_min_dimension: 800\n",
                             "eval_min_dimension: 64\n")
                    .replace("eval_min_dimension: 600\n",
                             "eval_min_dimension: 32\n")
                    .replace("eval_min_dimension: 400\n", ""))
    return cfg


def mix(name):
    m = copy.deepcopy(harness.mix(name))
    if m["driver"] == "train_step":
        m.update(steps_per_scale=1, landscape=[1, 0, 1, 0], traced_steps=2)
    else:
        m.update(images=4, long_side=48, short_side=[32, 40], landscape=3,
                 traced_images=2, reference_images=2)
        m.pop("valid_proposals")
    return m
