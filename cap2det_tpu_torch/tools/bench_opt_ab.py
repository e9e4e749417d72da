"""Same-process A/B of the fused flat optimizer against the per-leaf chain
(port of ``tools/bench_opt_ab.py``).

Measures (a) the optimizer update alone and (b) the whole training step
under each optimizer (``build_optimizer(fused=True)``, one launch of
``csrc/fused_optimizer.cu`` a step, against ``fused=False``, about ten
small launches per trainable leaf), at the root tool's shape: the bench
step (``cap2det_tpu_torch/bench.py``) at batch 2, 1024x1536, 500
proposals, 80 classes, Mixed_4e trainable, Adagrad. Each arm is its own
model and state from the same seed. The update is timed on the gradients
of one real step of that arm (captured as the step hands them to the
optimizer; the 3x3 convolutions' arrive channels-last), the step on the
bench's placed batch.

Both arms run in one process, in alternating turns (fused, unfused,
unfused, fused, ...), each turn ``AB_STEPS`` calls (default 8, as the
root tool's) timed by CUDA events: step medians drift between calls and
within one, so only turns in one process compare. Prints one JSON line
per turn and then the root tool's line, ``opt_fused``, ``opt_unfused``,
``step_fused`` and ``step_unfused`` in ms (the median over the turns),
each line with the card's name and power limit.

    python -m cap2det_tpu_torch.tools.bench_opt_ab [--variant
        fused|unfused|both] [--turns N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics

from cap2det_tpu_torch import bench
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

BATCH = 2
CANVAS_HW = (1024, 1536)
NUM_PROPOSALS = 500
NUM_CLASSES = 80
TURNS = 4  # turns per arm


class _Arm:
    """One optimizer's bench step, its state and one step's gradients."""

    def __init__(self, device, fused):
        shape = dict(batch=BATCH, canvas_hw=CANVAS_HW,
                     num_proposals=NUM_PROPOSALS, num_classes=NUM_CLASSES,
                     full_freeze=False)
        self.step = bench.BenchStep(shape, device, fused=fused)
        tx = self.step.tx
        captured = {}

        def capture(params, grads, state, _apply=tx.apply):
            captured.update(grads)
            return _apply(params, grads, state)

        tx.apply = capture
        try:
            self.step.run()
        finally:
            del tx.apply
        self.grads = captured

    def update(self):
        state = self.step.state
        state["opt_state"] = self.step.tx.apply(state["params"], self.grads,
                                                state["opt_state"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", choices=["fused", "unfused", "both"],
                        default="both")
    parser.add_argument("--turns", type=int, default=TURNS,
                        help="timed turns per arm")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    steps = int(os.environ.get("AB_STEPS", "8"))

    device = params_lib.resolve_device(args.device)
    fields = benchlib.device_fields(device)
    names = (("fused", "unfused") if args.variant == "both"
             else (args.variant,))
    arms = {name: _Arm(device, fused=name == "fused") for name in names}

    times = {"%s_%s" % (what, name): [] for name in names
             for what in ("opt", "step")}
    for turn in range(args.turns):
        order = names if turn % 2 == 0 else names[::-1]
        for name in order:
            arm = arms[name]
            opt = benchlib.time_rounds(arm.update, device, steps, 1,
                                       warmup=1)
            step = benchlib.time_rounds(arm.step.run, device, steps, 1,
                                        warmup=1)
            times["opt_" + name].append(opt["ms"])
            times["step_" + name].append(step["ms"])
            benchlib.json_line({
                "turn": turn, "variant": name, "opt_ms": opt["ms"],
                "opt_host_ms": opt["host_ms"], "step_ms": step["ms"],
                "step_host_ms": step["host_ms"], "clock": opt["clock"],
                "steps": steps, **fields})
    result = {key: statistics.median(ms) for key, ms in times.items()}
    result.update({key + "_min": min(ms) for key, ms in times.items()})
    result.update({key + "_max": max(ms) for key, ms in times.items()})
    benchlib.json_line({**result, "turns": args.turns, "steps": steps,
                        "clock": "cuda events" if device.type == "cuda"
                        else "host", **fields})
    return result


if __name__ == "__main__":
    main()
