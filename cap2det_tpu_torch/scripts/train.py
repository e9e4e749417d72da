"""Training plus continuous evaluation on one host (the port's counterpart
of ``scripts/train.sh``).

  python -m cap2det_tpu_torch.scripts.train <config-name> [model_dir] \\
      [extra train_main args...] [--device cuda|cpu]

Reads ``configs/<config-name>.pbtxt`` from the working directory;
``model_dir`` defaults to ``logs/<config-name>``. The eval daemon
(``cli.evaluate_main``) runs in the background, appending to
``<model_dir>/eval.log``, while ``cli.train_main`` runs in the
foreground; both get ``--device``, so on the card they share it. That is
the reference's train/eval process split (reference train.sh), which a
single TPU chip could not hold (``scripts/quality_run.sh``).

The daemon and the trainer each start in a session of their own. On
every way out (the trainer's end, an exception, SIGINT, SIGTERM) this
script signals both process groups, so nothing it started outlives it.
It exits with the trainer's exit code (128 + the signal's number when a
signal ended it).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys

from cap2det_tpu_torch.scripts import steps

STOP_GRACE_SECS = 20.0


def _raise_on(signum, frame):
    raise SystemExit(128 + signum)


def start(module, *args, stdout=None):
    """Starts a step in a session (and process group) of its own."""
    return subprocess.Popen(steps.command(module, *args), env=steps.env(),
                            stdout=stdout, stderr=subprocess.STDOUT
                            if stdout is not None else None,
                            start_new_session=True)


def stop(proc, grace=STOP_GRACE_SECS):
    """Ends `proc` and everything in its process group: SIGTERM, up to
    `grace` seconds for the leader to exit, then SIGKILL to the group."""
    if proc is None:
        return
    # A session leader's process group id is its pid.
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            pass
        if sig == signal.SIGTERM:
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass
    proc.wait()


def parse(argv, prog):
    parser = argparse.ArgumentParser(
        prog=prog,
        usage="%(prog)s <config-name> [model_dir] [extra train args...] "
              "[--device cuda|cpu]")
    parser.add_argument("name")
    parser.add_argument("model_dir", nargs="?")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, for both processes")
    args, extra = parser.parse_known_args(argv)
    args.model_dir = args.model_dir or os.path.join("logs", args.name)
    return args, extra


def run(name, model_dir, device, extra=()):
    """Runs the trainer with the daemon beside it; returns the trainer's
    exit code."""
    pipeline = os.path.join("configs", "%s.pbtxt" % name)
    os.makedirs(model_dir, exist_ok=True)
    previous = {s: signal.signal(s, _raise_on)
                for s in (signal.SIGINT, signal.SIGTERM)}
    daemon = trainer = None
    try:
        with open(os.path.join(model_dir, "eval.log"), "a") as log:
            daemon = start("cap2det_tpu_torch.cli.evaluate_main",
                           "--pipeline_proto", pipeline,
                           "--model_dir", model_dir, "--device", device,
                           stdout=log)
        print("eval daemon: pid %d, log %s" % (
            daemon.pid, os.path.join(model_dir, "eval.log")),
            file=sys.stderr, flush=True)
        trainer = start("cap2det_tpu_torch.cli.train_main",
                        "--pipeline_proto", pipeline,
                        "--model_dir", model_dir, "--device", device, *extra)
        print("trainer: pid %d" % trainer.pid, file=sys.stderr, flush=True)
        return trainer.wait()
    finally:
        stop(trainer)
        stop(daemon)
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def main(argv=None, prog=None):
    args, extra = parse(argv, prog)
    return run(args.name, args.model_dir, args.device, extra)


if __name__ == "__main__":
    sys.exit(main())
