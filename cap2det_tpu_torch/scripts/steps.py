"""Starting the steps of a run script (``set -euo pipefail`` semantics).

Every step is a module of this package run by the same interpreter with
the package's parent directory on ``PYTHONPATH``, so a script works from
any working directory. A step that fails stops the run: its log's last
lines go to stderr and ``StepFailed`` carries its exit code, which the
script's ``main`` exits with. Nothing is retried or skipped.
"""

from __future__ import annotations

import os
import subprocess
import sys

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAIL_LINES = 5


class StepFailed(Exception):
    def __init__(self, command, returncode):
        super().__init__("%s exited with %d" % (" ".join(command), returncode))
        self.returncode = returncode


def env():
    """os.environ with the package's parent directory on PYTHONPATH."""
    out = dict(os.environ)
    out["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_PARENT, out.get("PYTHONPATH")) if p)
    return out


def command(module, *args):
    return [sys.executable, "-m", module, *[str(a) for a in args]]


def tail(path, lines=TAIL_LINES):
    """The last `lines` lines of the file at `path` ('' if it is absent)."""
    try:
        with open(path, errors="replace") as fid:
            return "".join(fid.readlines()[-lines:])
    except FileNotFoundError:
        return ""


def _check(cmd, returncode, log):
    if returncode != 0:
        if log:
            sys.stderr.write(tail(log))
        raise StepFailed(cmd, returncode)


def run(module, *args, log=None):
    """Runs one step to its end; its output goes to `log` (a path), else
    to this process's stdout and stderr. Raises StepFailed on a nonzero
    exit."""
    cmd = command(module, *args)
    if log is None:
        _check(cmd, subprocess.run(cmd, env=env()).returncode, None)
        return
    with open(log, "w") as out:
        code = subprocess.run(cmd, env=env(), stdout=out,
                              stderr=subprocess.STDOUT).returncode
    _check(cmd, code, log)


def run_all(commands):
    """Runs (module, args) steps at once, their output on this process's;
    waits for all of them, then raises StepFailed for the first that
    failed."""
    procs = [(command(m, *a), subprocess.Popen(command(m, *a), env=env()))
             for m, a in commands]
    codes = [(cmd, p.wait()) for cmd, p in procs]
    for cmd, code in codes:
        _check(cmd, code, None)


def main(run_fn, argv=None):
    """Calls run_fn(argv); returns 0, or the failed step's exit code."""
    try:
        run_fn(argv)
    except StepFailed as exc:
        print("step failed: %s" % exc, file=sys.stderr)
        return exc.returncode
    return 0
