"""Runs ``chip_smoke.py`` from two unpacked trees of the repository on one
GPU, in the order parent, change, change, parent, and prints each run's
kernel times (the kernels line and every timed row of the kernel phases)
and end-to-end medians, one JSON line per run.

Host-clock medians move 15-40% between runs of the same code, so a change
is compared with its parent only inside one such sequence on one card.

Unpack the two trees in a git checkout:

    mkdir -p build/parent build/change
    git archive <parent commit> | tar -x -C build/parent
    git add -A && git archive $(git write-tree) | tar -x -C build/change

then, from the repository root on the machine with the GPU:

    python3 -m cap2det_tpu_torch.tools.ab_smoke build/parent build/change \\
        --out build/ab

Each run's whole output goes to ``<out>/ab_<run>.log``. Exits nonzero if
any run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ORDER = (("parent1", 0), ("change1", 1), ("change2", 1), ("parent2", 0))
MEDIAN = re.compile(r"^(serve|train \S+): seconds per (?:image|step) over "
                    r"\d+ (?:images|steps): median ([0-9.e-]+)", re.M)


# The fields that name a timed row of a kernel phase.
ROW_KEYS = ("shape", "boxes", "case", "P", "dtype")


def summarize(log):
    """{"kernels": {name: ms}, "rows": {row: ms}, "medians": {path: s}} of
    one run's output; a row is a timed line of a kernel phase, named by its
    kernel and ROW_KEYS, and its device-only time, where the line has one,
    a row of its own."""
    kernels, rows = {}, {}
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            kernels = {k["name"]: k["ms"] for k in json.loads(line)["kernels"]}
        elif line.startswith('{"kernel"') and '"kernel_ms"' in line:
            row = json.loads(line)
            name = " ".join([row["kernel"]] + [str(row[k]) for k in ROW_KEYS
                                               if k in row])
            rows[name] = row["kernel_ms"]
            if "device_ms" in row:
                rows[name + " (device)"] = row["device_ms"]
    medians = {m.group(1): float(m.group(2)) for m in MEDIAN.finditer(log)}
    return {"kernels": kernels, "rows": rows, "medians": medians}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", help="unpacked tree of the parent commit")
    parser.add_argument("change", help="unpacked tree of the change")
    parser.add_argument("--out", default=os.path.join("build", "ab"),
                        help="directory for the runs' logs")
    parser.add_argument("--timeout", type=float, default=600,
                        help="seconds allowed for each run")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for run, which in ORDER:
        tree = (args.parent, args.change)[which]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                                  capture_output=True, text=True,
                                  timeout=args.timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        with open(os.path.join(args.out, "ab_%s.log" % run), "w") as f:
            f.write(out + err)
        failed += rc != 0
        print(json.dumps({"run": run, "tree": tree, "rc": rc,
                          "seconds": time.perf_counter() - t0,
                          **summarize(out)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
