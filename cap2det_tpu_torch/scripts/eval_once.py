"""One evaluation of the newest checkpoint (the port's counterpart of
``scripts/eval_once.sh``).

  python -m cap2det_tpu_torch.scripts.eval_once <config-name> \\
      [model_dir] [extra evaluate_main args...] [--device cuda|cpu]

Runs ``cli.evaluate_main --run_once`` on ``configs/<config-name>.pbtxt``
(read from the working directory) and ``model_dir`` (default
``logs/<config-name>``), and exits with its exit code.
"""

from __future__ import annotations

import os
import subprocess
import sys

from cap2det_tpu_torch.scripts import steps, train


def main(argv=None):
    args, extra = train.parse(argv, "eval_once")
    cmd = steps.command(
        "cap2det_tpu_torch.cli.evaluate_main",
        "--pipeline_proto", os.path.join("configs", "%s.pbtxt" % args.name),
        "--model_dir", args.model_dir, "--run_once",
        "--device", args.device, *extra)
    return subprocess.run(cmd, env=steps.env()).returncode


if __name__ == "__main__":
    sys.exit(main())
