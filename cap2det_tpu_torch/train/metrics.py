"""Metrics logging: JSONL scalars + optional TensorBoard event files
(the port's copy of ``cap2det_tpu/train/metrics.py``).

The reference writes TensorBoard summaries (train/trainer.py:54-61). The
writer always writes a greppable ``metrics.jsonl`` and, when
``torch.utils.tensorboard`` imports, event files too.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, model_dir, jsonl_name="metrics.jsonl", tb_name="tb"):
        """Writes scalars to <model_dir>/<jsonl_name> and TB events to
        <model_dir>/<tb_name>. The evaluator daemon uses a second instance
        with its own file names so train and eval curves live side by side
        in one TensorBoard (reference train/predict.py:491-496)."""
        os.makedirs(model_dir, exist_ok=True)
        self._jsonl = open(os.path.join(model_dir, jsonl_name), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=os.path.join(model_dir, tb_name))
        except ImportError:
            self._tb = None

    def write(self, step, scalars):
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
