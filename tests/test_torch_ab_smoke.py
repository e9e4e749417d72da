"""The parent-against-change driver's reading of a chip_smoke.py log."""

import json

import torch

from cap2det_tpu_torch.tools import ab_smoke

torch.set_num_threads(1)


def test_summarize_reads_kernels_rows_and_medians():
    log = "\n".join([
        "build: compiled in 3.1 s",
        json.dumps({"kernel": "avgpool_grad", "shape": "Mixed_5b avg 3/s1",
                    "case": "normal", "dtype": "bfloat16",
                    "max_abs_err": 0.0, "kernel_ms": 0.046,
                    "device_ms": 0.035}),
        json.dumps({"kernel": "avgpool_grad", "shape": "Mixed_5b avg 3/s1",
                    "case": "normal", "dtype": "float32",
                    "max_abs_err": 0.0}),
        json.dumps({"kernel": "roi_crop_maxpool_grad", "boxes": "wide",
                    "dtype": "bfloat16", "kernel_ms": 0.92}),
        "serve: seconds per image over 12 images: median 0.25, min 0.2",
        "train coco17_extend_match: seconds per step over 12 steps: "
        "median 0.0304, min 0.03",
        json.dumps({"kernels": [{"name": "avgpool_grad", "ms": 0.031},
                                {"name": "pool_fwd", "ms": 0.176}]}),
        "NVIDIA H100 80GB HBM3, 700.00 W",
    ])
    assert ab_smoke.summarize(log) == {
        "kernels": {"avgpool_grad": 0.031, "pool_fwd": 0.176},
        "rows": {"avgpool_grad Mixed_5b avg 3/s1 normal bfloat16": 0.046,
                 "avgpool_grad Mixed_5b avg 3/s1 normal bfloat16 (device)":
                 0.035,
                 "roi_crop_maxpool_grad wide bfloat16": 0.92},
        "medians": {"serve": 0.25, "train coco17_extend_match": 0.0304},
    }


def test_runs_alternate_parent_and_change():
    assert [which for _, which in ab_smoke.ORDER] == [0, 1, 1, 0]
