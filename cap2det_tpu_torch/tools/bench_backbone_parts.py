"""Fine-grained timing of the InceptionV2 first stage on the card (port of
``tools/bench_backbone_parts.py``): the stem's pieces, each Mixed block
at its shape in the bench step (batch 2, a 1024x1536 canvas), the first
stage's pools alone, and raw convolutions as references for what the
card does on a plain conv. One JSON line per part, under the JAX tool's
part names; the raw convolutions carry their TFLOP/s.

The JAX tool times the stem on an RGB image, as here. Left out are the
parts that exist only for the TPU's layouts, which the port does not
use and the JAX tool does not time either: the stem on the host-packed
space-to-depth canvas (``_s2d_pack_weights``' regrouped stride-1 conv),
and each block's merged leading 1x1 convolutions. ``stem_sep7x7_s2``
times the port's stem, the separable 7x7 composed into one dense conv
(``inception_v2.prepare``), and ``reduce_window_max_4e`` times PyTorch's
own max-pool (``F.max_pool2d``, implicit padding) where JAX timed
``lax.reduce_window``.

    python -m cap2det_tpu_torch.tools.bench_backbone_parts [--steps N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

BATCH = 2
H, W = 1024, 1536
ROUNDS = 3
# (height, width, cin, cout, kernel) of the raw stride-1 SAME convolutions.
RAW_CONVS = [
    (256, 384, 64, 192, 3),
    (64, 96, 576, 192, 3),
    (64, 96, 576, 576, 1),
    (128, 192, 256, 256, 3),
]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10,
                        help="calls per timed round")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cap2det_tpu_torch.kernels import pool_grad
    from cap2det_tpu_torch.models import inception_v2 as iv2

    device = params_lib.resolve_device(args.device)
    fields = benchlib.device_fields(device)
    rs = np.random.RandomState(0)
    results = {}

    def record(name, fn, flops=None):
        def run():
            with torch.no_grad():
                return fn()
        timing = benchlib.time_rounds(run, device, args.steps, ROUNDS)
        results[name] = timing["ms"]
        line = {"part": name, **timing}
        if flops:
            line["tflops_per_s"] = flops / (timing["ms"] / 1e3) / 1e12
        benchlib.json_line({**line, **fields})

    def bf(nchw):
        """A bfloat16 NCHW activation in channels_last memory."""
        return torch.from_numpy(rs.normal(0, 1, nchw).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)

    tree = params_lib.from_jax_numpy(
        iv2.init_first_stage_params_numpy(np.random.default_rng(0)), device)
    params = iv2.prepare(tree, torch.bfloat16)["InceptionV2"]

    # Raw convolutions: what does the card do on a plain conv?
    for hh, ww, cin, cout, k in RAW_CONVS:
        x, weight = bf((BATCH, cin, hh, ww)), bf((cout, cin, k, k))
        record("conv%dx%d_%dx%d_%d_%d" % (k, k, hh, ww, cin, cout),
               lambda x=x, weight=weight, k=k: F.conv2d(x, weight,
                                                        padding=k // 2),
               flops=2 * BATCH * hh * ww * cin * cout * k * k)

    # The stem's pieces.
    img = bf((BATCH, 3, H, W))
    record("stem_sep7x7_s2",
           lambda: iv2._conv_relu(params["Conv2d_1a_7x7"], img, 2))
    x1 = bf((BATCH, 64, H // 2, W // 2))
    record("stem_maxpool1", lambda: pool_grad.pool_dense(x1, "pool_max", 3, 2))
    x2 = bf((BATCH, 64, H // 4, W // 4))
    record("stem_conv2b_2c", lambda: iv2._conv_relu(
        params["Conv2d_2c_3x3"],
        iv2._conv_relu(params["Conv2d_2b_1x1"], x2, 1), 1))
    x3 = bf((BATCH, 192, H // 4, W // 4))
    record("stem_maxpool2", lambda: pool_grad.pool_dense(x3, "pool_max", 3, 2))

    # Each Mixed block at its shape.
    inputs = {"Mixed_3b": (H // 8, W // 8, 192),
              "Mixed_3c": (H // 8, W // 8, 256),
              "Mixed_4a": (H // 8, W // 8, 320),
              "Mixed_4b": (H // 16, W // 16, 576),
              "Mixed_4c": (H // 16, W // 16, 576),
              "Mixed_4d": (H // 16, W // 16, 576),
              "Mixed_4e": (H // 16, W // 16, 576)}
    for name, (hh, ww, cin) in inputs.items():
        x = bf((BATCH, cin, hh, ww))
        record(name, lambda x=x, name=name: iv2._block(
            params[name], iv2._BLOCKS_FIRST[name], x, pool_grad.pool_dense))

    # The pools alone at Mixed_4e's input shape.
    xp = bf((BATCH, 576, H // 16, W // 16))
    record("pool_avg_3x3_s1_4e", lambda: pool_grad.pool_dense(xp, "pool_avg", 3, 1))
    record("pool_max_3x3_s1_4e", lambda: pool_grad.pool_dense(xp, "pool_max", 3, 1))
    record("reduce_window_max_4e", lambda: F.max_pool2d(xp, 3, 1, padding=1))
    return results


if __name__ == "__main__":
    main()
