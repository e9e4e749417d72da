"""Synthesizes the passthrough 'pretrained' backbone checkpoint (the port's
counterpart of ``tools/make_passthrough_checkpoint.py``).

Stand-in for the ImageNet InceptionV2 warm start where no converted
checkpoint is at hand (see ``utils/passthrough_init.py``): written in the
``tools/convert_tf_checkpoint.py`` output format, so
``--pretrained_checkpoint`` takes the path a real converted checkpoint
takes (``models/frcnn.load_pretrained``).

  python -m cap2det_tpu_torch.tools.make_passthrough_checkpoint \\
      --output /path/passthrough.pt [--seed 0]
"""

from __future__ import annotations

import argparse

import numpy as np


def passthrough_tree(seed):
    """{'InceptionV2': ...} passthrough weights of both stages, in the JAX
    layout, over an init drawn by numpy from `seed` (the passthrough
    overwrites every conv and BatchNorm leaf, so the tree depends on the
    draw only through leaves the passthrough keeps)."""
    from cap2det_tpu_torch.models import inception_v2
    from cap2det_tpu_torch.utils.passthrough_init import make_passthrough

    rng = np.random.default_rng(seed)
    iv2 = {}
    iv2.update(make_passthrough(
        inception_v2.init_first_stage_params_numpy(rng)["InceptionV2"]))
    iv2.update(make_passthrough(
        inception_v2.init_second_stage_params_numpy(rng)["InceptionV2"]))
    return {"InceptionV2": iv2}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def check_overlay(path, seed):
    """Overlays the file onto a fresh model's params, as the trainer's
    ``--pretrained_checkpoint`` does; raises unless every overlaid layer
    keeps its leaves' names and shapes."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import pbtxt, schema
    from cap2det_tpu_torch.models import frcnn
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    options = schema.FRCNN.from_dict(pbtxt.parse(
        "feature_extractor { type: 'faster_rcnn_inception_v2' }"))
    params = params_lib.from_jax_numpy(
        frcnn.init_params_numpy(seed, options), "cpu")
    loaded = frcnn.load_pretrained(params, params_lib.from_jax_numpy(
        ckpt_lib.restore_params(path), "cpu"))
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        before = {k: tuple(v.shape) for k, v in _leaves(params[scope])}
        after = {k: tuple(v.shape) for k, v in _leaves(loaded[scope])}
        if before != after:
            raise ValueError("the passthrough checkpoint does not fit %s: %s"
                             % (scope, sorted(set(before.items())
                                              ^ set(after.items()))[:5]))
    return loaded


def write(output, seed=0):
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    tree = passthrough_tree(seed)
    ckpt_lib.save_params(output, params_lib.from_jax_numpy(tree, "cpu"))
    # Sanity: the overlay path accepts it.
    check_overlay(output, seed)
    return tree


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    write(args.output, args.seed)
    print("passthrough checkpoint written to %s" % args.output)


if __name__ == "__main__":
    main()
