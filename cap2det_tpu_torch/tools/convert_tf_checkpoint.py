"""Converts a TF-slim InceptionV2 classification checkpoint to the params
tree the port warm-starts from, without TensorFlow (the port's counterpart
of ``tools/convert_tf_checkpoint.py``).

The reference warm-starts both backbone stages from
``zoo/inception_v2_2016_08_28/inception_v2.ckpt`` via
``tf.train.init_from_checkpoint`` scope remaps (models/utils.py:181-186).
This tool reads that checkpoint, V1 or V2, with the port's own reader
(``utils/tf_checkpoint.py``), keeps the ``InceptionV2/`` weights and
BatchNorm statistics, and writes ``{'InceptionV2': {layer: {'weights'|
'depthwise_weights'|..., 'BatchNorm': {...}}}}`` in the JAX layout with
``train/checkpoint.save_params``: ``--pretrained_checkpoint`` reads it
(``models/frcnn.load_pretrained``), and ``params.from_jax_numpy`` does the
transposing into the port's layout.

Usage:
  python -m cap2det_tpu_torch.tools.convert_tf_checkpoint \\
      --checkpoint zoo/inception_v2_2016_08_28/inception_v2.ckpt \\
      --output zoo/inception_v2_torch.pt
"""

from __future__ import annotations

import argparse

import numpy as np

from cap2det_tpu_torch.utils import tf_checkpoint

_SUFFIXES = (
    "weights",
    "depthwise_weights",
    "pointwise_weights",
    "biases",
    "BatchNorm/beta",
    "BatchNorm/gamma",
    "BatchNorm/moving_mean",
    "BatchNorm/moving_variance",
)


def read_tf_checkpoint(path):
    """Returns {variable_name: np.ndarray} from a TF checkpoint."""
    return tf_checkpoint.read_checkpoint(path)


def variables_to_tree(variables, root="InceptionV2"):
    """Nests slash-delimited variable names into the params-tree layout."""
    tree = {}
    for name, value in variables.items():
        if not name.startswith(root + "/"):
            continue
        if not name.endswith(_SUFFIXES):
            continue
        parts = name.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.astype(np.float32)
    return tree


def convert(checkpoint_path, output_path):
    variables = read_tf_checkpoint(checkpoint_path)
    tree = variables_to_tree(variables)
    if "InceptionV2" not in tree:
        raise ValueError(
            "checkpoint has no InceptionV2/ variables: %s"
            % sorted(variables)[:10]
        )
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    ckpt_lib.save_params(output_path, params_lib.from_jax_numpy(tree, "cpu"))
    n = sum(1 for _ in _iter_leaves(tree))
    print("converted %d tensors -> %s" % (n, output_path))
    return tree


def _iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args()
    convert(args.checkpoint, args.output)


if __name__ == "__main__":
    main()
