"""Writes the small TensorFlow checkpoints the port's checkpoint reader is
tested on: a few InceptionV2-named variables at their real shapes (one of
them partitioned in two slices), a variable partitioned in three slices at
offsets that take two-byte keys, a float64, an int32 and the int64
``global_step``, saved by TensorFlow's own Saver in the V1 format (one
table file) and the V2 format (an index and one data shard), with the
arrays they hold in ``expected.npz``.

It needs TensorFlow and lies beside the fixtures, outside the port: the
port's reader (``cap2det_tpu_torch/utils/tf_checkpoint.py``) and its
converter never need TensorFlow.

    python tests/data_torch/write_tf_checkpoint_fixtures.py \\
        --output_dir tests/data_torch/tf_checkpoint
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SHAPES = {
    "InceptionV2/Conv2d_1a_7x7/depthwise_weights": (7, 7, 3, 8),
    "InceptionV2/Conv2d_1a_7x7/pointwise_weights": (1, 1, 24, 64),
    "InceptionV2/Conv2d_1a_7x7/BatchNorm/beta": (64,),
    "InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_mean": (64,),
    "InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_variance": (64,),
    # Kept out by the converter: not a weight or BatchNorm suffix, or not
    # under InceptionV2/.
    "InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_mean/ExponentialMovingAverage":
        (64,),
    "InceptionV2/Logits/Conv2d_1c_1x1/biases": (16,),
    "Other/weights": (3, 5),
    "Other/partitioned": (300, 2),
}
# name -> partitions per axis.
PARTITIONED = {"InceptionV2/Conv2d_1a_7x7/depthwise_weights": [1, 1, 1, 2],
               "Other/partitioned": [3, 1]}
FORMATS = {"V1": "v1/inception_v2.ckpt", "V2": "v2/inception_v2.ckpt"}


def expected_arrays(seed):
    rng = np.random.default_rng(seed)
    arrays = {name: rng.standard_normal(shape).astype(np.float32)
              for name, shape in SHAPES.items()}
    arrays["InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_variance"] = np.abs(
        arrays["InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_variance"])
    arrays["Other/float64"] = rng.standard_normal((2, 3))
    arrays["Other/int32"] = rng.integers(-1000, 1000, 5).astype(np.int32)
    arrays["global_step"] = np.array(123456789012, np.int64)
    return arrays


def write(output_dir, seed=0):
    import tensorflow as tf
    from tensorflow.core.protobuf import saver_pb2

    arrays = expected_arrays(seed)
    versions = {"V1": saver_pb2.SaverDef.V1, "V2": saver_pb2.SaverDef.V2}
    for fmt, rel in FORMATS.items():
        path = os.path.join(output_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with tf.Graph().as_default():
            variables = []
            for name, value in arrays.items():
                if name in PARTITIONED:
                    var = tf.compat.v1.get_variable(
                        name, initializer=tf.constant(value),
                        partitioner=lambda shape, dtype, parts=PARTITIONED[
                            name]: parts)
                elif name == "global_step":
                    var = tf.compat.v1.Variable(
                        value, name=name, dtype=tf.int64)
                else:
                    var = tf.compat.v1.Variable(value, name=name)
                variables.append(var)
            saver = tf.compat.v1.train.Saver(
                var_list=variables, write_version=versions[fmt])
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                saver.save(sess, os.path.abspath(path),
                           write_meta_graph=False, write_state=False)
    np.savez(os.path.join(output_dir, "expected.npz"), **arrays)
    return arrays


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    write(args.output_dir, args.seed)
    print("wrote V1 and V2 checkpoints and expected.npz to %s"
          % args.output_dir)


if __name__ == "__main__":
    main()
