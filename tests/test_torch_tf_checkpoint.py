"""The port's TensorFlow-free checkpoint reader
(``cap2det_tpu_torch/utils/tf_checkpoint.py``) and converter
(``cap2det_tpu_torch/tools/convert_tf_checkpoint.py``).

Without TensorFlow: the committed V1 and V2 fixtures
(``tests/data_torch/tf_checkpoint``, written by
``tests/data_torch/write_tf_checkpoint_fixtures.py``) read back as the
arrays they were written from, partitioned variables and
int64/int32/float64 entries included; OrderedCode keys and snappy blocks
(literals and copies) are checked on hand-made data; a flipped byte fails
its crc; a subprocess converts with TensorFlow refused.

With TensorFlow (``tf_interop``, as ``tests/test_converter.py``): the full
InceptionV2 variable set written by TensorFlow in V1 and in V2 converts to
a tree equal, leaf for leaf and bit for bit, to the JAX converter's
``variables_to_tree`` over TensorFlow's own reader; the tree overlaid by
the port's ``load_pretrained`` equals the JAX overlay leaf for leaf and
bit for bit, and its first-stage features agree with JAX's within RTOL/ATOL (float32 through
~20 convolutions summed in another order by XLA and by PyTorch, as in
``tests/test_torch_inception.py``). Every other comparison is exact.
"""

import importlib.util
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from cap2det_tpu_torch.tools import convert_tf_checkpoint
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.utils import tf_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data_torch", "tf_checkpoint")
PATHS = {"V1": os.path.join(FIXTURES, "v1", "inception_v2.ckpt"),
         "V2": os.path.join(FIXTURES, "v2", "inception_v2.ckpt")}
RTOL, ATOL = 1e-4, 1e-4


def _expected():
    return dict(np.load(os.path.join(FIXTURES, "expected.npz")))


def _jax_conv():
    """The JAX package's tools/convert_tf_checkpoint.py."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import convert_tf_checkpoint

    return convert_tf_checkpoint


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _assert_trees_equal(got, want):
    got = {k: np.asarray(v) for k, v in _leaves(got)}
    want = {k: np.asarray(v) for k, v in _leaves(want)}
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert got[name].shape == value.shape, name
        assert np.array_equal(got[name], value), name


@pytest.mark.parametrize("fmt", ["V1", "V2"])
def test_fixture_reads_as_written(fmt):
    want = _expected()
    got = tf_checkpoint.read_checkpoint(PATHS[fmt])
    assert tf_checkpoint.checkpoint_format(PATHS[fmt]) == fmt
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert np.array_equal(got[name], value), name
    assert int(got["global_step"]) == 123456789012


@pytest.mark.parametrize("fmt", ["V1", "V2"])
def test_fixture_converts_to_the_jax_tree(fmt, tmp_path):
    want = _jax_conv().variables_to_tree(_expected())
    out = str(tmp_path / "converted.pt")
    got = convert_tf_checkpoint.convert(PATHS[fmt], out)
    _assert_trees_equal(got, want)
    _assert_trees_equal(ckpt_lib.restore_params(out), want)
    names = dict(_leaves(got))
    assert "InceptionV2/Conv2d_1a_7x7/BatchNorm/moving_mean" in names
    assert not any("ExponentialMovingAverage" in n or n.startswith("Other")
                   for n in names)


def test_a_checkpoint_without_inception_v2_is_refused(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(convert_tf_checkpoint, "read_tf_checkpoint",
                        lambda path: {"Other/weights": np.zeros(3)})
    with pytest.raises(ValueError, match="no InceptionV2/"):
        convert_tf_checkpoint.convert("unused", str(tmp_path / "out.pt"))
    with pytest.raises(FileNotFoundError):
        tf_checkpoint.read_checkpoint(str(tmp_path / "missing"))


# (value, bytes) of TensorFlow's OrderedCode::WriteSignedNumIncreasing.
SIGNED = [(0, b"\x80"), (1, b"\x81"), (-1, b"\x7f"), (63, b"\xbf"),
          (-64, b"\x40"), (64, b"\xc0\x40"), (-65, b"\x3f\xbf"),
          (8191, b"\xdf\xff"), (-8192, b"\x20\x00"), (8192, b"\xe0\x20\x00"),
          (-8193, b"\x1f\xdf\xff")]


@pytest.mark.parametrize("value,encoded", SIGNED,
                         ids=[str(v) for v, _ in SIGNED])
def test_signed_ordered_code(value, encoded):
    assert tf_checkpoint._signed_num_increasing(value) == encoded


@pytest.mark.parametrize("fmt", ["V1", "V2"])
def test_slice_keys_are_tensorflows(fmt):
    """Every slice key TensorFlow wrote is the encoding of a tensor name
    and slice, a name with 0x00 and 0xff bytes escaped included."""
    path = PATHS[fmt] + (".index" if fmt == "V2" else "")
    keys = {k for k in tf_checkpoint.read_table(path) if k[:1] == b"\x00"}
    # A partitioned variable's slices give every extent in full; a whole
    # tensor's (V1) gives none, each dimension then 0 and -1.
    ours = {tf_checkpoint.encode_tensor_name_slice(
        "Other/partitioned", [(start, 100), (0, 2)])
        for start in (0, 100, 200)}
    ours |= {tf_checkpoint.encode_tensor_name_slice(
        "InceptionV2/Conv2d_1a_7x7/depthwise_weights",
        [(0, 7), (0, 7), (0, 3), (start, 4)]) for start in (0, 4)}
    if fmt == "V1":
        ours |= {tf_checkpoint.encode_tensor_name_slice(name, [(0, -1)] * (
            value.ndim)) for name, value in _expected().items()
            if not name.endswith("partitioned") and "depthwise" not in name}
        assert ours == keys
    else:
        assert ours <= keys
    assert tf_checkpoint._string_increasing(b"a\x00b\xffc") == (
        b"a\x00\xffb\xff\x00c\x00\x01")


def _snappy_reference():
    """A hand-made snappy stream and what it decodes to: a short literal,
    a 1-byte-offset copy that overlaps itself, a 2-byte-offset copy, a
    literal whose length takes an extra byte, a 4-byte-offset copy."""
    parts, out = [], bytearray()
    parts.append(bytes([(5 - 1) << 2]) + b"abcde")
    out += b"abcde"
    # copy, 1-byte offset: length 4 + 7 = 11, offset 2 (overlapping).
    parts.append(bytes([1 | (7 << 2) | (0 << 5), 2]))
    for _ in range(11):
        out.append(out[-2])
    # copy, 2-byte offset: length 20, offset 16.
    parts.append(bytes([2 | ((20 - 1) << 2)]) + struct.pack("<H", 16))
    for _ in range(20):
        out.append(out[-16])
    literal = bytes(range(200))
    parts.append(bytes([60 << 2, len(literal) - 1]) + literal)
    out += literal
    # copy, 4-byte offset: length 33, offset 230.
    parts.append(bytes([3 | ((33 - 1) << 2)]) + struct.pack("<I", 230))
    for _ in range(33):
        out.append(out[-230])
    return _varint(len(out)), b"".join(parts), bytes(out)


def _varint(value):
    from cap2det_tpu_torch.data.tf_example import _encode_varint

    return _encode_varint(value)


def test_snappy_decodes_literals_and_copies():
    length, body, want = _snappy_reference()
    assert tf_checkpoint.snappy_decompress(length + body) == want
    with pytest.raises(tf_checkpoint.CheckpointError, match="offset"):
        tf_checkpoint.snappy_decompress(_varint(4) + bytes(
            [1, 9]))  # a copy before anything was written
    with pytest.raises(tf_checkpoint.CheckpointError, match="announced"):
        tf_checkpoint.snappy_decompress(length + body + b"\x00a")


def _block(entries):
    """One table block, every entry a restart point."""
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += _varint(0) + _varint(len(key))
        body += _varint(len(value)) + key + value
    for r in restarts:
        body += struct.pack("<I", r)
    return bytes(body + struct.pack("<I", len(restarts)))


def _write_table(path, entries, compress=None, kind=None):
    """A table file: one data block (stored as `compress` gives it, with
    compression type `kind`), an empty metaindex, the index, the
    footer."""
    raw = bytearray()

    def put(contents, block_kind):
        offset = len(raw)
        trailer = bytes([block_kind])
        crc = tf_checkpoint._masked_crc(contents + trailer)
        raw.extend(contents + trailer + struct.pack("<I", crc))
        return _varint(offset) + _varint(len(contents))

    data = _block(entries)
    handle = put(compress(data) if compress else data,
                 kind if kind is not None else (1 if compress else 0))
    meta = put(_block([]), 0)
    index = put(_block([(entries[-1][0], handle)]), 0)
    footer = (meta + index).ljust(40, b"\x00")
    footer += struct.pack("<II", tf_checkpoint.TABLE_MAGIC & 0xFFFFFFFF,
                          tf_checkpoint.TABLE_MAGIC >> 32)
    raw.extend(footer)
    with open(path, "wb") as f:
        f.write(raw)


def _literal_snappy(data):
    """Snappy of `data` as one literal with a two-byte length."""
    return (_varint(len(data)) + bytes([61 << 2])
            + struct.pack("<H", len(data) - 1) + data)


def test_table_reads_a_snappy_block_and_refuses_another_type(tmp_path):
    entries = [(b"", b"header"), (b"alpha", b"x" * 50),
               (b"beta", bytes(range(256)))]
    _write_table(str(tmp_path / "plain"), entries)
    _write_table(str(tmp_path / "snappy"), entries, _literal_snappy)
    want = dict(entries)
    assert tf_checkpoint.read_table(str(tmp_path / "plain")) == want
    assert tf_checkpoint.read_table(str(tmp_path / "snappy")) == want
    _write_table(str(tmp_path / "zstd"), entries, _literal_snappy, kind=2)
    with pytest.raises(tf_checkpoint.CheckpointError,
                       match="block at 0 has compression type 2"):
        tf_checkpoint.read_table(str(tmp_path / "zstd"))


def _v1_tensor(name, dtype_enum, shape, proto):
    """(meta entry, (key, value)) of one whole tensor in a V1 table;
    `proto` is its TensorProto's bytes."""
    from cap2det_tpu_torch.data.tf_example import _encode_len_delimited as ld
    from cap2det_tpu_torch.data.tf_example import _tag

    shape_proto = b"".join(ld(2, _tag(1, 0) + _varint(d)) for d in shape)
    meta = ld(1, name.encode()) + ld(2, shape_proto) + _tag(3, 0) + _varint(
        dtype_enum) + ld(4, b"")
    saved = ld(2, ld(1, name.encode()) + ld(2, b"") + ld(3, proto))
    key = tf_checkpoint.encode_tensor_name_slice(name, [(0, -1)] * len(shape))
    return ld(1, meta), (key, saved)


def test_v1_reads_unpacked_and_packed_values(tmp_path):
    """float_val and int64_val stored one field per value (unpacked), a
    float64 packed, and a tensor_content: all read as written."""
    from cap2det_tpu_torch.data.tf_example import _encode_len_delimited as ld
    from cap2det_tpu_torch.data.tf_example import _tag

    f32 = np.array([[1.5, -2.25, 3e-8], [0.0, -0.0, 7.0]], np.float32)
    i64 = np.array([-3, 0, 1 << 40], np.int64)
    f64 = np.array([np.pi, -1e300], np.float64)
    content = np.arange(6, dtype=np.float32).reshape(3, 2)
    tensors = [
        _v1_tensor("a/unpacked_f32", 1, f32.shape, b"".join(
            _tag(5, 5) + struct.pack("<f", v) for v in f32.ravel())),
        _v1_tensor("b/unpacked_i64", 9, i64.shape, b"".join(
            _tag(10, 0) + _varint(int(v) & ((1 << 64) - 1)) for v in i64)),
        _v1_tensor("c/packed_f64", 2, f64.shape, ld(6, f64.tobytes())),
        _v1_tensor("d/content", 1, content.shape, ld(4, content.tobytes())),
    ]
    entries = [(b"", ld(1, b"".join(m for m, _ in tensors)))]
    entries += sorted(e for _, e in tensors)
    _write_table(str(tmp_path / "v1.ckpt"), entries)
    got = tf_checkpoint.read_checkpoint(str(tmp_path / "v1.ckpt"))
    for name, want in [("a/unpacked_f32", f32), ("b/unpacked_i64", i64),
                       ("c/packed_f64", f64), ("d/content", content)]:
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        assert np.array_equal(got[name], want), name


@pytest.mark.parametrize("target", ["v2_data", "v2_index", "v1"])
def test_a_flipped_byte_fails_its_crc(target, tmp_path):
    import shutil

    for fmt in ("v1", "v2"):
        shutil.copytree(os.path.join(FIXTURES, fmt), tmp_path / fmt)
    name = {"v2_data": "v2/inception_v2.ckpt.data-00000-of-00001",
            "v2_index": "v2/inception_v2.ckpt.index",
            "v1": "v1/inception_v2.ckpt"}[target]
    path = tmp_path / name
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 3] ^= 0x10
    path.write_bytes(bytes(raw))
    prefix = str(tmp_path / ("v1" if target == "v1" else "v2")
                 / "inception_v2.ckpt")
    with pytest.raises(tf_checkpoint.CheckpointError, match="crc32c"):
        tf_checkpoint.read_checkpoint(prefix)


def test_converts_with_tensorflow_refused(tmp_path):
    """A fresh interpreter whose import of tensorflow raises converts both
    fixtures, and neither tensorflow nor jax is in sys.modules after."""
    script = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tensorflow", "jax"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from cap2det_tpu_torch.tools import convert_tf_checkpoint
for i, path in enumerate(sys.argv[1:3]):
    convert_tf_checkpoint.convert(path, sys.argv[3] + str(i))
bad = [m for m in sys.modules if m.split(".")[0] in ("tensorflow", "jax")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", script, PATHS["V1"], PATHS["V2"],
         str(tmp_path / "out")], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for i in range(2):
        assert os.path.getsize(str(tmp_path / "out") + str(i)) > 0


# ---------------------------------------------------------------------------
# TensorFlow-written InceptionV2 (tf_interop)
# ---------------------------------------------------------------------------


def _inception_values():
    """The full InceptionV2 variable set of the JAX model (both stages),
    He-scaled weights and valid BatchNorm statistics, plus global_step
    and a moving average the converter must drop."""
    import jax

    from cap2det_tpu.models import inception_v2

    rng = jax.random.PRNGKey(0)  # shapes only: eval_shape runs no init
    merged = dict(jax.eval_shape(inception_v2.init_first_stage_params,
                                 rng)["InceptionV2"])
    merged.update(jax.eval_shape(inception_v2.init_second_stage_params,
                                 rng)["InceptionV2"])
    rs = np.random.RandomState(0)
    values = {}
    for path, leaf in _leaves({"InceptionV2": merged}):
        shape = leaf.shape
        if path.endswith("moving_variance"):
            value = rs.uniform(0.5, 1.5, shape)
        elif len(shape) == 4:
            value = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        else:
            value = rs.randn(*shape) * 0.1
        values[path] = value.astype(np.float32)
    values["InceptionV2/Mixed_5c/Branch_0/Conv2d_0a_1x1/BatchNorm/beta/"
           "ExponentialMovingAverage"] = np.ones(3, np.float32)
    return values


@pytest.fixture(scope="module")
def tf_written(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    from tensorflow.core.protobuf import saver_pb2

    values = _inception_values()
    root = tmp_path_factory.mktemp("tf_inception")
    paths = {}
    for fmt, version in (("V1", saver_pb2.SaverDef.V1),
                         ("V2", saver_pb2.SaverDef.V2)):
        paths[fmt] = str(root / fmt / "inception_v2.ckpt")
        os.makedirs(os.path.dirname(paths[fmt]))
        with tf.Graph().as_default():
            var_list = [tf.compat.v1.Variable(v, name=n)
                        for n, v in values.items()]
            var_list.append(tf.compat.v1.train.get_or_create_global_step())
            saver = tf.compat.v1.train.Saver(var_list=var_list,
                                             write_version=version)
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                saver.save(sess, paths[fmt], write_meta_graph=False,
                           write_state=False)
    return values, paths


@pytest.mark.tf_interop
@pytest.mark.parametrize("fmt", ["V1", "V2"])
def test_tensorflow_written_inception_converts_as_jax(tf_written, fmt,
                                                      tmp_path):
    jax_conv = _jax_conv()
    values, paths = tf_written
    want = jax_conv.variables_to_tree(jax_conv.read_tf_checkpoint(
        paths[fmt]))
    out = str(tmp_path / "converted.pt")
    got = convert_tf_checkpoint.convert(paths[fmt], out)
    _assert_trees_equal(got, want)
    _assert_trees_equal(ckpt_lib.restore_params(out), want)
    assert len(dict(_leaves(got))) == len(values) - 1
    read = tf_checkpoint.read_checkpoint(paths[fmt])
    assert read["global_step"].dtype == np.int64


@pytest.mark.tf_interop
def test_overlay_gives_the_jax_first_stage(tf_written, tmp_path):
    import jax
    import jax.numpy as jnp

    from cap2det_tpu.models import frcnn as jax_frcnn
    from cap2det_tpu.models import inception_v2 as jax_inception
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import pbtxt, schema
    from cap2det_tpu_torch.models import frcnn, inception_v2

    _, paths = tf_written
    out = str(tmp_path / "converted.pt")
    convert_tf_checkpoint.convert(paths["V2"], out)
    text = ("feature_extractor { type: 'faster_rcnn_inception_v2' } "
            "initial_crop_size: 14 maxpool_kernel_size: 2 maxpool_stride: 2")

    # One init for both sides (the port's numpy init has the JAX init's
    # names and shapes), overlaid by each package's load_pretrained.
    cfg = schema.FRCNN.from_dict(pbtxt.parse(text))
    init = frcnn.init_params_numpy(1, cfg)
    jax_conv = _jax_conv()
    jax_params = jax_frcnn.load_pretrained(
        jax.tree.map(jnp.asarray, init),
        jax_conv.variables_to_tree(jax_conv.read_tf_checkpoint(paths["V2"])))
    loaded = frcnn.load_pretrained(
        params_lib.from_jax_numpy(init, "cpu"),
        params_lib.from_jax_numpy(ckpt_lib.restore_params(out), "cpu"))
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        _assert_trees_equal(params_lib.to_jax_numpy(loaded[scope]),
                            jax.tree.map(np.asarray, jax_params[scope]))
    # The JAX overlay replaces each layer whole and so drops the empty
    # blocks of the pool-only branches, which its own forward pass looks
    # up; put them back on the JAX side (the port's overlay keeps them).
    jax_params[jax_frcnn.FIRST_SCOPE]["InceptionV2"]["Mixed_4a"][
        "Branch_2"] = {}
    assert "Branch_2" in loaded[frcnn.FIRST_SCOPE]["InceptionV2"]["Mixed_4a"]

    canvas = np.random.default_rng(1).uniform(0, 255, (1, 64, 96, 3)).astype(
        np.float32)
    want = np.asarray(jax_inception.first_stage(
        jax_params[jax_frcnn.FIRST_SCOPE],
        jax_inception.preprocess(canvas), compute_dtype=jnp.float32))
    got = inception_v2.first_stage(
        inception_v2.prepare(loaded[frcnn.FIRST_SCOPE], torch.float32),
        inception_v2.preprocess(torch.from_numpy(canvas)))
    assert got.shape == want.shape == (1, 4, 6, 576)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.tf_interop
def test_committed_fixtures_are_what_the_writer_writes(tmp_path):
    pytest.importorskip("tensorflow")
    spec = importlib.util.spec_from_file_location(
        "write_tf_checkpoint_fixtures",
        os.path.join(ROOT, "tests", "data_torch",
                     "write_tf_checkpoint_fixtures.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    writer.write(str(tmp_path))
    for rel in ("expected.npz", "v1/inception_v2.ckpt",
                "v2/inception_v2.ckpt.index",
                "v2/inception_v2.ckpt.data-00000-of-00001"):
        with open(os.path.join(FIXTURES, rel), "rb") as f:
            assert (tmp_path / rel).read_bytes() == f.read(), rel
