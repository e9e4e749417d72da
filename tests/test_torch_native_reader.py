"""The port's native TFRecord reader (``native.read_records_native`` over
``csrc/host/tfrecord_reader.cc``, the port's copy of
``native/tfrecord_reader.cc``, built by g++ into ``build/torch_host/``;
the committed ``native/libcap2det_native.so`` is never loaded), which the
training feed reads every record with:

* the same bytes as the JAX package's Python reader and the port's own,
  with and without readahead and CRC checks: an empty file, one record,
  many records with a 0-byte one and one over 1 MB;
* with ``verify_crc`` a flipped payload or length byte raises IOError
  where the Python reader raises; a file cut inside a record raises;
* ``InputPipeline`` gives the same batches for a seed as through the
  Python reader, and the feed has no quiet fallback: a host library that
  cannot be built raises, in the caller, before the worker starts;
* the source is ``native/tfrecord_reader.cc`` byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from cap2det_tpu.data import tfrecord as jax_tfrecord
from cap2det_tpu_torch import native
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline, synthetic, tfrecord
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.text import extractors

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(kind):
    rng = np.random.default_rng(7)
    if kind == "empty":
        return []
    if kind == "one":
        return [rng.bytes(1000)]
    # More records than the readahead thread queues (64), a 0-byte one
    # and one over 1 MB.
    small = [rng.bytes(n) for n in (0, 1, 7, 8, 9, 1500, 0, 64, 300)] * 10
    return small[:40] + [rng.bytes(2 ** 20 + 5)] + small[40:]


def _write(path, records):
    with tfrecord.TFRecordWriter(str(path)) as w:
        for r in records:
            w.write(r)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    directory = tmp_path_factory.mktemp("files")
    return {kind: (_write(directory / (kind + ".tfrecord"), _records(kind)),
                   _records(kind)) for kind in ("empty", "one", "many")}


@pytest.mark.parametrize("verify_crc", [False, True], ids=["nocrc", "crc"])
@pytest.mark.parametrize("readahead", [True, False],
                         ids=["readahead", "direct"])
@pytest.mark.parametrize("kind", ["empty", "one", "many"])
def test_same_bytes_as_the_python_readers(files, kind, readahead,
                                          verify_crc):
    path, records = files[kind]
    got = list(native.read_records_native(path, verify_crc=verify_crc,
                                          readahead=readahead))
    assert got == list(jax_tfrecord.read_records(path, verify_crc))
    assert got == list(tfrecord.read_records(path, verify_crc))
    assert got == records


def test_reader_stopped_early_closes_its_thread(files):
    path, records = files["many"]
    it = native.read_records_native(path)
    assert next(it) == b""
    it.close()  # joins the readahead thread; a hang would time the test out
    assert list(native.read_records_native(path))[:2] == records[:2]


@pytest.mark.parametrize("where", ["payload", "length"])
@pytest.mark.parametrize("readahead", [True, False],
                         ids=["readahead", "direct"])
def test_a_corrupt_record_raises_with_crc_checks(tmp_path, where,
                                                 readahead):
    records = [b"first record", b"second record payload", b"third"]
    path = _write(tmp_path / "r.tfrecord", records)
    data = bytearray(open(path, "rb").read())
    second = 8 + 4 + len(records[0]) + 4  # the second record's offset
    data[second + (12 + 3 if where == "payload" else 0)] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(jax_tfrecord.read_records(path, verify_crc=True))
    with pytest.raises(IOError):
        list(tfrecord.read_records(path, verify_crc=True))
    with pytest.raises(IOError, match="corrupt"):
        list(native.read_records_native(path, verify_crc=True,
                                        readahead=readahead))
    # Without the checks all three read the same (wrong) bytes.
    if where == "payload":
        got = list(native.read_records_native(path, readahead=readahead))
        assert got == list(tfrecord.read_records(path))
        assert got[0] == records[0] and got[1] != records[1]


@pytest.mark.parametrize("cut", [5, 1])
@pytest.mark.parametrize("readahead", [True, False],
                         ids=["readahead", "direct"])
def test_a_truncated_file_raises(tmp_path, cut, readahead):
    """Cut inside the last record's payload or its footer: every reader
    raises after yielding the whole records."""
    records = [b"a" * 100, b"b" * 2000]
    path = _write(tmp_path / "r.tfrecord", records)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) - cut - (100 if cut == 5 else 0)])
    for reader in (tfrecord.read_records, jax_tfrecord.read_records):
        with pytest.raises(IOError, match="truncated"):
            list(reader(path))
    got = []
    with pytest.raises(IOError, match="corrupt"):
        for record in native.read_records_native(path, readahead=readahead):
            got.append(record)
    assert got == records[:1]


def test_a_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        list(native.read_records_native(str(tmp_path / "nope.tfrecord")))


def test_the_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "native", "tfrecord_reader.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "cap2det_tpu_torch", "csrc", "host",
                           "tfrecord_reader.cc"), "rb") as f:
        assert f.read() == want
    native.load()
    assert build.host_build_info["sources"] == [
        "cap2det_tpu_torch/csrc/host/selective_search.cc",
        "cap2det_tpu_torch/csrc/host/tfrecord_reader.cc"]


CLASSES = ["person", "dog", "car"]
_READER = """train_reader { cap2det_reader {
  input_pattern: "%s"
  is_training: true
  shuffle_buffer_size: 4
  batch_size: 2
  image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
  preprocess_options { random_flip_left_right_prob: 0.5 }
  max_num_proposals: 16
  batch_resize_scale_value: 1.0
  batch_resize_scale_value: 0.5
} }"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    directory = tmp_path_factory.mktemp("records")
    for name, hw, seed in (("land", (72, 100), 1), ("port", (100, 72), 2)):
        synthetic.write_synthetic_dataset(
            str(directory / ("train-%s.record" % name)), num_examples=7,
            seed=seed, classes=CLASSES, image_hw=hw, num_proposals=20)
    label_file = synthetic.write_label_file(str(directory / "labels.txt"),
                                            CLASSES)
    return str(directory / "train-*.record"), label_file


def _pipeline(records):
    pattern, label_file = records
    reader = schema.loads_pipeline(_READER % pattern).train_reader
    return pipeline.InputPipeline(
        reader.cap2det_reader,
        label_extractor=extractors.build_label_extractor(
            schema.LabelExtractor.from_dict(
                {"groundtruth_extractor": {"label_file": label_file}})),
        seed=5)


def _batches(pipe, n=10):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_the_pipeline_gives_the_python_readers_batches(records, monkeypatch):
    read = []
    real = native.read_records_native
    monkeypatch.setattr(native, "read_records_native",
                        lambda path: read.append(path) or real(path))
    got = _batches(_pipeline(records))
    assert read  # the feed read through the native reader
    monkeypatch.setattr(native, "read_records_native",
                        lambda path: tfrecord.read_records(path))
    want = _batches(_pipeline(records))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        assert g[InputFields.image_id] == w[InputFields.image_id], i
        for key in (InputFields.image, InputFields.proposals,
                    InputFields.num_proposals, InputFields.pseudo_labels):
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg="batch %d %s" % (i, key))


def test_no_quiet_fallback(records, monkeypatch):
    """A host library that cannot be built raises in the feed, and in the
    worker feed's caller before any worker starts."""
    def fail():
        raise RuntimeError("no host C++ compiler found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "host_library", fail)
    with pytest.raises(RuntimeError, match="no host C"):
        next(iter(_pipeline(records).example_stream()))
    started = []
    monkeypatch.setattr(torch.utils.data, "DataLoader",
                        lambda *a, **k: started.append(1))
    with pytest.raises(RuntimeError, match="no host C"):
        next(pipeline.in_worker_process(_pipeline(records), "cpu"))
    assert not started
