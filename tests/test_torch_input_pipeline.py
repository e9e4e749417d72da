"""The port's training input pipeline against the JAX package's
``InputPipeline`` (``pack_s2d=False``): the same records at the same seed
give the same batches bit for bit.

The records hold both orientations (two files), more proposals than
``max_num_proposals`` in one file and fewer in the other, and are read
with two ``batch_resize_scale_value``s and the flip on, so the batches
cover both orientation buckets, several canvas sizes, flipped boxes,
truncation and padding.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.data import synthetic as jax_synthetic
from cap2det_tpu.text import extractors as jax_extractors
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline, synthetic
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.text import extractors

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car", "traffic light"]
NUM_BATCHES = 12
KEYS = (InputFields.image, InputFields.image_shape, InputFields.proposals,
        InputFields.num_proposals, InputFields.pseudo_labels,
        InputFields.num_objects, InputFields.num_captions,
        InputFields.caption_lengths)

_READER = """
input_pattern: "%(pattern)s"
is_training: true
shuffle_buffer_size: 4
batch_size: 2
map_num_parallel_calls: %(workers)d
image_resizer { %(resizer)s }
preprocess_options { random_flip_left_right_prob: 0.5 }
max_num_proposals: 16
batch_resize_scale_value: 1.0
batch_resize_scale_value: 0.5
%(extra)s
"""
KEEP_ASPECT = "keep_aspect_ratio_resizer { min_dimension: 64 }"
FIXED = "fixed_shape_resizer { height: 64 width: 80 }"


def _write(module, directory):
    """Landscape records with 20 proposals, portrait ones with 10."""
    for name, hw, num_p, seed in (("land", (72, 100), 20, 1),
                                  ("port", (100, 72), 10, 2)):
        module.write_synthetic_dataset(
            str(directory / ("train-%s.record" % name)), num_examples=7,
            seed=seed, classes=CLASSES, image_hw=hw, num_proposals=num_p)
    label_file = str(directory / "labels.txt")
    module.write_label_file(label_file, CLASSES)
    return str(directory / "train-*.record"), label_file


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return _write(jax_synthetic, tmp_path_factory.mktemp("jax_records"))


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    return _write(synthetic, tmp_path_factory.mktemp("port_records"))


def _pipelines(records, workers=1, resizer=KEEP_ASPECT, extra="", seed=3):
    pattern, label_file = records
    text = _READER % {"pattern": pattern, "workers": workers,
                      "resizer": resizer, "extra": extra}
    extractor = {"groundtruth_extractor": {"label_file": label_file}}
    want = jax_pipeline.InputPipeline(
        _reader(jax_schema, text),
        label_extractor=jax_extractors.build_label_extractor(
            jax_schema.LabelExtractor.from_dict(extractor)),
        seed=seed, pack_s2d=False)
    got = pipeline.InputPipeline(
        _reader(schema, text),
        label_extractor=extractors.build_label_extractor(
            schema.LabelExtractor.from_dict(extractor)),
        seed=seed)
    return got, want


def _reader(pkg, text):
    pipe = pkg.loads_pipeline("train_reader { cap2det_reader { %s } }"
                              % text)
    return pipe.train_reader.cap2det_reader


def _take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _assert_same_batches(got_pipe, want_pipe, monkeypatch):
    flips = []
    real_flip = pipeline._flip_boxes
    monkeypatch.setattr(pipeline, "_flip_boxes",
                        lambda boxes: flips.append(1) or real_flip(boxes))
    got, want = _take(got_pipe, NUM_BATCHES), _take(want_pipe, NUM_BATCHES)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[InputFields.image_id] == w[InputFields.image_id], i
        for key in KEYS:
            assert g[key].dtype == w[key].dtype, (i, key)
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg="batch %d %s" % (i, key))
        np.testing.assert_array_equal(g[InputFields.caption_strings],
                                      w[InputFields.caption_strings])
        for gb, wb in zip(g[InputFields.object_boxes],
                          w[InputFields.object_boxes]):
            np.testing.assert_array_equal(gb, wb)
    assert flips  # some examples were flipped
    return got


@pytest.mark.parametrize("writer", ["jax_jpeg", "port_png"])
def test_batches_equal_jax(jax_records, port_records, writer, monkeypatch):
    records = jax_records if writer == "jax_jpeg" else port_records
    got = _assert_same_batches(*_pipelines(records), monkeypatch)
    shapes = {b[InputFields.image].shape for b in got}
    assert {s[1] < s[2] for s in shapes} == {True, False}  # orientations
    assert len(shapes) >= 3  # two scales in at least one orientation
    assert got[0][InputFields.image].dtype == np.uint8
    counts = np.concatenate([b[InputFields.num_proposals] for b in got])
    assert {10, 16} <= set(counts.tolist())  # padded and truncated


@pytest.mark.parametrize("variant", ["shard", "parallel", "fixed_shape"])
def test_batches_equal_jax_variants(jax_records, variant, monkeypatch):
    kwargs = {"shard": {"extra": 'shard_indicator: "1/2"'},
              "parallel": {"workers": 3},
              "fixed_shape": {"resizer": FIXED}}[variant]
    got = _assert_same_batches(*_pipelines(jax_records, **kwargs),
                               monkeypatch)
    if variant == "fixed_shape":
        assert {b[InputFields.image].shape[1:3] for b in got} == {
            (64, 96), (32, 64)}
    if variant == "shard":
        ids = {i for b in got for i in b[InputFields.image_id]}
        assert all(pipeline._shard_hash(i, 2) == 1 for i in ids)


def _pipeline_threads():
    return {t for t in threading.enumerate() if t.daemon and t.is_alive()}


def test_abandoning_the_iterator_stops_its_thread(port_records):
    got, _ = _pipelines(port_records)
    before = _pipeline_threads()
    it = iter(got)
    next(it)
    started = _pipeline_threads() - before
    assert len(started) == 1
    it.close()
    deadline = time.monotonic() + 10
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in started)


def test_worker_process_yields_the_pipelines_batches(port_records):
    """in_worker_process: the same batches from a spawned worker (the
    canvas as a CPU tensor, the rest as the pipeline made it), and
    closing it stops the worker."""
    import multiprocessing

    got, _ = _pipelines(port_records)
    want = _take(got, 4)
    before = set(multiprocessing.active_children())
    it = pipeline.in_worker_process(got, "cpu")
    batches = [next(it) for _ in range(4)]
    assert set(multiprocessing.active_children()) - before
    it.close()
    for g, w in zip(batches, want):
        assert g.keys() == w.keys()
        assert isinstance(g[InputFields.image], torch.Tensor)
        assert not g[InputFields.image].is_pinned()
        np.testing.assert_array_equal(g[InputFields.image].numpy(),
                                      w[InputFields.image])
        for key in set(w) - {InputFields.image}:
            assert type(g[key]) is type(w[key]), key
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key])
        np.testing.assert_array_equal(
            np.concatenate(g[InputFields.object_boxes]),
            np.concatenate(w[InputFields.object_boxes]))
    deadline = time.monotonic() + 30
    while (set(multiprocessing.active_children()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not set(multiprocessing.active_children()) - before


def test_refuses_what_is_not_ported(port_records, tmp_path):
    pattern, label_file = port_records

    def reader(extra):
        return _reader(schema, 'input_pattern: "%s" %s' % (pattern, extra))

    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        pipeline.InputPipeline(reader("decode_image: false"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        pipeline.InputPipeline(reader(""), vocab=object())
    with pytest.raises(ValueError, match="opt in"):
        pipeline.InputPipeline(reader(
            "preprocess_options { random_hue_prob: 0.5 }"))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        pipeline.InputPipeline(reader(
            "preprocess_options { random_hue_prob: 0.5 "
            "enable_photometric_augmentation: true }"))
    with pytest.raises(ValueError, match="random_crop"):
        pipeline.InputPipeline(reader(
            "preprocess_options { random_crop_prob: 0.5 }"))
    with pytest.raises(FileNotFoundError, match="no files match"):
        _take(pipeline.InputPipeline(_reader(
            schema, 'input_pattern: "%s"' % (tmp_path / "absent*"))), 1)


def test_parse_example_equals_jax(port_records):
    from cap2det_tpu.data import tfrecord as jax_tfrecord

    pattern, _ = port_records
    path = sorted(jax_tfrecord.list_files(pattern))[0]
    for record in jax_tfrecord.read_records(path):
        got = pipeline.parse_example(record)
        want = jax_pipeline.parse_example(record)
        assert set(got) == set(want)
        for key in got:
            if isinstance(got[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key])
            else:
                assert got[key] == want[key], key
