"""The port's TFRecord framing, tf.Example codec and PNG codec against the
JAX package's and Pillow.

Records written by either package read back through the other's reader to
the same bytes; the port's PNGs decode through Pillow to the pixels
written, and Pillow's PNGs (gray, RGB, RGBA; rows under several filter
types) and a PNG with all five filter types decode through the port to
Pillow's pixels.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from cap2det_tpu.data import tf_example as jax_tf_example
from cap2det_tpu.data import tfrecord as jax_tfrecord
from cap2det_tpu_torch.data import pipeline, png, tf_example, tfrecord

torch.set_num_threads(1)


def test_crc32c_equals_jax_on_random_bytes():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)
        assert tfrecord._masked_crc(data) == jax_tfrecord._masked_crc(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("writer_pkg,reader_pkg",
                         [(tfrecord, jax_tfrecord), (jax_tfrecord, tfrecord)],
                         ids=["port_to_jax", "jax_to_port"])
def test_records_read_back_through_the_other_package(tmp_path, writer_pkg,
                                                     reader_pkg):
    rng = np.random.default_rng(1)
    records = [b"", b"x"] + [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                             for n in (3, 1000, 70000)]
    path = str(tmp_path / "a.record")
    with writer_pkg.TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    assert list(reader_pkg.read_records(path, verify_crc=True)) == records
    assert open(path, "rb").read() == _jax_bytes(tmp_path, records)


def _jax_bytes(tmp_path, records):
    path = str(tmp_path / "ref.record")
    with jax_tfrecord.TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    return open(path, "rb").read()


def test_corrupt_and_truncated_records_raise(tmp_path):
    path = str(tmp_path / "c.record")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"payload" * 10)
    data = bytearray(open(path, "rb").read())
    data[20] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_records(path, verify_crc=True))
    open(path, "wb").write(bytes(data[:30]))
    with pytest.raises(IOError, match="truncated"):
        list(tfrecord.read_records(path))


def test_list_files_equals_jax(tmp_path):
    for name in ("b.record-00001", "a.record-00000", "c.txt"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "dir.record").mkdir()
    patterns = [str(tmp_path / "*.record*"), str(tmp_path / "c.txt")]
    assert tfrecord.list_files(patterns) == jax_tfrecord.list_files(patterns)
    assert tfrecord.list_files(str(tmp_path / "c.txt")) == [
        str(tmp_path / "c.txt")]


_FEATURES = {
    "image/source_id": ("bytes", [b"img-001"]),
    "image/caption/string": ("bytes", [b"a", b"cat", "sits".encode()]),
    "image/caption/offset": ("int64", [0]),
    "image/caption/length": ("int64", [3]),
    "image/proposal/bbox/ymin": ("float", [0.0, 0.25, -1.5e-7]),
    "image/proposal/bbox/xmax": ("float", [1.0, 0.75, 3.0e8]),
    "neg/int": ("int64", [-7, 1 << 40, -(1 << 63), (1 << 63) - 1]),
    "empty/bytes": ("bytes", []),
    "empty/float": ("float", []),
    "empty/int": ("int64", []),
}


def test_example_bytes_and_dicts_equal_both_ways():
    data = tf_example.encode_example(_FEATURES)
    assert data == jax_tf_example.encode_example(_FEATURES)
    for decode in (tf_example.decode_example, jax_tf_example.decode_example):
        out = decode(data)
        assert out == jax_tf_example.decode_example(data)
        assert out["neg/int"] == _FEATURES["neg/int"]
        assert out["empty/float"] == ("float", [])
    wanted = {"neg/int", "image/source_id"}
    assert (tf_example.decode_example(data, wanted_keys=wanted)
            == jax_tf_example.decode_example(data, wanted_keys=wanted))


def test_unpacked_lists_and_unknown_fields_decode_as_jax():
    """Unpacked int64/float values and a field outside the schema, as
    other writers may produce them."""
    int_list = b"".join(tf_example._tag(1, 0) + tf_example._encode_varint(v)
                        for v in (3, -2))
    float_list = b"".join(tf_example._tag(1, 5) + struct.pack("<f", v)
                          for v in (0.5, 2.0))
    unknown = tf_example._tag(9, 1) + bytes(8)
    feats = b"".join(
        tf_example._encode_len_delimited(1, tf_example._encode_len_delimited(
            1, key) + tf_example._encode_len_delimited(2, value))
        for key, value in (
            (b"i", tf_example._encode_len_delimited(3, int_list)),
            (b"f", tf_example._encode_len_delimited(2, float_list + unknown))))
    data = tf_example._encode_len_delimited(1, feats)
    out = tf_example.decode_example(data)
    assert out == jax_tf_example.decode_example(data)
    assert out == {"i": ("int64", [3, -2]), "f": ("float", [0.5, 2.0])}


def _fields_image(rng, hw, channels, noise):
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]),
                         indexing="ij")
    image = (127 + 80 * np.sin(6 * yy[..., None] + np.arange(channels))
             * np.cos(4 * xx[..., None])
             + rng.normal(0, noise, hw + (channels,)))
    return image.clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(31, 45), (1, 1), (64, 3)],
                         ids=["31x45", "1x1", "64x3"])
def test_port_png_decodes_through_pillow_to_the_source(hw):
    image = np.random.default_rng(2).integers(0, 256, hw + (3,),
                                              dtype=np.uint8)
    data = png.encode_png(image)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    assert png.png_size(data) == pipeline.image_size(data) == hw
    assert np.array_equal(pipeline.decode_jpeg(data), image)


def _filters(data):
    """The filter type of every row of a PNG."""
    chunks = list(png._chunks(data))
    w, h, _, colour = struct.unpack(">IIBB", chunks[0][1][:10])
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    stride = 1 + w * png._SAMPLES[colour]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True], ids=["plain", "optimized"])
def test_pillow_pngs_decode_through_the_port(mode, optimize):
    channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    image = _fields_image(np.random.default_rng(3), (31, 45), channels, 3)
    if channels == 1:
        image = image[..., 0]
    buf = io.BytesIO()
    Image.fromarray(image, mode).save(buf, format="PNG", optimize=optimize)
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(png.decode_png(data), want)
    assert pipeline.image_size(data) == (31, 45)
    assert _filters(data) - {0}  # Pillow filtered the rows


def test_every_filter_type_decodes():
    """A gray PNG whose rows carry filters 0-4 in turn, filtered here by
    the PNG rules; Pillow and the port decode it to the same pixels."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (10, 9), dtype=np.uint8).astype(np.int64)
    rows, prior = [], np.zeros(9, np.int64)
    for y in range(10):
        ftype, line = y % 5, image[y]
        left = np.concatenate([[0], line[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        if ftype == 0:
            pred = np.zeros(9, np.int64)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            pred = np.array([png._paeth(int(a), int(b), int(c))
                             for a, b, c in zip(left, prior, upleft)])
        rows.append(bytes([ftype]) + ((line - pred) % 256).astype(
            np.uint8).tobytes())
        prior = line
    data = (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 10, 8, 0, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(want[..., 0], image)
    assert np.array_equal(png.decode_png(data), want)


def test_unsupported_pngs_raise():
    header = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    data = (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(bytes(26)))
            + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(data)
    interlaced = data.replace(header, struct.pack(">IIBBBBB", 2, 2, 8, 2,
                                                  0, 0, 1))
    with pytest.raises(ValueError, match="interlace 1"):
        png.decode_png(interlaced)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a")
    short = data.replace(zlib.compress(bytes(26)), zlib.compress(bytes(3)))
    with pytest.raises(ValueError, match="holds 3 bytes, 14 expected"):
        png.decode_png(short.replace(header, struct.pack(
            ">IIBBBBB", 2, 2, 8, 2, 0, 0, 0)))
    with pytest.raises(ValueError, match="no IEND"):
        png.decode_png(data[:-12])


def test_jpeg_goes_through_pillow_and_names_it_when_absent(monkeypatch):
    image = np.random.default_rng(5).integers(0, 256, (12, 20, 3),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    assert pipeline.image_size(data) == (12, 20)
    assert np.array_equal(pipeline.decode_jpeg(data),
                          np.asarray(Image.open(io.BytesIO(data))))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG image needs Pillow"):
        pipeline.decode_jpeg(data)
    with pytest.raises(ImportError, match="JPEG image needs Pillow"):
        pipeline.image_size(data)
    # PNG needs no Pillow.
    assert np.array_equal(pipeline.decode_jpeg(png.encode_png(image)), image)
