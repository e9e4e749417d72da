"""TFRecord container format: length-prefixed records with masked CRC32C
(the port's copy of ``cap2det_tpu/data/tfrecord.py``).

Record layout:
  uint64 length | uint32 masked_crc32c(length) | bytes data |
  uint32 masked_crc32c(data)

``read_records`` reads records in pure Python, for the tools and tests;
the training feed (``data/pipeline.py``) reads through the host library's
reader, ``native.read_records_native``, which yields the same bytes.
Readers verify CRCs optionally (off by default for speed). Writers always
emit valid CRCs so files interoperate with TensorFlow tooling and with
the JAX package's reader.
"""

from __future__ import annotations

import glob as glob_lib
import os
import struct

# --- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data, crc=0):
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- writer -------------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path):
        self._fid = open(path, "wb")

    def write(self, data):
        header = struct.pack("<Q", len(data))
        self._fid.write(header)
        self._fid.write(struct.pack("<I", _masked_crc(header)))
        self._fid.write(data)
        self._fid.write(struct.pack("<I", _masked_crc(data)))

    def close(self):
        self._fid.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --- reader -------------------------------------------------------------------


def read_records(path, verify_crc=False):
    """Yields raw record bytes from one TFRecord file."""
    with open(path, "rb") as fid:
        while True:
            header = fid.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (expect,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != expect:
                    raise IOError("corrupt TFRecord length header in %s" % path)
            data = fid.read(length)
            footer = fid.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError("truncated TFRecord in %s" % path)
            if verify_crc:
                (expect,) = struct.unpack("<I", footer)
                if _masked_crc(data) != expect:
                    raise IOError("corrupt TFRecord data in %s" % path)
            yield data


def list_files(patterns):
    """Expands glob pattern(s) to a sorted file list."""
    if isinstance(patterns, str):
        patterns = [patterns]
    files = []
    for pattern in patterns:
        matches = glob_lib.glob(pattern)
        if not matches and os.path.exists(pattern):
            matches = [pattern]
        files.extend(m for m in matches if os.path.isfile(m))
    return sorted(files)
