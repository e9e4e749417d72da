"""Reads TensorFlow checkpoints without TensorFlow.

The two formats that ``tf.compat.v1.train.NewCheckpointReader`` reads:

  * **V2** (tensor bundle): ``<prefix>.index``, a table whose key ``""``
    holds a ``BundleHeaderProto`` and whose other keys are tensor names,
    each holding a ``BundleEntryProto`` (dtype, shape, shard, offset,
    size, masked crc32c of the bytes); the bytes lie in the shards
    ``<prefix>.data-NNNNN-of-NNNNN``. A partitioned variable's entry lists
    its slices, each stored under its own slice key.
  * **V1** (tensor slices): one table file whose key ``""`` holds a
    ``SavedTensorSlices`` with the meta (each tensor's name, shape, dtype
    and slices) and whose other keys, each a tensor name and slice in
    OrderedCode, hold a ``SavedTensorSlices`` with one ``SavedSlice``: the
    slice's values as a ``TensorProto`` (``tensor_content`` or the typed
    repeated field, packed or not).

Both are LevelDB-style tables (``tensorflow/core/lib/io/table``): a
48-byte footer (metaindex and index block handles, magic
``0xdb4775248b80fb57``), blocks of prefix-compressed entries closed by a
restart array, each block followed by a 5-byte trailer (compression type,
masked crc32c of the block and the type). Type 1 blocks are snappy and are
decoded here. Every crc is checked; all data is little-endian.

Protobuf messages are read with the port's wire decoder
(``data/tf_example``) and crcs with its masked crc32c (``data/tfrecord``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from cap2det_tpu_torch.data.tfrecord import _masked_crc
from cap2det_tpu_torch.data.tf_example import _decode_varint, _iter_fields

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5

# DataType enum (tensorflow/core/framework/types.proto) -> (numpy dtype,
# the V1 TensorProto field of its values, whether that field holds varints)
# for the types read: float32 weights, and the float64/int32/int64 entries
# beside them (global_step). Other types are left out of the result.
_DTYPES = {1: (np.dtype("<f4"), 5, False), 2: (np.dtype("<f8"), 6, False),
           3: (np.dtype("<i4"), 7, True), 9: (np.dtype("<i8"), 10, True)}


class CheckpointError(ValueError):
    """A checkpoint file that cannot be read as it is."""


# ---------------------------------------------------------------------------
# snappy
# ---------------------------------------------------------------------------


def snappy_decompress(data):
    """Decodes one raw snappy block (a varint length, then literals and
    back-references with 1-, 2- or 4-byte offsets)."""
    data = bytes(data)
    length, pos = _decode_varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                n = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            n += 1
            if pos + n > len(data):
                raise CheckpointError("snappy: literal runs past the block")
            out += data[pos:pos + n]
            pos += n
            continue
        if kind == 1:
            n = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            n = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            n = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise CheckpointError("snappy: copy offset %d out of range"
                                  % offset)
        start = len(out) - offset
        for i in range(n):  # a copy may overlap what it writes
            out.append(out[start + i])
    if len(out) != length:
        raise CheckpointError("snappy: %d bytes decoded, %d announced"
                              % (len(out), length))
    return bytes(out)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _block_handle(buf, pos):
    offset, pos = _decode_varint(buf, pos)
    size, pos = _decode_varint(buf, pos)
    return (offset, size), pos


def _read_block(raw, handle, path):
    offset, size = handle
    end = offset + size + BLOCK_TRAILER_BYTES
    if end > len(raw):
        raise CheckpointError("%s: block at %d runs past the file"
                              % (path, offset))
    contents = raw[offset:offset + size]
    kind = raw[offset + size]
    (crc,) = struct.unpack_from("<I", raw, offset + size + 1)
    if _masked_crc(contents + bytes([kind])) != crc:
        raise CheckpointError("%s: block at %d fails its crc32c"
                              % (path, offset))
    if kind == 0:
        return contents
    if kind == 1:
        return snappy_decompress(contents)
    raise CheckpointError("%s: block at %d has compression type %d"
                          % (path, offset, kind))


def _block_entries(block):
    """Yields (key, value) of one block in order."""
    if len(block) < 4:
        raise CheckpointError("block too short")
    (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _decode_varint(block, pos)
        unshared, pos = _decode_varint(block, pos)
        value_len, pos = _decode_varint(block, pos)
        if shared > len(key):
            raise CheckpointError("block entry shares more than its "
                                  "predecessor's key")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + value_len]
        pos += value_len


def read_table(path):
    """{key bytes: value bytes} of a LevelDB-style table file."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < FOOTER_BYTES:
        raise CheckpointError("%s: too short for a table" % path)
    footer = raw[-FOOTER_BYTES:]
    lo, hi = struct.unpack_from("<II", footer, FOOTER_BYTES - 8)
    if (hi << 32) | lo != TABLE_MAGIC:
        raise CheckpointError("%s: not a table (bad magic)" % path)
    _, pos = _block_handle(footer, 0)  # the metaindex, unused
    index_handle, _ = _block_handle(footer, pos)
    table = {}
    for _, handle_bytes in _block_entries(
            _read_block(raw, index_handle, path)):
        handle, _ = _block_handle(handle_bytes, 0)
        table.update(_block_entries(_read_block(raw, handle, path)))
    return table


# ---------------------------------------------------------------------------
# OrderedCode keys (tensorflow/core/lib/strings/ordered_code.cc)
# ---------------------------------------------------------------------------


def _num_increasing(value):
    body = value.to_bytes((value.bit_length() + 7) // 8, "big")
    return bytes([len(body)]) + body


def _string_increasing(text):
    out = bytearray()
    for c in text:  # 0x00 -> 0x00 0xff, 0xff -> 0xff 0x00
        out += b"\x00\xff" if c == 0 else b"\xff\x00" if c == 0xFF else (
            bytes([c]))
    return bytes(out) + b"\x00\x01"


_HEADER_BITS = [(0, 0), (0x80, 0), (0xC0, 0), (0xE0, 0), (0xF0, 0),
                (0xF8, 0), (0xFC, 0), (0xFE, 0), (0xFF, 0), (0xFF, 0x80),
                (0xFF, 0xC0)]


def _signed_num_increasing(value):
    x = ~value if value < 0 else value
    length = x.bit_length() // 7 + 1
    if length == 1:
        return bytes([(_HEADER_BITS[1][0] ^ value) & 0xFF])
    buf = bytearray((value & ((1 << 80) - 1)).to_bytes(10, "big"))
    begin = buf[10 - length:]
    begin[0] ^= _HEADER_BITS[length][0]
    begin[1] ^= _HEADER_BITS[length][1]
    return bytes(begin)


def encode_tensor_name_slice(name, extents):
    """The table key of one slice of a tensor, as TensorFlow's
    ``EncodeTensorNameSlice``: 0, the name, the rank, then each dimension's
    start and length (a full dimension is 0 and -1)."""
    key = _num_increasing(0) + _string_increasing(name.encode())
    key += _num_increasing(len(extents))
    for start, length in extents:
        key += _signed_num_increasing(start) + _signed_num_increasing(length)
    return key


# ---------------------------------------------------------------------------
# protobuf messages
# ---------------------------------------------------------------------------


def _fields(buf):
    """{field number: [values]} of one message."""
    out = {}
    for num, _, value in _iter_fields(buf):
        out.setdefault(num, []).append(value)
    return out


def _int(fields, num, default=0):
    value = fields.get(num, [default])[-1]
    return value - (1 << 64) if value >= 1 << 63 else value


def _shape(buf):
    """TensorShapeProto -> tuple of dims."""
    return tuple(_int(_fields(dim), 1) for dim in _fields(buf).get(2, []))


def _extents(buf, shape):
    """TensorSliceProto -> [(start, length)] with -1 for a full dimension,
    as the key encodes it; an empty proto is the whole tensor."""
    extents = [(_int(_fields(e), 1), _int(_fields(e), 2, -1))
               for e in _fields(buf).get(1, [])]
    if not extents:
        extents = [(0, -1)] * len(shape)
    return extents


def _slices(extents, shape):
    return tuple(slice(0, dim) if length == -1 else
                 slice(start, start + length)
                 for (start, length), dim in zip(extents, shape))


def _typed_values(fields, dtype_enum, count):
    """A V1 TensorProto's values from its typed repeated field, packed or
    not."""
    dtype, num, varint = _DTYPES[dtype_enum]
    chunks = fields.get(num, [])
    if varint:
        ints = []
        for chunk in chunks:
            if isinstance(chunk, int):  # unpacked
                ints.append(chunk)
                continue
            pos = 0
            while pos < len(chunk):
                value, pos = _decode_varint(chunk, pos)
                ints.append(value)
        values = np.array([v - (1 << 64) if v >= 1 << 63 else v
                           for v in ints], np.int64)
    else:  # fixed-width floats: packed and unpacked alike
        values = np.frombuffer(b"".join(bytes(c) for c in chunks), dtype)
    if len(values) != count:
        raise CheckpointError("%d values where %d were expected"
                              % (len(values), count))
    return values.astype(dtype)


def _from_bytes(raw, dtype_enum, shape):
    return np.frombuffer(raw, _DTYPES[dtype_enum][0]).reshape(shape).copy()


def _zeros(shape, dtype_enum):
    return np.zeros(shape, _DTYPES[dtype_enum][0])


# ---------------------------------------------------------------------------
# V2 and V1
# ---------------------------------------------------------------------------


def _read_v2(prefix):
    table = read_table(prefix + ".index")
    header = _fields(table.get(b"", b""))
    num_shards = _int(header, 1, 1)
    if _int(header, 2) != 0:
        raise CheckpointError("%s: a big-endian bundle" % prefix)
    shards = {}

    def shard(i):
        if i not in shards:
            path = "%s.data-%05d-of-%05d" % (prefix, i, num_shards)
            with open(path, "rb") as f:
                shards[i] = f.read()
        return shards[i]

    def entry_bytes(name, entry):
        offset, size = _int(entry, 4), _int(entry, 5)
        raw = shard(_int(entry, 3))[offset:offset + size]
        crc = entry.get(6, [b"\0\0\0\0"])[-1]
        if len(raw) != size or _masked_crc(raw) != struct.unpack("<I",
                                                                  crc)[0]:
            raise CheckpointError("%s: the bytes of %r fail their crc32c"
                                  % (prefix, name))
        return raw

    out = {}
    for key, value in table.items():
        if not key or key[:1] == b"\x00":  # the header, or a slice's key
            continue
        name = key.decode()
        entry = _fields(value)
        dtype_enum = _int(entry, 1)
        if dtype_enum not in _DTYPES:
            continue
        shape = _shape(entry[2][-1]) if 2 in entry else ()
        slices = entry.get(7, [])
        if not slices:
            out[name] = _from_bytes(entry_bytes(name, entry), dtype_enum,
                                    shape)
            continue
        full = _zeros(shape, dtype_enum)
        for slice_proto in slices:
            extents = _extents(slice_proto, shape)
            key = encode_tensor_name_slice(name, extents)
            if key not in table:
                raise CheckpointError("%s: slice %s of %r is missing"
                                      % (prefix, extents, name))
            part = _fields(table[key])
            sl = _slices(extents, shape)
            full[sl] = _from_bytes(entry_bytes(name, part), dtype_enum,
                                   full[sl].shape)
        out[name] = full
    return out


def _read_v1(path):
    table = read_table(path)
    meta = _fields(_fields(table.get(b"", b"")).get(1, [b""])[-1])
    out = {}
    for tensor in meta.get(1, []):
        info = _fields(tensor)
        name = bytes(info[1][-1]).decode()
        dtype_enum = _int(info, 3)
        if dtype_enum not in _DTYPES:
            continue
        shape = _shape(info[2][-1]) if 2 in info else ()
        full = _zeros(shape, dtype_enum)
        for slice_proto in info.get(4, [b""]):
            extents = _extents(slice_proto, shape)
            key = encode_tensor_name_slice(name, extents)
            if key not in table:
                raise CheckpointError("%s: slice %s of %r is missing"
                                      % (path, extents, name))
            saved = _fields(_fields(table[key])[2][-1])
            if bytes(saved[1][-1]).decode() != name:
                raise CheckpointError("%s: key of %r holds %r" % (
                    path, name, bytes(saved[1][-1]).decode()))
            sl = _slices(extents, shape)
            want = full[sl].shape
            proto = _fields(saved.get(3, [b""])[-1])
            content = proto.get(4, [b""])[-1]
            count = int(np.prod(want, dtype=np.int64))
            if content:
                values = _from_bytes(bytes(content), dtype_enum, want)
            else:
                values = _typed_values(proto, dtype_enum, count)
            full[sl] = values.reshape(want)
        out[name] = full
    return out


def checkpoint_format(path):
    """'V2' when ``path`` is a bundle prefix, 'V1' when it is a table
    file."""
    if os.path.isfile(path + ".index"):
        return "V2"
    if os.path.isfile(path):
        return "V1"
    raise FileNotFoundError("no TensorFlow checkpoint at %s" % path)


def read_checkpoint(path):
    """{variable name: numpy array} of every float32, float64, int32 and
    int64 tensor in a V1 or V2 TensorFlow checkpoint (``path`` is the
    prefix given to the saver); entries of other types are left out."""
    if checkpoint_format(path) == "V2":
        return _read_v2(path)
    return _read_v1(path)
