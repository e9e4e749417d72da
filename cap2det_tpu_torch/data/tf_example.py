"""Minimal protobuf wire-format codec for tf.train.Example (the port's
copy of ``cap2det_tpu/data/tf_example.py``).

Implements exactly the message shapes the Cap2Det TFRecord schema uses
(reference dataset-tools/create_*_tf_record.py): Example { Features {
map<string, Feature> } } with BytesList / FloatList / Int64List leaves.
No TensorFlow or generated protobuf code required; records produced by
the reference tooling decode bit-identically.

Wire layout (proto3 wire format, shared by proto2):
  Example.features     = field 1 (message)
  Features.feature     = field 1 (map entry: key=1 string, value=2 Feature)
  Feature.bytes_list   = field 1, .float_list = 2, .int64_list = 3
  *List.value          = field 1 (bytes: length-delimited each;
                          float/int64: packed or unpacked)
"""

from __future__ import annotations

import struct


# --- varint / wire primitives ------------------------------------------------


def _encode_varint(value):
    out = bytearray()
    if value < 0:
        value += 1 << 64
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _tag(field_number, wire_type):
    return _encode_varint((field_number << 3) | wire_type)


_WT_VARINT = 0
_WT_64BIT = 1
_WT_LEN = 2
_WT_32BIT = 5


def _encode_len_delimited(field_number, payload):
    return _tag(field_number, _WT_LEN) + _encode_varint(len(payload)) + payload


# --- encoding ----------------------------------------------------------------


def _encode_bytes_list(values):
    body = b"".join(
        _encode_len_delimited(1, v if isinstance(v, bytes) else v.encode("utf-8"))
        for v in values
    )
    return body


def _encode_float_list(values):
    packed = struct.pack("<%df" % len(values), *values)
    return _tag(1, _WT_LEN) + _encode_varint(len(packed)) + packed


def _encode_int64_list(values):
    body = b"".join(_encode_varint(int(v)) for v in values)
    return _tag(1, _WT_LEN) + _encode_varint(len(body)) + body


def encode_feature(kind, values):
    if kind == "bytes":
        return _encode_len_delimited(1, _encode_bytes_list(values))
    if kind == "float":
        return _encode_len_delimited(2, _encode_float_list(values))
    if kind == "int64":
        return _encode_len_delimited(3, _encode_int64_list(values))
    raise ValueError(kind)


def encode_example(features):
    """Encodes {name: (kind, values)} into serialized tf.Example bytes.

    kind is 'bytes' | 'float' | 'int64'. Entries are emitted sorted by key
    for deterministic output.
    """
    body = bytearray()
    for name in sorted(features):
        kind, values = features[name]
        key_bytes = name.encode("utf-8")
        entry = _encode_len_delimited(1, key_bytes) + _encode_len_delimited(
            2, encode_feature(kind, values)
        )
        body += _encode_len_delimited(1, entry)
    return bytes(_encode_len_delimited(1, bytes(body)))


# --- decoding ----------------------------------------------------------------


def _skip_field(buf, pos, wire_type):
    if wire_type == _WT_VARINT:
        _, pos = _decode_varint(buf, pos)
    elif wire_type == _WT_64BIT:
        pos += 8
    elif wire_type == _WT_LEN:
        size, pos = _decode_varint(buf, pos)
        pos += size
    elif wire_type == _WT_32BIT:
        pos += 4
    else:
        raise ValueError("unsupported wire type %d" % wire_type)
    return pos


def _iter_fields(buf):
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _decode_varint(buf, pos)
        field_number = key >> 3
        wire_type = key & 7
        if wire_type == _WT_LEN:
            size, pos = _decode_varint(buf, pos)
            yield field_number, wire_type, buf[pos : pos + size]
            pos += size
        elif wire_type == _WT_VARINT:
            value, pos = _decode_varint(buf, pos)
            yield field_number, wire_type, value
        else:
            new_pos = _skip_field(buf, pos, wire_type)
            yield field_number, wire_type, buf[pos:new_pos]
            pos = new_pos


def _decode_bytes_list(buf):
    return [v for num, wt, v in _iter_fields(buf) if num == 1]


def _decode_float_list(buf):
    out = []
    for num, wt, v in _iter_fields(buf):
        if num != 1:
            continue
        if wt == _WT_LEN:  # packed
            out.extend(struct.unpack("<%df" % (len(v) // 4), v))
        elif wt == _WT_32BIT:
            out.append(struct.unpack("<f", v)[0])
    return out


def _decode_int64_list(buf):
    out = []
    for num, wt, v in _iter_fields(buf):
        if num != 1:
            continue
        if wt == _WT_LEN:  # packed
            pos = 0
            while pos < len(v):
                value, pos = _decode_varint(v, pos)
                if value >= 1 << 63:
                    value -= 1 << 64
                out.append(value)
        else:
            if v >= 1 << 63:
                v -= 1 << 64
            out.append(v)
    return out


def _decode_feature(buf):
    for num, _, v in _iter_fields(buf):
        if num == 1:
            return ("bytes", _decode_bytes_list(v))
        if num == 2:
            return ("float", _decode_float_list(v))
        if num == 3:
            return ("int64", _decode_int64_list(v))
    return ("bytes", [])


def decode_example(data, wanted_keys=None):
    """Decodes serialized tf.Example bytes into {name: (kind, values)}.

    If `wanted_keys` is given, other features are skipped without decoding
    their payloads (cheap for records carrying large JPEG blobs).
    """
    out = {}
    for num, _, features_buf in _iter_fields(data):
        if num != 1:
            continue
        for fnum, _, entry in _iter_fields(features_buf):
            if fnum != 1:
                continue
            key = None
            value_buf = None
            for enum_, _, ev in _iter_fields(entry):
                if enum_ == 1:
                    key = ev.decode("utf-8")
                elif enum_ == 2:
                    value_buf = ev
            if key is None or value_buf is None:
                continue
            if wanted_keys is not None and key not in wanted_keys:
                continue
            out[key] = _decode_feature(value_buf)
    return out
