"""PNG encoding and decoding with ``zlib`` and numpy.

The port reads ``image/encoded`` without Pillow when it holds a PNG: the
machine a training run lands on may have no Pillow, and the port's
synthetic records (``data/synthetic.py``) store PNG for that reason. PNG
is lossless, so these bytes decode to the same pixels here and through
Pillow in the JAX package's feed.

The decoder takes what 8-bit encoders write: gray, RGB and RGBA, not
interlaced, every row under any of the five filter types. Anything else
raises. The encoder writes 8-bit RGB rows under filter 0 (None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# IHDR colour type -> samples per pixel: gray, RGB, RGBA.
_SAMPLES = {0: 1, 2: 3, 6: 4}


def is_png(data):
    return bytes(data[:8]) == SIGNATURE


def _chunk(kind, body):
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(image, level=6):
    """[H, W, 3] uint8 RGB -> PNG bytes (filter 0 on every row)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("encode_png: [H, W, 3] uint8 expected, got %s %s"
                         % (image.dtype, image.shape))
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # byte 0 of a row: filter 0
    rows[:, 1:] = image.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _chunks(data):
    if not is_png(data):
        raise ValueError("not a PNG: no PNG signature")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = bytes(data[pos + 4:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


def png_size(data):
    """(height, width) from the IHDR chunk, which comes first."""
    kind, body = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG does not start with IHDR")
    w, h = struct.unpack(">II", body[:8])
    return h, w


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype, line, prior, bpp):
    """One reconstructed row (uint8 [n]) from its filtered bytes and the
    reconstructed row above (zeros above the first row)."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: a running sum of each sample, modulo 256
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prior
    if ftype not in (3, 4):
        raise ValueError("PNG filter type %d is not one of 0-4" % ftype)
    # Average and Paeth predict from the reconstructed byte to the left:
    # a walk along the row.
    f, up = line.tolist(), prior.tolist()
    out = [0] * len(f)
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (a + up[i]) >> 1
        else:
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (f[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def decode_png(data):
    """PNG bytes -> [H, W, 3] uint8 RGB (gray replicated, alpha dropped, as
    Pillow's ``convert("RGB")`` gives them)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(bytes(body))
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, compression, filter_method, interlace = header
    if (depth != 8 or colour not in _SAMPLES or compression
            or filter_method or interlace):
        raise ValueError(
            "unsupported PNG: bit depth %d, colour type %d, interlace %d "
            "(8-bit gray, RGB or RGBA, not interlaced, is supported)"
            % (depth, colour, interlace))
    bpp = _SAMPLES[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data holds %d bytes, %d expected"
                         % (raw.size, h * (stride + 1)))
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    pixels = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])
