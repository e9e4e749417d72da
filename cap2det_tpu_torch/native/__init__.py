"""ctypes bindings to the port's host C++ library (the port's counterpart
of ``cap2det_tpu/native/__init__.py``).

``libcap2det_host.so`` carries selective-search region proposals and the
Felzenszwalb segmentation under them (``csrc/host/selective_search.cc``,
the port's copy of ``native/selective_search.cc``). It replaces the
OpenCV ximgproc dependency of the reference's offline tools, runs on the
host and is built by the host C++ compiler at first use
(``kernels/build.host_library``). There is no fallback: a library that
cannot be built raises.

Not carried over: ``pack_s2d`` (``native/image_pack.cc``) packs the TPU's
space-to-depth canvas, a layout the port does not use; and
``read_records_native`` (``native/tfrecord_reader.cc``) is a fast path of
a reader the port has in Python (``data/tfrecord.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from cap2det_tpu_torch.kernels import build

_lib = None
_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)


def load():
    """Returns the loaded host library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.host_library()
        lib.cap2det_selective_search.restype = ctypes.c_int
        lib.cap2det_selective_search.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.cap2det_felzenszwalb.restype = ctypes.c_int
        lib.cap2det_felzenszwalb.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def _rgb(image):
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("an [H, W, 3] RGB image is expected, got shape %s"
                         % (image.shape,))
    return image


def selective_search(image, quality=True, min_box_side=20, seed=0,
                     max_boxes=4000):
    """Runs selective search on an RGB uint8 image.

    Returns [N, 4] normalized [ymin, xmin, ymax, xmax] float32 proposals,
    ranked as in the classic algorithm, the ties among a level broken by a
    jitter drawn from ``std::mt19937(seed)``.
    """
    lib = load()
    image = _rgb(image)
    h, w = image.shape[:2]
    out = np.zeros((max_boxes, 4), np.float32)
    n = lib.cap2det_selective_search(
        image.ctypes.data_as(_U8P), h, w, 1 if quality else 0, min_box_side,
        seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_boxes)
    return out[:n].copy()


def felzenszwalb(image, k=100.0, min_size=20):
    """Graph segmentation; returns an int32 [H, W] label map."""
    lib = load()
    image = _rgb(image)
    h, w = image.shape[:2]
    labels = np.zeros((h, w), np.int32)
    lib.cap2det_felzenszwalb(
        image.ctypes.data_as(_U8P), h, w, float(k), min_size,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return labels
