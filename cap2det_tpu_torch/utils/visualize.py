"""Visualization helpers: heatmaps, box/caption drawing, base64 JPEG (port
of ``cap2det_tpu/utils/visualize.py``, without cv2 or matplotlib).

Host-side equivalent of the reference core/plotlib.py (:34-473): feeds
the HTML evaluation report (eval/html_report.py) and ad-hoc debugging.

  * Rectangles are drawn with numpy: each edge is a band of
    ``thickness // 2`` pixels either side of the line, with square ends
    at the corners' rows and columns. At thickness 1 and 2 that is the
    pixel set of ``cv2.rectangle``.
  * Text is drawn with Pillow's default font, so its pixels differ from
    cv2's Hershey text; JPEGs are encoded with Pillow. Pillow is imported
    when text or a JPEG is asked for.
  * The heatmap's "jet" is matplotlib's: its segment table sampled into a
    256-entry lookup table by matplotlib's own formula.
"""

from __future__ import annotations

import base64
import io

import numpy as np

# matplotlib's "jet" (matplotlib/_cm.py): per channel, (x, y0, y1) rows of
# a piecewise-linear map of [0, 1].
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
_LUT_SIZE = 256  # matplotlib's default colormap resolution


def _lookup_table(segments, n=_LUT_SIZE):
    """One channel's n-entry table, as matplotlib's _create_lookup_table
    computes it (gamma 1)."""
    data = np.array(segments)
    x = data[:, 0] * (n - 1)
    y0, y1 = data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def convert_to_heatmap(values, normalize=True, colormap="jet"):
    """[H, W] float array -> [H, W, 3] uint8 heatmap image."""
    if colormap != "jet":
        raise ValueError("only the 'jet' colormap is built in, not %r"
                         % colormap)
    v = np.asarray(values, np.float32)
    if normalize:
        vmin, vmax = float(v.min()), float(v.max())
        v = (v - vmin) / max(vmax - vmin, 1e-12)
    lut = np.stack([_lookup_table(_JET[c]) for c in ("red", "green", "blue")],
                   -1)
    # matplotlib's float indexing: x * N truncated, with x == 1 in the
    # last entry.
    xa = np.clip(v, 0, 1).astype(np.float32) * np.float32(_LUT_SIZE)
    xa[xa == _LUT_SIZE] = _LUT_SIZE - 1
    return (lut[xa.astype(int)] * 255).astype(np.uint8)


def fill_rectangle_outline(image, p1, p2, color, thickness=2):
    """Draws, in place, the outline of the rectangle with corners p1 and p2
    ((x, y) pixel positions) on an [H, W, C] uint8 array; parts outside
    the image are cut off."""
    h, w = image.shape[:2]
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    r = max(int(thickness), 1) // 2
    color = np.asarray(color, np.uint8)

    def fill(ya, yb, xa, xb):  # inclusive bounds
        ya, xa = max(ya, 0), max(xa, 0)
        yb, xb = min(yb, h - 1), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            image[ya:yb + 1, xa:xb + 1] = color

    for y in (y1, y2):  # horizontal edges
        fill(y - r, y + r, x1, x2)
    for x in (x1, x2):  # vertical edges
        fill(y1, y2, x - r, x + r)
    return image


def _draw_text(image, text, org, color):
    """Draws `text` in place with Pillow's default font, its lower-left
    corner at `org` ((x, y) pixels), as cv2.putText places its text."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("drawing text needs Pillow (PIL), which is not "
                          "installed") from e
    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    bottom = draw.textbbox((0, 0), text)[3]
    draw.text((org[0], org[1] - bottom), text,
              fill=tuple(int(c) for c in color))
    image[...] = np.asarray(pil)
    return image


def draw_rectangles(image, boxes, labels=None, color=(255, 0, 0), thickness=2,
                    normalized=True):
    """Draws [N, 4] (ymin, xmin, ymax, xmax) boxes with optional labels
    on a copy of `image`."""
    out = np.ascontiguousarray(image).copy()
    h, w = out.shape[:2]
    sy, sx = (h, w) if normalized else (1, 1)
    labels = labels if labels is not None else [None] * len(boxes)
    for box, label in zip(boxes, labels):
        y1, x1, y2, x2 = box
        p1 = (int(x1 * sx), int(y1 * sy))
        p2 = (int(x2 * sx), int(y2 * sy))
        fill_rectangle_outline(out, p1, p2, color, thickness)
        if label is not None and label != "":
            _draw_text(out, str(label), (p1[0], max(p1[1] - 4, 10)), color)
    return out


def draw_caption(image, caption, org=(10, 20), color=(255, 255, 255)):
    out = np.ascontiguousarray(image).copy()
    return _draw_text(out, caption, org, color)


def to_base64_jpeg(image, quality=90):
    """RGB uint8 image -> base64 JPEG string (for HTML embedding)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("encoding a JPEG needs Pillow (PIL), which is not "
                          "installed") from e
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(image, dtype=np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return base64.b64encode(buf.getvalue()).decode("ascii")
