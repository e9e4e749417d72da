"""Extracts selective-search proposals to per-image .npy files (the port's
counterpart of ``tools/create_selective_search_data.py``, same flags and
same output bytes).

Mirrors the reference extractors
(dataset-tools/create_{coco,pascal,flickr30k}_selective_search_data.py):
quality-mode selective search, aspect-ratio clamp to 2.2 before
extraction (reference create_coco_selective_search_data.py:94-103), boxes
with min side >= 20px dropped (:109), normalized [ymin,xmin,ymax,xmax]
output, multi-process sharding via ``--process_indicator k/n``
(:40-41,78-79), and skip-if-exists restartability (:81-84).

The proposal engine is the port's host C++ library (``native/``, built
from ``csrc/host/selective_search.cc``); the clamp's resize is the port's
cv2-exact bilinear resize (``data/pipeline.resize_bilinear_u8``).

Input sources:
  --image_dir DIR             loose jpg files (COCO/VOC style)
  --image_tar TAR             flickr30k-images.tar
  --image_list FILE           optional id list (VOC ImageSets file)

  python -m cap2det_tpu_torch.tools.create_selective_search_data \\
      --image_dir train2017 --output_dir ss_npy --process_indicator 0/4
"""

from __future__ import annotations

import argparse
import io
import logging
import os
import tarfile

import numpy as np
import torch

from cap2det_tpu_torch import native
from cap2det_tpu_torch.data.pipeline import resize_bilinear_u8

log = logging.getLogger("create_selective_search_data")

MAX_ASPECT_RATIO = 2.2
MIN_BOX_SIDE_PX = 20


def clamp_aspect(image):
    """Resizes so that max(h,w)/min(h,w) <= 2.2 (reference :94-103), with
    cv2.resize's INTER_LINEAR bits."""
    h, w = image.shape[:2]
    if h > w * MAX_ASPECT_RATIO:
        h = int(w * MAX_ASPECT_RATIO)
    elif w > h * MAX_ASPECT_RATIO:
        w = int(h * MAX_ASPECT_RATIO)
    else:
        return image
    return resize_bilinear_u8(torch.from_numpy(np.array(image, np.uint8)),
                              h, w).numpy()


def extract_for_image(image, max_boxes=4000, seed=0):
    image = clamp_aspect(image)
    return native.selective_search(
        image,
        quality=True,
        min_box_side=MIN_BOX_SIDE_PX,
        seed=seed,
        max_boxes=max_boxes,
    )


def _iter_images(args):
    if args.image_tar:
        with tarfile.open(args.image_tar) as tar:
            for member in tar:
                if member.isfile() and member.name.lower().endswith(".jpg"):
                    image_id = os.path.splitext(os.path.basename(member.name))[0]
                    yield image_id, tar.extractfile(member).read()
        return
    ids = None
    if args.image_list:
        with open(args.image_list) as fid:
            ids = {line.strip().split()[0] for line in fid if line.strip()}
    for name in sorted(os.listdir(args.image_dir)):
        if not name.lower().endswith(".jpg"):
            continue
        image_id = os.path.splitext(name)[0]
        if ids is not None and image_id not in ids:
            continue
        with open(os.path.join(args.image_dir, name), "rb") as fid:
            yield image_id, fid.read()


def decode_rgb(encoded):
    """JPEG (or any Pillow format) bytes -> [H, W, 3] uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(encoded)).convert("RGB"))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", default=None)
    parser.add_argument("--image_tar", default=None)
    parser.add_argument("--image_list", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--process_indicator", default="0/1",
                        help="'k/n' shard of the work for this process.")
    parser.add_argument("--max_boxes", type=int, default=4000)
    args = parser.parse_args(argv)

    numer, denom = (int(x) for x in args.process_indicator.split("/"))
    os.makedirs(args.output_dir, exist_ok=True)

    count = 0
    for index, (image_id, encoded) in enumerate(_iter_images(args)):
        if index % denom != numer:
            continue
        out_path = os.path.join(args.output_dir, "%s.npy" % image_id)
        if os.path.exists(out_path):  # restartable
            continue
        image = decode_rgb(encoded)
        boxes = extract_for_image(image, max_boxes=args.max_boxes)
        with open(out_path, "wb") as fid:
            np.save(fid, boxes.astype(np.float32))
        count += 1
        if count % 100 == 0:
            log.info("[%s] processed %d images", args.process_indicator, count)
    log.info("[%s] done: %d images", args.process_indicator, count)
    return count


if __name__ == "__main__":
    main()
