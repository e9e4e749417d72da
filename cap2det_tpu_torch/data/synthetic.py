"""Synthetic dataset generation in the reference TFRecord schema (the
port's copy of ``cap2det_tpu/data/synthetic.py``).

Records hold an encoded image, tokenized captions (token buffer +
offset/length framing, as in dataset-tools/create_coco_tf_record.py:79-87,
187-195), ground-truth boxes with class texts, and selective-search-style
proposal boxes. The numpy draws are the JAX package's, in its order, so
both packages write the same captions, boxes and pixels from one seed.

Unlike the JAX package, which stores JPEG through Pillow, the port stores
the image as a lossless PNG written with ``zlib`` (``data/png.py``): the
machine a run lands on may have no Pillow, and a PNG decodes to exactly
the pixels drawn, in either package. With ``smooth=True`` the pixels are
low-frequency color fields rather than uniform noise, so the PNG
compresses: full-size records stay small.
"""

from __future__ import annotations

import numpy as np

from cap2det_tpu_torch.data import png, record_builder, tfrecord

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

_FILLER = ["a", "the", "on", "photo", "of", "with", "near", "sitting"]


def smooth_image(rng, h, w):
    """Seeded [h, w, 3] uint8 image of low-frequency color fields."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([np.sin(6 * yy + p) * np.cos(4 * xx - p)
                     for p in rng.uniform(0, 6, 3)], -1)
    return np.clip(127 + 100 * base, 0, 255).astype(np.uint8)


def make_example(
    rng,
    image_id,
    classes=VOC_CLASSES,
    image_hw=(480, 640),
    num_captions=2,
    num_objects=2,
    num_proposals=50,
    with_image=True,
    smooth=False,
):
    """Builds one serialized tf.Example in the reference schema (via
    record_builder.build_example, the writer the dataset tools use)."""
    h, w = image_hw
    present = rng.choice(len(classes), size=num_objects, replace=True)

    captions = []
    for _ in range(num_captions):
        cap = list(rng.choice(_FILLER, size=3))
        cap.append(classes[rng.choice(present)])
        cap.append(rng.choice(_FILLER))
        captions.append(cap)

    def rand_boxes(n):
        y0 = rng.uniform(0, 0.6, n)
        x0 = rng.uniform(0, 0.6, n)
        y1 = y0 + rng.uniform(0.2, 0.4, n)
        x1 = x0 + rng.uniform(0.2, 0.4, n)
        return np.clip(np.stack([y0, x0, y1, x1], -1), 0, 1).astype(np.float32)

    image_encoded = None
    if with_image:
        if smooth:
            image = smooth_image(rng, h, w)
        else:
            image = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        image_encoded = png.encode_png(image)
    return record_builder.build_example(
        image_id,
        image_encoded=image_encoded,
        captions=captions,
        object_boxes=rand_boxes(num_objects),
        object_texts=[classes[i] for i in present],
        object_labels=[int(i) + 1 for i in present],
        proposal_boxes=rand_boxes(num_proposals),
    )


def write_synthetic_dataset(
    path,
    num_examples=8,
    seed=0,
    classes=VOC_CLASSES,
    image_hw=(480, 640),
    with_image=True,
    num_proposals=50,
    smooth=False,
):
    rng = np.random.default_rng(seed)
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(num_examples):
            w.write(make_example(
                rng,
                "synthetic-%05d" % i,
                classes=classes,
                image_hw=image_hw,
                with_image=with_image,
                num_proposals=num_proposals,
                smooth=smooth,
            ))
    return path


def write_label_file(path, classes=VOC_CLASSES):
    with open(path, "w") as fid:
        fid.write("\n".join(classes))
    return path


def make_localizable_example(rng, image_id, classes, image_hw=(96, 128),
                             num_distractors=10):
    """One example a detector can actually learn to localize.

    Unlike `make_example` (random boxes over noise), the image carries a
    class-colored rectangle at the ground-truth location, and the
    proposal set contains the ground-truth box plus random distractors —
    the structure WSOD needs (selective-search proposals cover true
    objects in the reference data). Used by the end-to-end overfit test.
    The draws are the JAX package's, in its order; the image is stored as
    PNG.
    """
    h, w = image_hw
    cls = int(rng.integers(len(classes)))

    # Distinct, saturated color per class; mid-gray background.
    palette = np.array(
        [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
         [220, 40, 220], [40, 220, 220]],
        np.uint8,
    )
    image = np.full((h, w, 3), 128, np.uint8)
    y0 = rng.uniform(0.05, 0.55)
    x0 = rng.uniform(0.05, 0.55)
    y1 = y0 + rng.uniform(0.25, 0.4)
    x1 = x0 + rng.uniform(0.25, 0.4)
    gt = np.clip([y0, x0, y1, x1], 0, 1).astype(np.float32)
    py0, px0, py1, px1 = (gt * [h, w, h, w]).astype(int)
    image[py0:py1, px0:px1] = palette[cls % len(palette)]

    # Proposals: the gt box first, then off-object distractors.
    props = [gt]
    while len(props) < 1 + num_distractors:
        dy0 = rng.uniform(0, 0.7)
        dx0 = rng.uniform(0, 0.7)
        box = np.clip(
            [dy0, dx0, dy0 + rng.uniform(0.15, 0.3),
             dx0 + rng.uniform(0.15, 0.3)], 0, 1
        ).astype(np.float32)
        # Keep distractors clear of the object (IoU-free negatives).
        iy = max(0.0, min(box[2], gt[2]) - max(box[0], gt[0]))
        ix = max(0.0, min(box[3], gt[3]) - max(box[1], gt[1]))
        if iy * ix > 0.0:
            continue
        props.append(box)
    proposals = np.stack(props)

    cap = list(rng.choice(_FILLER, size=2)) + [classes[cls]]
    return record_builder.build_example(
        image_id,
        image_encoded=png.encode_png(image),
        captions=[cap],
        object_boxes=gt[None, :],
        object_texts=[classes[cls]],
        object_labels=[cls + 1],
        proposal_boxes=proposals,
    )


def write_localizable_dataset(path, num_examples=16, seed=0,
                              classes=("redthing", "greenthing"),
                              image_hw=(96, 128), num_distractors=10):
    rng = np.random.default_rng(seed)
    classes = list(classes)
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(num_examples):
            w.write(make_localizable_example(
                rng,
                "localizable-%05d" % i,
                classes,
                image_hw=image_hw,
                num_distractors=num_distractors,
            ))
    return path
