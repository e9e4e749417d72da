"""Rich multi-object synthetic scenes for the hardware quality run (the
port's counterpart of ``tools/make_rich_synthetic_dataset.py``: the same
draws in the same order, the same flags, JPEG through Pillow at quality 80
as the JAX package's ``data/synthetic.encode_jpeg``, and the same files).

Real datasets are not in the repository, so the strongest available
quality evidence is a WSOD training trajectory over scenes with real
selective-search proposals (reference README.md:234-237 is the real-data
target; BASELINE.md states the remaining gap). This generator produces
scenes that exercise the actual learning problem:

  * textured background (smoothed noise) — SS produces real segment
    proposals, not one trivial box;
  * 1-3 objects per scene from C = shape x color classes (rectangle /
    ellipse / triangle), jittered intensity, occasional overlap;
  * captions = filler words + the class names (exact-match extractable);
  * ground truth recorded ONLY for eval — training uses captions, the
    weak-supervision contract.

Two phases (both restartable):
  --phase images   write JPEGs + gt.jsonl into <out>/images, <out>/gt.jsonl
  --phase records  read <ss_dir>/<id>.npy proposals + gt.jsonl ->
                   sharded train/eval TFRecords + label file

The selective-search step between them is the standard tool:
  python -m cap2det_tpu_torch.tools.create_selective_search_data \
      --image_dir <out>/images --output_dir <out>/ss_npy \
      --process_indicator k/n

  python -m cap2det_tpu_torch.tools.make_rich_synthetic_dataset \
      --phase images --out <out> [--num_images 300 --class_set 80]
"""

import argparse
import io
import json
import os

import numpy as np

from cap2det_tpu_torch.data import record_builder, synthetic, tfrecord

SHAPES = ("rect", "ellipse", "triangle")
COLORS = {
    "red": (200, 50, 50),
    "green": (55, 190, 60),
    "blue": (50, 70, 200),
}
CLASSES = ["%s_%s" % (c, s) for c in COLORS for s in SHAPES]

# --class_set 80: the coco17 regime — C = 80 classes from color x shape
# x texture combos (5 x 4 x 4), exercising the coco17_* config shapes
# (OICR heads [P, 81], NMS over 80 columns, 80-row extend table).
_COLORS_80 = dict(COLORS, yellow=(210, 190, 40), purple=(140, 60, 190))
_SHAPES_80 = SHAPES + ("diamond",)
_TEXTURES_80 = ("solid", "striped", "dotted", "checker")
_COLOR_SYNONYMS_80 = {
    "red": ["crimson", "scarlet"],
    "green": ["emerald", "lime"],
    "blue": ["azure", "navy"],
    "yellow": ["golden", "amber"],
    "purple": ["violet", "mauve"],
}
_SHAPE_SYNONYMS_80 = {
    "rect": ["block", "slab"],
    "ellipse": ["oval", "blob"],
    "triangle": ["wedge", "pyramid"],
    "diamond": ["rhombus", "kite"],
}
_TEXTURE_SYNONYMS_80 = {
    "solid": ["plain", "flat"],
    "striped": ["banded", "lined"],
    "dotted": ["spotted", "speckled"],
    "checker": ["checked", "gridded"],
}


def configure_classes(class_set):
    """Swaps the module class vocabulary: 9 (default, color x shape) or
    80 (color x shape x texture, the coco17-regime class count). Both
    phases of a dataset must run with the SAME --class_set."""
    global CLASSES, SYNONYMS, COLORS, SHAPES, TEXTURES
    if class_set == 9:
        return
    if class_set != 80:
        raise ValueError("class_set must be 9 or 80")
    COLORS = _COLORS_80
    SHAPES = _SHAPES_80
    TEXTURES = _TEXTURES_80
    CLASSES = [
        "%s_%s_%s" % (c, s, t)
        for c in COLORS for s in SHAPES for t in TEXTURES
    ]
    SYNONYMS = {
        "%s_%s_%s" % (c, s, t): [
            "%s_%s_%s" % (cs, ss, ts)
            for cs in _COLOR_SYNONYMS_80[c]
            for ss in _SHAPE_SYNONYMS_80[s]
            for ts in _TEXTURE_SYNONYMS_80[t]
        ]
        for c in COLORS for s in SHAPES for t in TEXTURES
    }

# Caption-side synonyms per class (never the class name itself) for
# --caption_style=synonyms: the regime the paper's ExtendMatch extractor
# exists for (reference models/label_extractor.py:153-207) — captions
# that NAME the object with words outside the class vocabulary, so exact
# token match misses the label while a synonym table recovers it.
_COLOR_SYNONYMS = {
    "red": ["crimson", "scarlet"],
    "green": ["emerald", "lime"],
    "blue": ["azure", "navy"],
}
_SHAPE_SYNONYMS = {
    "rect": ["block", "slab"],
    "ellipse": ["oval", "blob"],
    "triangle": ["wedge", "pyramid"],
}
SYNONYMS = {
    "%s_%s" % (c, s): [
        "%s_%s" % (cs, ss)
        for cs in _COLOR_SYNONYMS[c]
        for ss in _SHAPE_SYNONYMS[s]
    ]
    for c in COLORS
    for s in SHAPES
}

_FILLER = [
    "a", "photo", "of", "the", "scene", "with", "some", "and", "small",
    "large", "object", "objects", "next", "to", "background",
]


def encode_jpeg(image):
    """[H, W, 3] uint8 -> JPEG bytes through Pillow at quality 80."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=80)
    return buf.getvalue()


def _smooth_noise(rng, h, w, octaves=3):
    acc = np.zeros((h, w), np.float32)
    for o in range(octaves):
        step = 2 ** (octaves - o + 2)
        gh, gw = h // step + 2, w // step + 2
        coarse = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        yi, xi = ys.astype(int), xs.astype(int)
        yf, xf = ys - yi, xs - xi
        top = (coarse[yi][:, xi] * (1 - xf) + coarse[yi][:, xi + 1] * xf)
        bot = (coarse[yi + 1][:, xi] * (1 - xf)
               + coarse[yi + 1][:, xi + 1] * xf)
        acc += (top * (1 - yf)[:, None] + bot * yf[:, None]) / (o + 1)
    acc -= acc.min()
    return acc / max(acc.max(), 1e-6)


def _draw_object(image, rng, cls_name, box_px):
    parts = cls_name.split("_")
    color, shape = parts[0], parts[1]
    texture = parts[2] if len(parts) > 2 else "solid"
    base = np.array(COLORS[color], np.float32)
    base = np.clip(base + rng.uniform(-30, 30, 3), 0, 255)
    y0, x0, y1, x1 = box_px
    hh, ww = y1 - y0, x1 - x0
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    cy, cx = (hh - 1) / 2.0, (ww - 1) / 2.0
    if shape == "rect":
        mask = np.ones((hh, ww), bool)
    elif shape == "ellipse":
        mask = ((yy - cy) / max(cy, 1)) ** 2 + (
            (xx - cx) / max(cx, 1)) ** 2 <= 1.0
    elif shape == "diamond":
        mask = (np.abs(yy - cy) / max(cy, 1)
                + np.abs(xx - cx) / max(cx, 1)) <= 1.0
    else:  # triangle (apex up)
        mask = (yy / max(hh - 1, 1)) >= np.abs(xx - cx) / max(cx, 1)
    shade = 1.0 + 0.25 * _smooth_noise(
        np.random.default_rng(rng.integers(1 << 31)), hh, ww, octaves=2
    )
    # Texture: a pixel-scale intensity modulation strong enough to be a
    # conv-visible class component (class_set 80).
    if texture == "striped":
        shade = shade * np.where((yy // 6) % 2 == 0, 0.5, 1.15)
    elif texture == "dotted":
        dots = ((yy % 12) < 5) & ((xx % 12) < 5)
        shade = shade * np.where(dots, 1.6, 0.75)
    elif texture == "checker":
        shade = shade * np.where(((yy // 8) + (xx // 8)) % 2 == 0, 0.5, 1.3)
    patch = np.clip(base[None, None, :] * shade[:, :, None], 0, 255)
    region = image[y0:y1, x0:x1]
    region[mask] = patch[mask]


def make_scene(rng, classes, image_hw):
    h, w = image_hw
    bg = _smooth_noise(rng, h, w)
    base_tint = rng.uniform(90, 150, 3)
    image = np.clip(
        base_tint[None, None, :] + (bg[:, :, None] - 0.5) * 70
        + rng.normal(0, 4, (h, w, 3)),
        0, 255,
    ).astype(np.float32)

    n_obj = int(rng.integers(1, 4))
    gt_boxes, gt_classes = [], []
    for _ in range(n_obj):
        cls = classes[int(rng.integers(len(classes)))]
        bh = rng.uniform(0.2, 0.45) * h
        bw = rng.uniform(0.2, 0.45) * w
        y0 = rng.uniform(0, h - bh)
        x0 = rng.uniform(0, w - bw)
        box_px = (int(y0), int(x0), int(y0 + bh), int(x0 + bw))
        _draw_object(image, rng, cls, box_px)
        gt_boxes.append([
            box_px[0] / h, box_px[1] / w, box_px[2] / h, box_px[3] / w,
        ])
        gt_classes.append(cls)
    image = np.clip(image + rng.normal(0, 3, image.shape), 0, 255)
    return image.astype(np.uint8), np.array(gt_boxes, np.float32), gt_classes


def phase_images(args):
    img_dir = os.path.join(args.out, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    gt_path = os.path.join(args.out, "gt.jsonl")
    done = set()
    if os.path.exists(gt_path):  # restartable
        with open(gt_path) as fid:
            done = {json.loads(l)["image_id"] for l in fid if l.strip()}
    with open(gt_path, "a") as gt_fid:
        for i in range(args.num_images):
            image_id = "scene-%05d" % i
            # Draw the scene unconditionally so the RNG stream (and thus
            # every later scene) is identical across restarts.
            image, boxes, classes = make_scene(
                rng, CLASSES, (args.height, args.width)
            )
            if image_id in done:
                continue
            with open(os.path.join(img_dir, image_id + ".jpg"), "wb") as fid:
                fid.write(encode_jpeg(image))
            gt_fid.write(json.dumps({
                "image_id": image_id,
                "boxes": boxes.tolist(),
                "classes": classes,
            }) + "\n")
    print("images: %d scenes in %s" % (args.num_images, img_dir))


def write_embeddings(out_dir, seed=0, dims=50, synonym_noise=0.25):
    """Synthetic GloVe stand-in for the word_vector_match /
    text_classifier_match extractors (the real GloVe tables are not in
    the repository). Open vocabulary = classes + synonyms +
    filler; each class gets a random unit vector, each synonym its
    class's vector plus small noise (cosine ~0.97 to its class,
    near-orthogonal to the rest at 50 dims), fillers independent random
    vectors — so top-1 cosine matching (reference
    models/label_extractor.py:210-328) resolves synonyms to their class
    the way real GloVe neighborhoods do. Writes open_vocab.txt +
    embeddings.npy (the load_embeddings format)."""
    rng = np.random.default_rng(seed)
    words, vecs = [], []

    def _unit(v):
        return v / max(np.linalg.norm(v), 1e-12)

    class_vecs = {}
    for cls in CLASSES:
        v = _unit(rng.normal(size=dims))
        class_vecs[cls] = v
        words.append(cls)
        vecs.append(v)
    for cls in CLASSES:
        for syn in SYNONYMS[cls]:
            words.append(syn)
            vecs.append(
                _unit(class_vecs[cls] + synonym_noise * rng.normal(size=dims))
            )
    for filler in _FILLER:
        words.append(filler)
        vecs.append(_unit(rng.normal(size=dims)))

    vocab_path = os.path.join(out_dir, "open_vocab.txt")
    with open(vocab_path, "w") as fid:
        fid.write("".join(w + "\n" for w in words))
    emb_path = os.path.join(out_dir, "embeddings.npy")
    with open(emb_path, "wb") as fid:
        np.save(fid, np.asarray(vecs, np.float32))
    return vocab_path, emb_path


def make_captions(rng, present_classes, caption_style="exact",
                  synonym_prob=0.8):
    """1-2 captions naming every present class, mixed with filler words.

    caption_style='synonyms' replaces each class mention with one of its
    out-of-vocabulary SYNONYMS with probability synonym_prob — captions
    exact_match cannot resolve but extend_match can.
    """
    captions = []
    for _ in range(int(rng.integers(1, 3))):
        cap = list(rng.choice(_FILLER, size=3))
        # sorted(): set order depends on per-process string hashing, and
        # the synonym draws consume rng state per class — keep the record
        # stream reproducible across processes.
        for cls in sorted(set(present_classes)):
            word = cls
            if caption_style == "synonyms" and rng.random() < synonym_prob:
                syns = SYNONYMS[cls]
                word = syns[int(rng.integers(len(syns)))]
            cap.append(word)
        rng.shuffle(cap)
        captions.append(cap)
    return captions


def phase_records(args):
    img_dir = os.path.join(args.out, "images")
    ss_dir = args.ss_dir or os.path.join(args.out, "ss_npy")
    rng = np.random.default_rng(args.seed + 1)
    with open(os.path.join(args.out, "gt.jsonl")) as fid:
        gt = [json.loads(l) for l in fid if l.strip()]
    gt.sort(key=lambda r: r["image_id"])
    n_eval = max(1, int(len(gt) * args.eval_fraction))
    splits = {"eval": gt[:n_eval], "train": gt[n_eval:]}

    label_file = synthetic.write_label_file(
        os.path.join(args.out, "labels.txt"), CLASSES
    )
    # Synonym table in the load_synonym_table format
    # (class<TAB>syn1,syn2,...), written for every style so an
    # extend_match config can always point at it.
    syn_path = os.path.join(args.out, "synonyms.txt")
    with open(syn_path, "w") as fid:
        for cls in CLASSES:
            fid.write("%s\t%s\n" % (cls, ",".join(SYNONYMS[cls])))
    write_embeddings(args.out, seed=args.seed + 2)
    for split, rows in splits.items():
        path = os.path.join(args.out, "%s.record" % split)
        n_props_total = 0
        with tfrecord.TFRecordWriter(path) as writer:
            for row in rows:
                image_id = row["image_id"]
                with open(os.path.join(img_dir, image_id + ".jpg"),
                          "rb") as fid:
                    encoded = fid.read()
                props = np.load(os.path.join(ss_dir, image_id + ".npy"))
                n_props_total += len(props)
                captions = make_captions(
                    rng, row["classes"], args.caption_style,
                    args.synonym_prob,
                )
                writer.write(record_builder.build_example(
                    image_id,
                    image_encoded=encoded,
                    captions=captions,
                    object_boxes=np.asarray(row["boxes"], np.float32),
                    object_texts=row["classes"],
                    object_labels=[
                        CLASSES.index(c) + 1 for c in row["classes"]
                    ],
                    proposal_boxes=props,
                ))
        print("%s: %d examples, mean %.0f SS proposals -> %s" % (
            split, len(rows), n_props_total / max(len(rows), 1), path,
        ))
    print("labels: %s" % label_file)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--phase", choices=["images", "records"],
                        required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--num_images", type=int, default=300)
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=448)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ss_dir", default=None)
    parser.add_argument("--eval_fraction", type=float, default=0.15)
    parser.add_argument(
        "--caption_style", choices=["exact", "synonyms"], default="exact",
        help="'exact': captions contain the class names (exact-match "
        "extractable). 'synonyms': each class mention is replaced by an "
        "out-of-vocabulary synonym with probability --synonym_prob — the "
        "ExtendMatch regime.",
    )
    parser.add_argument(
        "--synonym_prob", type=float, default=0.8,
        help="With --caption_style synonyms: probability that a class "
        "mention is replaced by an out-of-vocabulary synonym.",
    )
    parser.add_argument(
        "--class_set", type=int, choices=[9, 80], default=9,
        help="9 (color x shape, the default quality-run regime) or 80 "
        "(color x shape x texture — the coco17 class count; exercises "
        "[P,81] OICR heads, 80-column NMS, 80-row extend tables). Use "
        "the SAME value for both phases of a dataset.",
    )
    args = parser.parse_args(argv)
    configure_classes(args.class_set)
    if args.phase == "images":
        phase_images(args)
    else:
        phase_records(args)


if __name__ == "__main__":
    main()
