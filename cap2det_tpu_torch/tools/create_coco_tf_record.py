"""Builds COCO TFRecords in the reference schema (the port's counterpart
of ``tools/create_coco_tf_record.py``, same flags and same record bytes).

Mirrors dataset-tools/create_coco_tf_record.py: joins caption annotations
(tokenized lowercase, packed as token buffer + offset/length), instance
boxes with category names, and selective-search proposal .npy files;
writes round-robin shards (reference: 100 train / 5 val shards). Where the
JAX tool finds an image's proposals, this one finds the same; it also
finds them under the image file's stem, where the selective-search tool
writes them for COCO's zero-padded file names.

``--image_dir`` accepts either an extracted directory or the COCO
distribution zip itself (``train2017.zip``): like the reference
(dataset-tools/create_coco_tf_record.py:79-87), images are streamed
straight out of the zip without extraction.

Usage:
  python -m cap2det_tpu_torch.tools.create_coco_tf_record \
      --image_dir train2017.zip \
      --caption_annotations_file annotations/captions_train2017.json \
      --instance_annotations_file annotations/instances_train2017.json \
      --proposal_data_path ss_npy/ \
      --output_path output/coco17_train.record --num_shards 100
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import zipfile

import numpy as np

from cap2det_tpu_torch.data.record_builder import ShardedWriter, build_example

log = logging.getLogger("create_coco_tf_record")


def load_annotations(caption_file, instance_file=None):
    with open(caption_file) as fid:
        captions_json = json.load(fid)
    images = {img["id"]: img for img in captions_json["images"]}
    captions = collections.defaultdict(list)
    for ann in captions_json["annotations"]:
        captions[ann["image_id"]].append(ann["caption"])

    instances = collections.defaultdict(list)
    categories = {}
    if instance_file:
        with open(instance_file) as fid:
            inst_json = json.load(fid)
        categories = {c["id"]: c["name"] for c in inst_json["categories"]}
        for ann in inst_json["annotations"]:
            instances[ann["image_id"]].append(ann)
    return images, captions, instances, categories


def load_proposals(proposal_dir, image_id, file_name, max_proposals):
    """The image's proposals, or None: ``<image_id>.npy`` as the JAX tool
    looks them up, else ``<file stem>.npy``, the name
    create_selective_search_data gives them (COCO's "000000391895.jpg" ->
    "000000391895.npy", which the id alone never finds)."""
    stem = os.path.splitext(os.path.basename(file_name))[0]
    for name in ("%d.npy" % image_id, stem + ".npy"):
        npy = os.path.join(proposal_dir, name)
        if os.path.exists(npy):
            with open(npy, "rb") as fid:
                return np.load(fid)[:max_proposals]
    return None


class ImageSource:
    """Reads image bytes from an extracted directory or a distribution zip.

    The COCO zips nest files under a split directory ("train2017/...jpg")
    while the annotation ``file_name`` is the bare basename; entries are
    indexed by basename so both layouts resolve.
    """

    def __init__(self, path):
        self._zip = None
        self._dir = path
        if os.path.isfile(path) and path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            entries = [n for n in self._zip.namelist() if not n.endswith("/")]
            self._names = set(entries)
            self._by_basename = {os.path.basename(n): n for n in entries}

    def read(self, file_name):
        """Returns the encoded bytes, or None when absent."""
        if self._zip is not None:
            name = (
                file_name
                if file_name in self._names
                else self._by_basename.get(os.path.basename(file_name))
            )
            if name is None:
                return None
            with self._zip.open(name) as fid:
                return fid.read()
        path = os.path.join(self._dir, file_name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fid:
            return fid.read()

    def close(self):
        if self._zip is not None:
            self._zip.close()


def create_records(
    image_dir,
    caption_file,
    instance_file,
    output_path,
    proposal_dir=None,
    num_shards=1,
    max_proposals=2000,
):
    images, captions, instances, categories = load_annotations(
        caption_file, instance_file
    )
    source = ImageSource(image_dir)
    count = 0
    missing = 0
    with ShardedWriter(output_path, num_shards) as writer:
        for image_id, img in sorted(images.items()):
            encoded = source.read(img["file_name"])
            if encoded is None:
                missing += 1
                if missing <= 5:
                    log.warning(
                        "missing image file, skipping: %s", img["file_name"]
                    )
                continue
            height, width = float(img["height"]), float(img["width"])

            boxes, texts, labels = [], [], []
            for ann in instances.get(image_id, []):
                x, y, w, h = ann["bbox"]
                boxes.append(
                    [y / height, x / width, (y + h) / height, (x + w) / width]
                )
                texts.append(categories[ann["category_id"]])
                labels.append(ann["category_id"])

            proposals = None
            if proposal_dir:
                proposals = load_proposals(proposal_dir, image_id,
                                           img["file_name"], max_proposals)

            writer.write(
                build_example(
                    str(image_id),
                    image_encoded=encoded,
                    captions=captions.get(image_id, []),
                    object_boxes=np.array(boxes, np.float32).reshape(-1, 4),
                    object_texts=texts,
                    object_labels=labels,
                    proposal_boxes=proposals,
                )
            )
            count += 1
            if count % 1000 == 0:
                log.info("wrote %d examples", count)
    source.close()
    if missing:
        log.warning(
            "skipped %d annotation entries with no image file under the "
            "given --image_dir", missing,
        )
    log.info("done: %d examples -> %s", count, output_path)
    return count


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--caption_annotations_file", required=True)
    parser.add_argument("--instance_annotations_file", default=None)
    parser.add_argument("--proposal_data_path", default=None)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--num_shards", type=int, default=1)
    args = parser.parse_args(argv)
    return create_records(
        args.image_dir,
        args.caption_annotations_file,
        args.instance_annotations_file,
        args.output_path,
        proposal_dir=args.proposal_data_path,
        num_shards=args.num_shards,
    )


if __name__ == "__main__":
    main()
