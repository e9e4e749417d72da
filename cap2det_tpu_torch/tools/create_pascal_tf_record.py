"""Builds Pascal VOC TFRecords in the reference schema (the port's
counterpart of ``tools/create_pascal_tf_record.py``, same flags and same
record bytes).

Mirrors dataset-tools/create_pascal_tf_record.py: for each image in the
split list, packs the JPEG, normalized ground-truth boxes + class texts
from the XML annotation (class texts double as the "caption",
reference :183-189), and selective-search proposals from per-image .npy
files. Test sets without annotations are handled (reference :240-262).

Usage:
  python -m cap2det_tpu_torch.tools.create_pascal_tf_record \
      --data_dir VOCdevkit --year VOC2007 --set trainval \
      --proposal_data_path ss_npy/ \
      --output_path output/VOC2007_trainval.record --num_shards 5
"""

from __future__ import annotations

import argparse
import logging
import os
import xml.etree.ElementTree as ET

import numpy as np

from cap2det_tpu_torch.data.record_builder import ShardedWriter, build_example

log = logging.getLogger("create_pascal_tf_record")

VOC_LABELS = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def parse_annotation(xml_path):
    """Returns (width, height, [(name, ymin, xmin, ymax, xmax, difficult)])."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    objects = []
    for obj in root.findall("object"):
        name = obj.find("name").text.strip()
        difficult = int((obj.find("difficult").text or "0")) if obj.find(
            "difficult"
        ) is not None else 0
        box = obj.find("bndbox")
        objects.append(
            (
                name,
                float(box.find("ymin").text) / height,
                float(box.find("xmin").text) / width,
                float(box.find("ymax").text) / height,
                float(box.find("xmax").text) / width,
                difficult,
            )
        )
    return width, height, objects


def load_proposals(proposal_dir, image_id):
    path = os.path.join(proposal_dir, "%s.npy" % image_id)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fid:
        return np.load(fid)


def create_records(
    data_dir, year, split, output_path, proposal_dir=None, num_shards=1,
    ignore_difficult=False,
):
    image_sets = os.path.join(
        data_dir, year, "ImageSets", "Main", "%s.txt" % split
    )
    with open(image_sets) as fid:
        image_ids = [line.strip().split()[0] for line in fid if line.strip()]

    label_to_id = {name: i + 1 for i, name in enumerate(VOC_LABELS)}
    count = 0
    with ShardedWriter(output_path, num_shards) as writer:
        for image_id in image_ids:
            jpeg_path = os.path.join(
                data_dir, year, "JPEGImages", "%s.jpg" % image_id
            )
            with open(jpeg_path, "rb") as fid:
                encoded = fid.read()

            xml_path = os.path.join(
                data_dir, year, "Annotations", "%s.xml" % image_id
            )
            boxes, texts, labels = [], [], []
            if os.path.exists(xml_path):
                _, _, objects = parse_annotation(xml_path)
                for name, ymin, xmin, ymax, xmax, difficult in objects:
                    if ignore_difficult and difficult:
                        continue
                    boxes.append([ymin, xmin, ymax, xmax])
                    texts.append(name)
                    labels.append(label_to_id.get(name, 0))

            proposals = (
                load_proposals(proposal_dir, image_id) if proposal_dir else None
            )
            # Class texts double as the caption (reference :183-189): one
            # pre-tokenized "caption" listing the classes present.
            captions = [texts] if texts else []
            writer.write(
                build_example(
                    image_id,
                    image_encoded=encoded,
                    captions=captions,
                    object_boxes=np.array(boxes, np.float32).reshape(-1, 4),
                    object_texts=texts,
                    object_labels=labels,
                    proposal_boxes=proposals,
                )
            )
            count += 1
            if count % 500 == 0:
                log.info("wrote %d examples", count)
    log.info("done: %d examples -> %s", count, output_path)
    return count


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--year", default="VOC2007")
    parser.add_argument("--set", dest="split", default="trainval")
    parser.add_argument("--proposal_data_path", default=None)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--ignore_difficult_instances", action="store_true")
    args = parser.parse_args(argv)
    return create_records(
        args.data_dir,
        args.year,
        args.split,
        args.output_path,
        proposal_dir=args.proposal_data_path,
        num_shards=args.num_shards,
        ignore_difficult=args.ignore_difficult_instances,
    )


if __name__ == "__main__":
    main()
