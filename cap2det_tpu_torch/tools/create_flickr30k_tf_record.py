"""Builds Flickr30k TFRecords in the reference schema (the port's
counterpart of ``tools/create_flickr30k_tf_record.py``, same flags and same
record bytes).

Mirrors dataset-tools/create_flickr30k_tf_record.py: images from a
directory (or tar), captions from the results_20130124.token TSV
(``<image>.jpg#<k>\\t<caption>``), proposals from per-image .npy files.
Flickr30k has no box annotations; records carry captions + proposals only.

  python -m cap2det_tpu_torch.tools.create_flickr30k_tf_record \
      --image_source flickr30k-images.tar \
      --annotation_path results_20130124.token \
      --proposal_data_path ss_npy/ \
      --output_path output/flickr30k_train.record --num_shards 20
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import tarfile

import numpy as np

from cap2det_tpu_torch.data.record_builder import ShardedWriter, build_example

log = logging.getLogger("create_flickr30k_tf_record")


def load_captions(token_file):
    captions = collections.defaultdict(list)
    with open(token_file, encoding="utf-8") as fid:
        for line in fid:
            line = line.strip()
            if not line:
                continue
            key, caption = line.split("\t", 1)
            image_name = key.split("#")[0]
            image_id = os.path.splitext(image_name)[0]
            captions[image_id].append(caption)
    return captions


def _iter_images(image_source):
    if os.path.isdir(image_source):
        for name in sorted(os.listdir(image_source)):
            if name.lower().endswith(".jpg"):
                with open(os.path.join(image_source, name), "rb") as fid:
                    yield os.path.splitext(name)[0], fid.read()
    else:  # tar archive (reference reads the distribution tar directly)
        with tarfile.open(image_source) as tar:
            for member in tar:
                if member.isfile() and member.name.lower().endswith(".jpg"):
                    image_id = os.path.splitext(os.path.basename(member.name))[0]
                    yield image_id, tar.extractfile(member).read()


def create_records(
    image_source, token_file, output_path, proposal_dir=None, num_shards=1,
    max_proposals=2000,
):
    captions = load_captions(token_file)
    count = 0
    with ShardedWriter(output_path, num_shards) as writer:
        for image_id, encoded in _iter_images(image_source):
            if image_id not in captions:
                continue
            proposals = None
            if proposal_dir:
                npy = os.path.join(proposal_dir, "%s.npy" % image_id)
                if os.path.exists(npy):
                    with open(npy, "rb") as fid:
                        proposals = np.load(fid)[:max_proposals]
            writer.write(
                build_example(
                    image_id,
                    image_encoded=encoded,
                    captions=captions[image_id],
                    proposal_boxes=proposals,
                )
            )
            count += 1
            if count % 1000 == 0:
                log.info("wrote %d examples", count)
    log.info("done: %d examples -> %s", count, output_path)
    return count


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_source", required=True,
                        help="Image directory or flickr30k-images.tar")
    parser.add_argument("--annotation_path", required=True,
                        help="results_20130124.token TSV")
    parser.add_argument("--proposal_data_path", default=None)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--num_shards", type=int, default=1)
    args = parser.parse_args(argv)
    return create_records(
        args.image_source,
        args.annotation_path,
        args.output_path,
        proposal_dir=args.proposal_data_path,
        num_shards=args.num_shards,
    )


if __name__ == "__main__":
    main()
