"""The port's dataset tools (``cap2det_tpu_torch/tools/``) against the JAX
package's root ``tools/``: the same inputs give the same files, compared
byte for byte (the ``.npy`` proposals, the COCO, Pascal and Flickr30k
TFRecords, the vocabulary and its embedding table, the rich synthetic
scenes and their records) or, for the passthrough checkpoint, tree for
tree. ``clamp_aspect`` equals ``cv2.resize`` (cv2 is used by this test
and the JAX tool only). Tolerance: none, every comparison is exact."""

import io
import json
import os
import sys
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from cap2det_tpu_torch.data import pipeline, tfrecord
from cap2det_tpu_torch.tools import create_coco_tf_record
from cap2det_tpu_torch.tools import create_flickr30k_tf_record
from cap2det_tpu_torch.tools import create_pascal_tf_record
from cap2det_tpu_torch.tools import create_selective_search_data
from cap2det_tpu_torch.tools import create_vocab
from cap2det_tpu_torch.tools import make_passthrough_checkpoint
from cap2det_tpu_torch.tools import make_rich_synthetic_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import create_coco_tf_record as jax_coco  # noqa: E402
import create_flickr30k_tf_record as jax_flickr  # noqa: E402
import create_pascal_tf_record as jax_pascal  # noqa: E402
import create_selective_search_data as jax_ss  # noqa: E402
import create_vocab as jax_vocab  # noqa: E402

# (height, width): inside the 2.2 limit, just past it either way, far past
# it, one pixel wide, and odd sizes.
ASPECTS = [(120, 160), (100, 221), (221, 100), (100, 223), (223, 100),
           (500, 100), (100, 500), (37, 11), (11, 37), (1000, 7), (7, 1000),
           (3, 1), (1, 3), (999, 301), (333, 1280), (5, 640)]


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if os.path.isdir(os.path.join(directory, name)):
            continue
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def _jpeg(pixels):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _scene(rng, h, w):
    """A textured background with two flat objects."""
    img = rng.normal(110, 10, (h, w, 3)).clip(0, 255).astype(np.uint8)
    img[h // 6:h // 2, w // 5:w // 2] = (200, 40, 40)
    img[h // 2:h - 4, w // 2:w - 3] = (40, 190, 60)
    return img


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Five JPEGs, one past the aspect limit each way, a list file naming
    three, a tar of all, a stray non-JPEG."""
    root = tmp_path_factory.mktemp("images")
    img_dir = root / "jpg"
    img_dir.mkdir()
    rng = np.random.default_rng(5)
    sizes = {"a": (60, 80), "b": (40, 100), "c": (100, 40), "d": (57, 63),
             "e": (72, 96)}
    for name, (h, w) in sizes.items():
        (img_dir / (name + ".jpg")).write_bytes(_jpeg(_scene(rng, h, w)))
    (img_dir / "notes.txt").write_text("not an image")
    (root / "list.txt").write_text("a\nc 1\ne\n")
    tar = root / "images.tar"
    with tarfile.open(tar, "w") as t:
        for name in sorted(sizes):
            t.add(img_dir / (name + ".jpg"), "flickr30k-images/%s.jpg" % name)
    return root


@pytest.mark.parametrize("hw", ASPECTS, ids=["%dx%d" % s for s in ASPECTS])
def test_clamp_aspect_equals_cv2(hw):
    image = np.random.default_rng(hw[0] * 7 + hw[1]).integers(
        0, 256, hw + (3,), dtype=np.uint8)
    want = jax_ss.clamp_aspect(image)  # cv2.resize(..., INTER_LINEAR)
    got = create_selective_search_data.clamp_aspect(image)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert max(got.shape[:2]) <= 2.2 * min(got.shape[:2]) + 1


def _run_jax_ss(monkeypatch, args):
    monkeypatch.setattr(sys, "argv", ["create_selective_search_data"] + args)
    jax_ss.main()


@pytest.mark.parametrize("source", ["dir", "list", "tar"])
def test_selective_search_npy_equal_jax(images, tmp_path, monkeypatch,
                                        source):
    flags = {"dir": ["--image_dir", str(images / "jpg")],
             "list": ["--image_dir", str(images / "jpg"), "--image_list",
                      str(images / "list.txt")],
             "tar": ["--image_tar", str(images / "images.tar")]}[source]
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _run_jax_ss(monkeypatch, flags + ["--output_dir", str(want_dir)])
    # The port in two processes' shares, as --process_indicator splits it.
    counts = [create_selective_search_data.main(
        flags + ["--output_dir", str(got_dir), "--process_indicator",
                 "%d/2" % k]) for k in range(2)]
    want, got = _files(want_dir), _files(got_dir)
    assert sorted(got) == sorted(want)
    assert sum(counts) == len(want) == (3 if source == "list" else 5)
    assert got == want
    for data in got.values():
        boxes = np.load(io.BytesIO(data))
        assert boxes.dtype == np.float32 and boxes.shape[1] == 4
        assert len(boxes) > 0
    # Restartable: a second run skips what exists.
    assert create_selective_search_data.main(
        flags + ["--output_dir", str(got_dir)]) == 0


def test_selective_search_max_boxes_and_seed(images):
    image = create_selective_search_data.decode_rgb(
        (images / "jpg" / "b.jpg").read_bytes())
    for seed in (0, 3):
        want = jax_ss.extract_for_image(image, max_boxes=7, seed=seed)
        got = create_selective_search_data.extract_for_image(
            image, max_boxes=7, seed=seed)
        assert got.shape == (7, 4)
        np.testing.assert_array_equal(got, want)


def _coco_corpus(root, images):
    """COCO layout over the fixture JPEGs: captions with punctuation and
    case, instances of two categories, an image the annotations name but
    the directory lacks, a distribution zip, proposals for some images."""
    img_dir = images / "jpg"
    entries, caps, insts = [], [], []
    for i, name in enumerate(["a", "b", "c", "d", "e", "missing"]):
        h, w = (60, 80) if name != "b" else (40, 100)
        entries.append({"id": i + 1, "file_name": name + ".jpg",
                        "height": h, "width": w})
        caps.append({"image_id": i + 1, "id": 100 + i,
                     "caption": "A Dog, and a cat's toy-box (red)."})
        caps.append({"image_id": i + 1, "id": 200 + i,
                     "caption": "two people on a bench"})
        for j in range(i % 3):
            insts.append({"image_id": i + 1, "id": 300 + 3 * i + j,
                          "category_id": 1 + j % 2,
                          "bbox": [2.0 + j, 3.5, 20.25, 11.0 + j]})
    cap_file, inst_file = root / "captions.json", root / "instances.json"
    cap_file.write_text(json.dumps({"images": entries, "annotations": caps}))
    inst_file.write_text(json.dumps({
        "images": entries, "annotations": insts,
        "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "cat"}]}))
    zip_path = root / "train2017.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for name in "abcde":
            zf.write(img_dir / (name + ".jpg"), "train2017/%s.jpg" % name)
    props = root / "props"
    props.mkdir()
    rng = np.random.default_rng(1)
    for image_id in (1, 3, 4):
        np.save(props / ("%d.npy" % image_id),
                rng.uniform(0, 1, (2500, 4)).astype(np.float32))
    return img_dir, zip_path, cap_file, inst_file, props


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_coco_records_equal_jax(images, tmp_path, source):
    img_dir, zip_path, cap_file, inst_file, props = _coco_corpus(tmp_path,
                                                                images)
    src = str(img_dir if source == "dir" else zip_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    n_want = jax_coco.create_records(
        src, str(cap_file), str(inst_file), str(tmp_path / "jax" / "coco"),
        proposal_dir=str(props), num_shards=2)
    n_got = create_coco_tf_record.main([
        "--image_dir", src, "--caption_annotations_file", str(cap_file),
        "--instance_annotations_file", str(inst_file),
        "--proposal_data_path", str(props),
        "--output_path", str(tmp_path / "port" / "coco"), "--num_shards",
        "2"])
    assert n_got == n_want == 5
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == ["coco-00000-of-00002", "coco-00001-of-00002"]
    assert got == want
    examples = [pipeline.parse_example(r) for r in tfrecord.read_records(
        str(tmp_path / "port" / "coco-00000-of-00002"), verify_crc=True)]
    assert examples[0]["captions"][0][:3] == ["a", "dog", ","]
    assert len(examples[0]["proposals"]) == 2000  # max_proposals


def test_coco_proposals_are_found_by_file_stem(images, tmp_path):
    """COCO's zero-padded file names: the selective-search tool writes
    "000000000002.npy", which the JAX tool's "%d.npy" never finds; the
    port finds it, and keeps every other byte of the JAX records."""
    img_dir = tmp_path / "val2017"
    img_dir.mkdir()
    entries, caps = [], []
    for i, name in enumerate("ab"):
        file_name = "%012d.jpg" % (i + 2)
        (img_dir / file_name).write_bytes(
            (images / "jpg" / (name + ".jpg")).read_bytes())
        entries.append({"id": i + 2, "file_name": file_name, "height": 60,
                        "width": 80})
        caps.append({"image_id": i + 2, "id": i, "caption": "a cat"})
    cap_file = tmp_path / "captions.json"
    cap_file.write_text(json.dumps({"images": entries, "annotations": caps}))
    props = tmp_path / "ss_npy"
    assert create_selective_search_data.main(
        ["--image_dir", str(img_dir), "--output_dir", str(props)]) == 2
    assert sorted(os.listdir(props)) == ["000000000002.npy",
                                         "000000000003.npy"]
    outs = {}
    for who, tool in (("jax", jax_coco), ("port", create_coco_tf_record)):
        tool.create_records(str(img_dir), str(cap_file), None,
                            str(tmp_path / who), proposal_dir=str(props))
        outs[who] = [pipeline.parse_example(r) for r in tfrecord.read_records(
            str(tmp_path / who) + "-00000-of-00001")]
    for want, got in zip(outs["jax"], outs["port"]):
        assert len(want["proposals"]) == 0
        expect = np.load(props / ("%012d.npy" % int(got["image_id"])))
        np.testing.assert_array_equal(got["proposals"], expect)
        assert sorted(got) == sorted(want)
        for key in sorted(want):
            if key != "proposals":
                assert np.array_equal(np.asarray(got[key], object),
                                      np.asarray(want[key], object)), key


def _voc_corpus(root, images):
    year = root / "VOCdevkit" / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (year / sub).mkdir(parents=True)
    for name in "abcde":
        (year / "JPEGImages" / ("%s.jpg" % name)).write_bytes(
            (images / "jpg" / ("%s.jpg" % name)).read_bytes())
    objects = {"a": [("dog", 3, 4, 40, 50, 0), ("person", 1, 2, 30, 20, 1)],
               "b": [("cat", 0, 0, 99, 39, None)], "c": [],
               "d": [("tvmonitor", 5, 6, 7, 8, 1)]}  # e: no annotation file
    for name, objs in objects.items():
        body = "".join(
            "<object><name> %s </name>%s<bndbox><xmin>%d</xmin><ymin>%d"
            "</ymin><xmax>%d</xmax><ymax>%d</ymax></bndbox></object>" % (
                obj, "" if d is None else "<difficult>%d</difficult>" % d,
                x0, y0, x1, y1)
            for obj, x0, y0, x1, y1, d in objs)
        (year / "Annotations" / ("%s.xml" % name)).write_text(
            "<annotation><size><width>80</width><height>60</height></size>"
            "%s</annotation>" % body)
    (year / "ImageSets" / "Main" / "trainval.txt").write_text(
        "a\nb\nc\nd\ne\n")
    props = root / "props"
    props.mkdir()
    for name in "ac":
        np.save(props / ("%s.npy" % name), np.random.default_rng(
            ord(name)).uniform(0, 1, (30, 4)).astype(np.float32))
    return root / "VOCdevkit", props


@pytest.mark.parametrize("ignore_difficult", [False, True])
def test_pascal_records_equal_jax(images, tmp_path, ignore_difficult):
    data_dir, props = _voc_corpus(tmp_path, images)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    n_want = jax_pascal.create_records(
        str(data_dir), "VOC2007", "trainval", str(tmp_path / "jax" / "voc"),
        proposal_dir=str(props), num_shards=3,
        ignore_difficult=ignore_difficult)
    n_got = create_pascal_tf_record.main(
        ["--data_dir", str(data_dir), "--proposal_data_path", str(props),
         "--output_path", str(tmp_path / "port" / "voc"), "--num_shards",
         "3"] + (["--ignore_difficult_instances"] if ignore_difficult
                 else []))
    assert n_got == n_want == 5
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(got) == 3 and got == want


@pytest.mark.parametrize("source", ["dir", "tar"])
def test_flickr30k_records_equal_jax(images, tmp_path, source):
    tokens = tmp_path / "results_20130124.token"
    tokens.write_text(
        "a.jpg#0\tA man rides a horse .\n"
        "a.jpg#1\tSomeone on a brown horse, outdoors.\n\n"
        "c.jpg#0\tTwo \"dogs\" play -- in the snow!\n"
        "e.jpg#0\tA child's red ball.\n"
        "zz.jpg#0\tAn image that is not there.\n", encoding="utf-8")
    props = tmp_path / "props"
    props.mkdir()
    np.save(props / "a.npy", np.random.default_rng(2).uniform(
        0, 1, (2100, 4)).astype(np.float32))
    src = str(images / "jpg" if source == "dir" else images / "images.tar")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    n_want = jax_flickr.create_records(
        src, str(tokens), str(tmp_path / "jax" / "f30k"),
        proposal_dir=str(props), num_shards=2)
    n_got = create_flickr30k_tf_record.main(
        ["--image_source", src, "--annotation_path", str(tokens),
         "--proposal_data_path", str(props), "--output_path",
         str(tmp_path / "port" / "f30k"), "--num_shards", "2"])
    assert n_got == n_want == 3
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(got) == 2 and got == want


def _glove(path, dims, rng):
    """A GloVe text file with multi-token keys, a malformed line and a
    word whose fields are not numbers."""
    words = ["a", "dog", "cat", "horse", ",", ".", "man", "the", "'s",
             "on", ". . .", "red", "toy-box", "two"]
    lines = ["%s %s" % (w, " ".join("%.6f" % v for v in rng.normal(
        size=dims))) for w in words]
    lines.insert(3, "broken 0.5 0.25")
    lines.insert(6, "nan-word " + " ".join(["x"] * dims))
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.mark.parametrize("source", ["json", "tsv"])
def test_vocab_files_equal_jax(tmp_path, monkeypatch, source):
    rng = np.random.default_rng(3)
    _glove(tmp_path / "glove.txt", 8, rng)
    captions = ["A dog, a cat and a horse.", "The man's red toy-box . . .",
                "two dogs on the horse", "A cat on a dog", "a man , a cat"]
    if source == "json":
        (tmp_path / "caps.json").write_text(json.dumps({"annotations": [
            {"caption": c, "image_id": i} for i, c in enumerate(captions)]}))
        flags = ["--caption_annotations_file", str(tmp_path / "caps.json")]
    else:
        (tmp_path / "caps.tsv").write_text("".join(
            "%d.jpg#0\t%s\n" % (i, c) for i, c in enumerate(captions)))
        flags = ["--caption_tsv_file", str(tmp_path / "caps.tsv")]
    outs = {}
    for who in ("jax", "port"):
        args = flags + [
            "--glove_file", str(tmp_path / "glove.txt"),
            "--output_vocabulary_file", str(tmp_path / (who + ".txt")),
            "--output_vocabulary_word_embedding_file",
            str(tmp_path / (who + ".npy")), "--min_word_freq", "2"]
        if who == "jax":
            monkeypatch.setattr(sys, "argv", ["create_vocab"] + args)
            jax_vocab.main()
        else:
            words, _ = create_vocab.main(args)
        outs[who] = [(tmp_path / (who + ext)).read_bytes()
                     for ext in (".txt", ".npy")]
    assert outs["port"] == outs["jax"]
    assert words[0] == "a" and "cat" in words and "two" not in words
    glove_port = create_vocab.load_glove(str(tmp_path / "glove.txt"))
    glove_jax = jax_vocab.load_glove(str(tmp_path / "glove.txt"))
    assert sorted(glove_port) == sorted(glove_jax) and ". . ." in glove_port
    assert all(np.array_equal(glove_port[k], glove_jax[k])
               for k in glove_jax)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def test_passthrough_checkpoint_equals_jax(tmp_path, monkeypatch):
    import make_passthrough_checkpoint as jax_tool

    from cap2det_tpu.train import checkpoint as jax_ckpt
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    monkeypatch.setattr(sys, "argv", [
        "make_passthrough_checkpoint", "--output", str(tmp_path / "jax"),
        "--seed", "3"])
    jax_tool.main()
    make_passthrough_checkpoint.write(str(tmp_path / "port.pt"), seed=3)
    want = dict(_leaves(jax_ckpt.restore_params(str(tmp_path / "jax"))))
    got = dict(_leaves(ckpt_lib.restore_params(str(tmp_path / "port.pt"))))
    assert sorted(got) == sorted(want) and len(got) > 100
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_passthrough_overlay_check_refuses_a_wrong_shape(tmp_path):
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    tree = make_passthrough_checkpoint.passthrough_tree(0)
    bn = tree["InceptionV2"]["Mixed_4e"]["Branch_0"]["Conv2d_0a_1x1"][
        "BatchNorm"]
    bn["beta"] = np.zeros(bn["beta"].shape[0] + 1, np.float32)
    path = str(tmp_path / "bad.pt")
    ckpt_lib.save_params(path, params_lib.from_jax_numpy(tree, "cpu"))
    with pytest.raises(ValueError, match="does not fit"):
        make_passthrough_checkpoint.check_overlay(path, 0)


def _rich(out, run_ss, extra, main):
    common = ["--out", str(out), "--num_images", "5", "--height", "64",
              "--width", "96", "--seed", "4"] + extra
    main(["--phase", "images"] + common)
    run_ss(["--image_dir", str(out / "images"), "--output_dir",
            str(out / "ss_npy")])
    main(["--phase", "records", "--eval_fraction", "0.4"] + common)


def test_rich_synthetic_dataset_equals_jax(tmp_path, monkeypatch):
    import make_rich_synthetic_dataset as jax_tool

    def jax_main(argv):
        monkeypatch.setattr(sys, "argv", ["make_rich"] + argv)
        jax_tool.main()

    def jax_run_ss(argv):
        _run_jax_ss(monkeypatch, argv)

    # class_set 9 before 80: the tools swap module globals for 80.
    for extra in (["--caption_style", "synonyms"], ["--class_set", "80"]):
        tag = extra[-1]
        _rich(tmp_path / ("jax" + tag), jax_run_ss, extra, jax_main)
        _rich(tmp_path / ("port" + tag), create_selective_search_data.main,
              extra, make_rich_synthetic_dataset.main)
        for sub in ("", "images", "ss_npy"):
            want = _files(tmp_path / ("jax" + tag) / sub)
            got = _files(tmp_path / ("port" + tag) / sub)
            assert sorted(got) == sorted(want), sub
            assert got == want, sub
        assert {"train.record", "eval.record", "labels.txt",
                "embeddings.npy"} <= set(_files(tmp_path / ("port" + tag)))
