"""The port's selective search and Felzenszwalb segmentation
(``cap2det_tpu_torch/native``, built from ``csrc/host/selective_search.cc``
by the host compiler) against the JAX package's ``cap2det_tpu.native``, on
seeded images: boxes and label maps equal with ``np.array_equal``
(tolerance: none). The JAX library is loaded as ``tests/test_native.py``
loads it, never rebuilt here. Also ``tests/test_ss_recall.py``'s golden
partition and k extremes and ``tests/test_native.py``'s toy-scene checks
on the port, and the host build's rules: its own directory and key, no
nvcc, and an error, not a fallback, when no compiler is found."""

import numpy as np
import pytest
import torch

from cap2det_tpu import native as jax_native
from cap2det_tpu_torch import native
from cap2det_tpu_torch.kernels import build

torch.set_num_threads(1)


def _toy_image(seed=0):
    img = np.full((120, 160, 3), 40, np.uint8)
    img[20:60, 20:70] = [200, 30, 30]
    img[70:110, 90:150] = [30, 200, 30]
    noise = np.random.RandomState(seed).randint(0, 12, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _iou(a, b):
    iy = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ix = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iy * ix
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-12)


def _rich_scene(rng, hw=(240, 320), num_objects=6):
    """tests/test_ss_recall.py's scene: textured objects on a textured
    background."""
    h, w = hw
    image = rng.normal(110, 12, (h, w, 3)).clip(0, 255).astype(np.uint8)
    gt = []
    for _ in range(num_objects):
        for _attempt in range(50):
            oh = int(rng.uniform(0.12, 0.35) * h)
            ow = int(rng.uniform(0.12, 0.35) * w)
            y0 = int(rng.uniform(0, h - oh))
            x0 = int(rng.uniform(0, w - ow))
            box = (y0 / h, x0 / w, (y0 + oh) / h, (x0 + ow) / w)
            if all(_iou(box, g) < 0.2 for g in gt):
                break
        color = rng.uniform(0, 255, 3)
        patch = rng.normal(0, 10, (oh, ow, 3)) + color
        image[y0:y0 + oh, x0:x0 + ow] = patch.clip(0, 255).astype(np.uint8)
        gt.append(box)
    return image, np.array(gt, np.float32)


def _bands(h=60, w=90):
    image = np.zeros((h, w, 3), np.uint8)
    image[:, :30] = (30, 30, 30)
    image[:, 30:60] = (128, 128, 128)
    image[:, 60:] = (230, 230, 230)
    return image


def _noise(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,),
                                                 dtype=np.uint8)


IMAGES = {
    "toy": lambda: _toy_image(),
    "toy_seed3": lambda: _toy_image(3),
    "rich_a": lambda: _rich_scene(np.random.default_rng(3))[0],
    "rich_b": lambda: _rich_scene(np.random.default_rng(8), (150, 110))[0],
    "bands": _bands,
    "1x37": lambda: _noise((1, 37), 1),
    "37x1": lambda: _noise((37, 1), 2),
    "1x1": lambda: _noise((1, 1), 3),
    "odd_33x47": lambda: _noise((33, 47), 4),
    "odd_71x29": lambda: _noise((71, 29), 5),
    "flat": lambda: np.full((24, 40, 3), 77, np.uint8),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_selective_search_equals_jax(name):
    image = IMAGES[name]()
    for quality in (True, False):
        for seed in (0, 1, 12345):
            want = jax_native.selective_search(image, quality=quality,
                                               seed=seed)
            got = native.selective_search(image, quality=quality, seed=seed)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got, want), (name, quality, seed)


@pytest.mark.parametrize("min_box_side,max_boxes",
                         [(1, 4000), (10, 4000), (20, 50), (20, 1), (200, 9)])
def test_selective_search_options_equal_jax(min_box_side, max_boxes):
    image, _ = _rich_scene(np.random.default_rng(11), (96, 128))
    want = jax_native.selective_search(image, min_box_side=min_box_side,
                                       seed=7, max_boxes=max_boxes)
    got = native.selective_search(image, min_box_side=min_box_side, seed=7,
                                  max_boxes=max_boxes)
    assert got.shape == want.shape and len(got) <= max_boxes
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["toy", "rich_b", "bands", "1x37", "37x1",
                                  "odd_33x47", "flat"])
@pytest.mark.parametrize("k,min_size", [(50.0, 10), (100.0, 20),
                                        (300.0, 50), (1e6, 1), (0.5, 1)])
def test_felzenszwalb_equals_jax(name, k, min_size):
    image = IMAGES[name]()
    want = jax_native.felzenszwalb(image, k=k, min_size=min_size)
    got = native.felzenszwalb(image, k=k, min_size=min_size)
    assert got.dtype == np.int32 and got.shape == image.shape[:2]
    assert np.array_equal(got, want)


def test_felzenszwalb_segments_regions():
    labels = native.felzenszwalb(_toy_image(), k=300, min_size=50)
    assert len({labels[40, 45], labels[90, 120], labels[5, 5]}) == 3


def test_proposals_cover_objects_and_are_deterministic():
    boxes = native.selective_search(_toy_image(), quality=True)
    assert len(boxes) > 10
    assert (boxes[:, 2] > boxes[:, 0]).all() and (boxes[:, 3] > boxes[:, 1]
                                                  ).all()
    assert boxes.min() >= 0.0 and boxes.max() <= 1.0
    for gt in [(20 / 120, 20 / 160, 60 / 120, 70 / 160),
               (70 / 120, 90 / 160, 110 / 120, 150 / 160)]:
        assert max(_iou(b, gt) for b in boxes) > 0.6
    np.testing.assert_array_equal(native.selective_search(_toy_image(),
                                                          seed=7),
                                  native.selective_search(_toy_image(),
                                                          seed=7))


def test_felzenszwalb_golden_partition():
    """test_ss_recall.py's three bands: each band interior is one segment,
    the three interiors distinct."""
    labels = native.felzenszwalb(_bands(), k=50.0, min_size=10)
    margin = 4
    ids = []
    for interior in (labels[:, :30 - margin],
                     labels[:, 30 + margin:60 - margin],
                     labels[:, 60 + margin:]):
        u = np.unique(interior)
        assert len(u) == 1, u
        ids.append(int(u[0]))
    assert len(set(ids)) == 3


def test_felzenszwalb_k_extremes():
    image = np.full((40, 60, 3), 100, np.uint8)
    image[:, 30:] = 160
    assert len(np.unique(native.felzenszwalb(image, k=1e6,
                                             min_size=10))) == 1
    split = native.felzenszwalb(image, k=10.0, min_size=10)
    assert len(np.unique(split)) >= 2 and split[20, 5] != split[20, 55]


def test_recall_on_rich_scenes():
    """test_ss_recall.py's recall bar, on two of its scenes."""
    rng = np.random.default_rng(3)
    for _ in range(2):
        image, gt = _rich_scene(rng)
        props = native.selective_search(image, quality=True, min_box_side=10)
        hits = sum(any(_iou(p, g) >= 0.5 for p in props[:500]) for g in gt)
        assert hits / len(gt) >= 0.8


def test_refuses_an_image_that_is_not_rgb():
    with pytest.raises(ValueError, match="RGB"):
        native.selective_search(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="RGB"):
        native.felzenszwalb(np.zeros((8, 8, 4), np.uint8))


def test_host_build_rules(tmp_path, monkeypatch):
    """The host source never goes to nvcc; a fresh build lands in its own
    keyed directory and gives the same boxes; the key moves with the
    flags; no compiler is an error."""
    assert all(p.suffix == ".cu" for p in build._sources())
    assert build.HOST_BUILD_ROOT.relative_to(
        build.CSRC.parents[1]).as_posix() == "build/torch_host"
    cxx = build._cxx()
    sources = sorted(build.HOST_SRC.glob("*.cc"))
    assert [s.name for s in sources] == ["selective_search.cc"]
    key = build._host_key(cxx, sources)
    monkeypatch.setattr(build, "HOST_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_host_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    image = _toy_image(5)
    assert np.array_equal(native.selective_search(image),
                          jax_native.selective_search(image))
    assert (tmp_path / key / build.HOST_LIB_NAME).is_file()
    assert build.host_build_info["built"] and build.host_build_info[
        "key"] == key
    monkeypatch.setattr(build, "HOST_CXX_FLAGS", build.HOST_CXX_FLAGS + [
        "-march=native"])
    assert build._host_key(cxx, sources) != key
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build._cxx()
    monkeypatch.setattr(build, "_host_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native.selective_search(image)
