"""Weight carrier and config copy of the PyTorch port against the JAX
package: the params round trip is bit-exact, the port's seeded numpy tree
has the names and shapes of ``Cap2DetModel.init_params``, and every
shipped config parses the same way."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import synthetic
from cap2det_tpu.models import registry as jax_registry
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.models import registry
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.pbtxt")))

_MODEL = """
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6 maxpool_kernel_size: 2 maxpool_stride: 2
    }
    fc_hyperparams {
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: %d
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
"""


@pytest.fixture(scope="module", params=[(3, 2), (20, 3)],
                ids=["3cls_2iter", "20cls_3iter"])
def models(request, tmp_path_factory):
    num_classes, iters = request.param
    classes = ["c%d" % i for i in range(num_classes)]
    label_file = synthetic.write_label_file(
        str(tmp_path_factory.mktemp("p") / "labels.txt"), classes
    )
    text = _MODEL % (iters, label_file)
    jax_model = jax_registry.build(
        jax_schema.loads_pipeline(text).model, compute_dtype=jnp.float32
    )
    port_model = registry.build(
        schema.loads_pipeline(text).model, compute_dtype=torch.float32,
        device="cpu",
    )
    jax_tree = jax.tree.map(np.asarray,
                            jax_model.init_params(jax.random.PRNGKey(0)))
    return jax_tree, port_model


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_round_trip_is_bit_exact(models):
    jax_tree, _ = models
    back = params_lib.to_jax_numpy(params_lib.from_jax_numpy(jax_tree, "cpu"))
    want, got = _flatten(jax_tree), _flatten(back)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        assert got[name].shape == arr.shape, name
        assert np.array_equal(got[name], arr), name


def test_port_layouts(models):
    jax_tree, _ = models
    port = _flatten(params_lib.from_jax_numpy(jax_tree, "cpu"))
    jax_flat = _flatten(jax_tree)
    for name, t in port.items():
        src = jax_flat[name]
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "depthwise_weights":
            kh, kw, cin, mult = src.shape
            assert tuple(t.shape) == (cin, mult, kh, kw), name
        elif src.ndim == 4:
            kh, kw, cin, cout = src.shape
            assert tuple(t.shape) == (cout, cin, kh, kw), name
        elif src.ndim == 2:
            assert tuple(t.shape) == src.shape[::-1], name
        else:
            assert tuple(t.shape) == src.shape, name
        assert t.dtype == torch.float32 and t.is_contiguous(), name


def test_numpy_init_matches_jax_shapes(models):
    jax_tree, port_model = models
    want = _flatten(jax_tree)
    got = _flatten(port_model.init_jax_numpy(1))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        assert got[name].dtype == np.float32, name


def test_numpy_init_is_seeded(models):
    _, port_model = models
    a = _flatten(port_model.init_jax_numpy(3))
    b = _flatten(port_model.init_jax_numpy(3))
    c = _flatten(port_model.init_jax_numpy(4))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)
    w = a["midn/proba_r_given_c/weights"]
    assert np.abs(w).max() <= 2 * 0.01 + 1e-7  # truncated at 2 stddev
    tensors = _flatten(port_model.init_params(3))
    want = _flatten(params_lib.from_jax_numpy(port_model.init_jax_numpy(3),
                                              "cpu"))
    assert set(tensors) == set(want)
    assert all(torch.equal(tensors[k], v) for k, v in want.items())
    assert all(t.device.type == "cpu" for t in tensors.values())


def test_load_pretrained_overlays_like_jax(models):
    """A converted ImageNet tree overlays both stages by layer name; the
    detector heads and the layers the checkpoint lacks keep their
    values."""
    from cap2det_tpu.models import frcnn as jax_frcnn
    from cap2det_tpu_torch.models import frcnn

    jax_tree, port_model = models
    rng = np.random.default_rng(5)
    converted = {"InceptionV2": {
        name: jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            jax_tree[scope]["InceptionV2"][name])
        for scope, name in [
            ("first_stage_feature_extraction", "Conv2d_1a_7x7"),
            ("first_stage_feature_extraction", "Mixed_4e"),
            ("second_stage_feature_extraction", "Mixed_5b")]
    }}
    want = _flatten(jax.tree.map(np.asarray, jax_frcnn.load_pretrained(
        jax_tree, converted)))
    got = _flatten(params_lib.to_jax_numpy(frcnn.load_pretrained(
        params_lib.from_jax_numpy(jax_tree, "cpu"),
        params_lib.from_jax_numpy(converted, "cpu"))))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert np.array_equal(got[name], arr), name
    assert not np.array_equal(
        got["first_stage_feature_extraction/InceptionV2/Mixed_4e/Branch_0/"
            "Conv2d_0a_1x1/weights"],
        _flatten(jax_tree)["first_stage_feature_extraction/InceptionV2/"
                           "Mixed_4e/Branch_0/Conv2d_0a_1x1/weights"])


def _as_dict(cfg):
    """Dataclass config -> plain nested dict of its field values."""
    import dataclasses

    if dataclasses.is_dataclass(cfg):
        return {f.name: _as_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, list):
        return [_as_dict(x) for x in cfg]
    return cfg


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_parse_like_jax(path):
    want = jax_schema.load_pipeline(path)
    got = schema.load_pipeline(path)
    assert _as_dict(got) == _as_dict(want)
    if want.model.cap2det_model is not None:
        for name in ("cap2det_model",):
            w, g = getattr(want.model, name), getattr(got.model, name)
            assert _as_dict(g) == _as_dict(w)
            assert (_as_dict(g.midn_post_processor)
                    == _as_dict(w.midn_post_processor))
        assert (_as_dict(got.eval_reader.cap2det_reader)
                == _as_dict(want.eval_reader.cap2det_reader))
