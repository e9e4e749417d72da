"""Every shipped config builds in the port and takes one finite
``train(device="cpu")`` step on synthetic data: the port's counterpart
of ``tests/test_configs_smoke.py``, with the same retargeting (the label,
vocabulary and embedding files, a seeded 300-d table, a synthesised text
checkpoint; readers cut to batch <= 4, P <= 16 and min dimension 64).
The model sections run as shipped.

The four configs that no other test of the port steps
(``AGAINST_JAX``) are held against JAX ``train(use_mesh=False)``: both
sides in float32 (JAX without Pallas) from the port's initial params,
dropout off, the same records; every first-step loss to rtol 1e-4, the
``LOSS_RTOL`` of ``tests/test_torch_train_loop.py``.
``flickr30k_text_classifier_match`` reads one synthesised classifier,
written in each package's checkpoint format.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.train import checkpoint as jax_ckpt_lib
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.text import extractors
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, "configs", "*.pbtxt")))
AGAINST_JAX = ("coco17_exact_match.pbtxt", "coco17_groundtruth.pbtxt",
               "flickr30k_text_classifier_match.pbtxt",
               "voc07_groundtruth.pbtxt")
LOSS_RTOL = 1e-4


def _classes_from_label_file(path):
    with open(path) as fid:
        lines = [l.rstrip("\n") for l in fid if l.strip()]
    # extend-match synonym tables are "class<TAB>syn,syn,...".
    return [l.split("\t")[0] for l in lines]


def _fix_extractor_paths(ext_cfg, tmp_path):
    """Retargets the label, vocabulary, embedding and checkpoint files
    (as ``tests/test_configs_smoke.py`` does); returns the class list
    and, where the config reads a text classifier, its weights as a
    JAX-layout numpy tree."""
    ext_cfg.label_file = os.path.join(REPO, ext_cfg.label_file)
    classes = _classes_from_label_file(ext_cfg.label_file)
    if getattr(ext_cfg, "open_vocabulary_file", ""):
        ext_cfg.open_vocabulary_file = os.path.join(
            REPO, ext_cfg.open_vocabulary_file)
        with open(ext_cfg.open_vocabulary_file) as fid:
            vocab_size = sum(1 for l in fid if l.strip())
        emb_path = str(tmp_path / "open_vocab_300d.npy")
        rng = np.random.default_rng(0)
        np.save(emb_path,
                rng.normal(0, 0.1, (vocab_size, 300)).astype(np.float32))
        ext_cfg.open_vocabulary_word_embedding_file = emb_path
    tree = None
    if getattr(ext_cfg, "text_classifier_checkpoint_file", ""):
        tree = extractors.TextClassifierMatchExtractor(
            ext_cfg, device="cpu").init_params_numpy(0)
        ext_cfg.text_classifier_checkpoint_file = str(tmp_path / "text_ckpt")
        ckpt_lib.save_params(ext_cfg.text_classifier_checkpoint_file,
                             params_lib.from_jax_numpy(tree, "cpu"))
    return classes, tree


def _shrink_reader(reader_cfg, record_path):
    r = reader_cfg.cap2det_reader
    r.input_pattern = [record_path]
    r.shuffle_buffer_size = 4
    r.batch_size = min(r.batch_size, 4)
    r.max_num_proposals = min(r.max_num_proposals, 16)
    if r.image_resizer is not None and (
            r.image_resizer.keep_aspect_ratio_resizer):
        r.image_resizer.keep_aspect_ratio_resizer.min_dimension = 64


def _retarget(cfg, tmp_path):
    """Points `cfg` at files under tmp_path and at 8 seeded records;
    returns the text classifier's tree (or None)."""
    model_cfg = cfg.model
    if model_cfg.cap2det_model is not None:
        ext = model_cfg.cap2det_model.label_extractor
        classes, tree = _fix_extractor_paths(
            getattr(ext, ext.which_oneof()), tmp_path)
    else:
        classes, tree = _fix_extractor_paths(
            model_cfg.text_model.label_extractor, tmp_path)
        _fix_extractor_paths(model_cfg.text_model.text_classifier, tmp_path)
    record = str(tmp_path / "train.record")
    if not os.path.exists(record):
        synthetic.write_synthetic_dataset(
            record, num_examples=8, seed=7, classes=classes[:6],
            image_hw=(72, 96), num_proposals=16,
            with_image=cfg.train_reader.cap2det_reader.decode_image)
    _shrink_reader(cfg.train_reader, record)
    _shrink_reader(cfg.eval_reader, record)
    return tree


def _losses_hook(out):
    return lambda step, state, logs: out.append(
        {k: float(v) for k, v in logs.items() if k.startswith("loss/")})


def _port_config(name, tmp_path):
    cfg = schema.load_pipeline(os.path.join(REPO, "configs", name))
    return cfg, _retarget(cfg, tmp_path)


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if n not in AGAINST_JAX])
def test_config_builds_and_steps(name, tmp_path):
    cfg, _ = _port_config(name, tmp_path)
    losses = []
    state = trainer.train(cfg, model_dir=None, max_steps=1, device="cpu",
                          hooks=[_losses_hook(losses)])
    assert state["step"] == 1
    assert len(losses) == 1 and all(
        np.isfinite(v) for v in losses[0].values()), losses


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_config_steps_as_jax(name, tmp_path, monkeypatch):
    cfg, tree = _port_config(name, tmp_path)
    jax_cfg = jax_schema.load_pipeline(os.path.join(REPO, "configs", name))
    _retarget(jax_cfg, tmp_path)
    if tree is not None:
        ext = jax_cfg.model.cap2det_model.label_extractor
        ext_cfg = getattr(ext, ext.which_oneof())
        ext_cfg.text_classifier_checkpoint_file = str(tmp_path / "text_jax")
        jax_ckpt_lib.save_params(ext_cfg.text_classifier_checkpoint_file,
                                 jax.tree.map(jnp.asarray, tree))
    for c in (cfg, jax_cfg):
        c.model.cap2det_model.frcnn_options.dropout_keep_prob = 1.0

    port_build = registry.build
    monkeypatch.setattr(registry, "build", lambda c, **kw: port_build(
        c, **dict(kw, compute_dtype=torch.float32)))
    init = registry.build(cfg.model, device="cpu").init_jax_numpy(0)
    real_build = jax_registry.build

    def jax_build(c, **kwargs):
        model = real_build(c, **dict(kwargs, compute_dtype=jnp.float32,
                                     use_pallas=False))
        model.init_params = lambda rng: jax.tree.map(jnp.asarray, init)
        return model

    got, want = [], []
    state = trainer.train(cfg, model_dir=None, max_steps=1, device="cpu",
                          hooks=[_losses_hook(got)])
    with monkeypatch.context() as mp:
        mp.setattr(jax_registry, "build", jax_build)
        jax_trainer.train(jax_cfg, model_dir=None, max_steps=1,
                          use_mesh=False, hooks=[_losses_hook(want)])
    assert state["step"] == 1
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    for key, value in want[0].items():
        assert np.isfinite(got[0][key]), key
        np.testing.assert_allclose(got[0][key], value, rtol=LOSS_RTOL,
                                   err_msg=key)


def test_all_nine_configs_are_covered():
    assert len(CONFIGS) == 9
    assert set(AGAINST_JAX) < set(CONFIGS)
