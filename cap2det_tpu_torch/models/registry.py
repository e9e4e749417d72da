"""Model registry: config-dataclass type -> model class (port of
``cap2det_tpu/models/registry.py``)."""

from __future__ import annotations

_REGISTRY = {}


def register_model_class(config_cls, model_cls):
    if config_cls in _REGISTRY:
        raise ValueError("duplicate registration for %r" % config_cls)
    _REGISTRY[config_cls] = model_cls


def build(model_config, is_training=False, **kwargs):
    """Builds the model for a schema.Model config."""
    which = model_config.which_oneof()
    if which is None:
        raise ValueError("model config has no extension set")
    sub = getattr(model_config, which)
    model_cls = _REGISTRY.get(type(sub))
    if model_cls is None:
        raise ValueError("no model registered for %r" % type(sub))
    return model_cls(sub, is_training=is_training, **kwargs)
