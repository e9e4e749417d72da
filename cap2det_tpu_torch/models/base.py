"""Model protocol (port of ``cap2det_tpu/models/base.py``).

The reference's ModelBase ABC (models/model_base.py:9-74) exposes
build_prediction / build_loss / build_evaluation / get_variables_to_train
/ get_scaffold on a graph-building object. In the port a model is an
object on one device whose methods take the params tree and a batch:

  init_params(seed)                -> params tree on the model's device
  pipeline_kwargs()                -> extras the input pipeline needs
  device_batch(host_batch)         -> tensor dict on the model's device
  loss(params, batch, generator, is_training) -> (total, loss_dict)
  predictions(prepared, batch, ...) -> prediction dict (detectors)
  non_trainable_paths / non_trainable_substrings -> frozen params
                                      (subsumes get_variables_to_train)

``generator`` is the ``torch.Generator`` that dropout draws from (JAX's
``rng``). Checkpoints live in train/checkpoint.py; warm starts are
explicit (``load_pretrained``, extractor checkpoints).
"""

from __future__ import annotations

import abc


class ModelBase(abc.ABC):
    non_trainable_paths = ()
    non_trainable_substrings = ()

    @abc.abstractmethod
    def init_params(self, seed):
        ...

    def pipeline_kwargs(self):
        return {}

    @abc.abstractmethod
    def device_batch(self, host_batch):
        ...

    @abc.abstractmethod
    def loss(self, params, batch, generator=None, is_training=True):
        ...
