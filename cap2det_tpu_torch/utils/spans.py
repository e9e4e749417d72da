"""Named spans at the port's layer boundaries, on ``torch.profiler``'s
clock.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
profiler records, so the span lands in the same chrome trace as the
card's kernels (CUPTI) and the host's operators. While none records it
returns one shared no-op context and makes no ``record_function``: a
span then costs one check of the profiler's state. A profiler that is
recording is the only switch (the trainer's ``profile_steps``,
``tools/profile_step``, the benchmark's traced phase).

The names are read by exact name, and a child's name extends its
parent's:

* trainer: ``cap2det/step`` (args: the step number) around
  ``cap2det/step/forward``, ``cap2det/step/backward`` and
  ``cap2det/step/update``; ``cap2det/feed/wait`` in ``train()``;
* model: ``cap2det/batch/place``, ``cap2det/model/bn_fold``,
  ``cap2det/model/first_stage``, ``cap2det/model/second_stage``,
  ``cap2det/model/heads``, ``cap2det/model/losses``;
* evaluator: ``cap2det/predict`` (args: the image id) around
  ``cap2det/predict/upload``, ``cap2det/predict/resize`` and
  ``cap2det/predict/forward`` (each scale), ``cap2det/predict/mean`` and
  ``cap2det/predict/fetch``;
* postprocess: ``cap2det/postprocess/softmax`` and
  ``cap2det/postprocess/nms`` (each iteration);
* kernels: ``cap2det/kernel/<name>`` inside each wrapper that
  ``kernels.launch_counts()`` counts, under its name there.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name, args=None):
    """A context that records the span `name` while a profiler records,
    with `args` (made a string only then) as its arguments."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(
        name, None if args is None else str(args))
