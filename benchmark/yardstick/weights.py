"""The weights of a configuration, made on the device from a seed.

One flat buffer of truncated normals is drawn with a ``torch.Generator``
on the device in one call, then cut into the leaves of
``reference.cap2det.param_spec`` (the configuration's backbone, then the
heads) and scaled by each leaf's deviation.
Both the program and the reference are handed the same tensors (the
reference a copy), in PyTorch layout."""

from __future__ import annotations

import math

import torch

from benchmark.reference import cap2det as ref


def make_params(model, seed, device):
    """{path...: float32 tensor} nested as the program's params tree."""
    leaves, empty = ref.param_spec(model)
    normal = [(path, shape, std) for path, shape, std in leaves
              if not isinstance(std, str)]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    values, offset = [], 0
    for path, shape, std in leaves:
        if std == "zeros":
            values.append((path, torch.zeros(shape, device=device)))
        elif std == "ones":
            values.append((path, torch.ones(shape, device=device)))
        else:
            n = math.prod(shape)
            values.append((path, (flat[offset:offset + n] * std).view(shape)))
            offset += n
    return ref.nest(values, empty)


def to_device(tree, device):
    """A detached copy of a params tree on `device`."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.detach().to(device, copy=True) for k, v in tree.items()}
