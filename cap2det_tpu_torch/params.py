"""Weight carrier between the JAX params tree and the port's tensors.

The JAX package keeps its parameters as a nested dict of arrays with
TF-slim names (``InceptionV2/Mixed_4e/Branch_2/Conv2d_0b_3x3/weights``).
The port keeps the same nesting and names, with each leaf a torch tensor
in PyTorch's layout:

  =====================  ====================  =======================
  leaf                   JAX layout            port layout
  =====================  ====================  =======================
  conv ``weights``       HWIO [kh,kw,cin,cout]  OIHW [cout,cin,kh,kw]
  ``pointwise_weights``  HWIO [1,1,cin*m,cout]  OIHW [cout,cin*m,1,1]
  ``depthwise_weights``  [kh,kw,cin,m]          [cin,m,kh,kw]
  FC ``weights``         [in,out]               [out,in] (F.linear)
  word-embedding table   [vocab,dims]           [dims,vocab] (read as
                                                its transpose)
  vectors (BN, biases)   [n]                    [n]
  =====================  ====================  =======================

Every conversion is a pure permutation of float32 values, so
``to_jax_numpy(from_jax_numpy(tree))`` returns the tree bit-exactly.
"""

from __future__ import annotations

import numpy as np
import torch

# Leaf name -> (JAX->port axis order, port->JAX axis order) for 4-D leaves.
_PERM_4D = {
    "weights": ((3, 2, 0, 1), (2, 3, 1, 0)),
    "pointwise_weights": ((3, 2, 0, 1), (2, 3, 1, 0)),
    "depthwise_weights": ((2, 3, 0, 1), (2, 3, 0, 1)),
}


def _leaf_to_port(name, arr):
    arr = np.asarray(arr)
    if arr.ndim == 4:
        arr = arr.transpose(_PERM_4D[name][0])
    elif arr.ndim == 2:
        arr = arr.T
    elif arr.ndim != 1:
        raise ValueError("unexpected %d-D param %r" % (arr.ndim, name))
    return torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def _leaf_to_jax(name, t):
    arr = t.detach().cpu().numpy()
    if arr.ndim == 4:
        arr = arr.transpose(_PERM_4D[name][1])
    elif arr.ndim == 2:
        arr = arr.T
    return np.ascontiguousarray(arr)


def _map_tree(fn, tree):
    return {
        k: _map_tree(fn, v) if isinstance(v, dict) else fn(k, v)
        for k, v in tree.items()
    }


def resolve_device(device):
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


def from_jax_numpy(tree, device="cuda"):
    """JAX-layout params tree (numpy or jax arrays) -> port tensors on
    `device` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return _map_tree(
        lambda k, v: _leaf_to_port(k, v).to(device), tree
    )


def to_jax_numpy(tree):
    """Port tensors -> JAX-layout numpy tree (inverse of from_jax_numpy)."""
    return _map_tree(_leaf_to_jax, tree)


def truncated_normal(rng, shape, stddev):
    """float32 normal samples truncated to +-2 standard deviations by
    redrawing, as ``jax.random.truncated_normal(-2, 2) * stddev``."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * stddev).astype(np.float32)
