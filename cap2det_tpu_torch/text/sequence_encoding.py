"""Caption sequence encoders: masked average pooling and LSTM (port of
``cap2det_tpu/text/sequence_encoding.py``; reference
core/sequence_encoding.py:11-113, a vestigial module there whose config
proto was never checked in, kept for capability parity). The oneof
factory takes small dataclass configs.

The LSTM is a plain loop over time: the caption axis is short (tens of
tokens). Its params are a JAX-layout dict of [in, 4H] / [H, 4H] / [4H]
tensors used as they are (``x @ kernel``), gates in JAX's i, f, g, o
order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.ops import masked
from cap2det_tpu_torch.text import classifier


@dataclass
class AverageEncoder:
    pass


@dataclass
class LstmEncoder:
    hidden_units: int = 128


def average_encode(embeddings, lengths):
    """Masked mean over time: [B, T, D], [B] -> [B, D]."""
    mask = masked.sequence_mask(lengths, embeddings.shape[1])
    return masked.masked_avg_nd(embeddings, mask, dim=1, keepdim=False)


def init_lstm_params(seed_or_rng, input_dim, hidden_units, device="cuda"):
    """Glorot-uniform kernels from a seeded numpy generator (JAX draws them
    with ``jax.random``) and a zero bias, as tensors on `device` (the card
    unless the caller asks for the CPU)."""
    device = params_lib.resolve_device(device)
    rng = np.random.default_rng(seed_or_rng)

    def glorot(fan_in, fan_out):
        return torch.from_numpy(classifier.glorot_uniform(
            rng, fan_in, fan_out)).to(device)

    return {
        "kernel": glorot(input_dim, 4 * hidden_units),
        "recurrent": glorot(hidden_units, 4 * hidden_units),
        "bias": torch.zeros((4 * hidden_units,), dtype=torch.float32,
                            device=device),
    }


def lstm_encode(params, embeddings, lengths):
    """LSTM over time, returning the last valid hidden state [B, H]."""
    batch, time, _ = embeddings.shape
    hidden = params["recurrent"].shape[0]
    h = torch.zeros((batch, hidden), dtype=embeddings.dtype,
                    device=embeddings.device)
    c = torch.zeros_like(h)
    for t in range(time):
        gates = (embeddings[:, t] @ params["kernel"]
                 + h @ params["recurrent"] + params["bias"])
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        # forget_bias=1.0: BasicLSTMCell semantics (reference
        # core/sequence_encoding.py builds the default cell).
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
    return h


def get_encode_fn(config, seed=None, input_dim=None, device="cuda"):
    """Factory (reference :72-113): returns (params, encode_fn)."""
    if isinstance(config, AverageEncoder):
        return {}, lambda params, emb, lengths: average_encode(emb, lengths)
    if isinstance(config, LstmEncoder):
        params = init_lstm_params(seed, input_dim, config.hidden_units,
                                  device)
        return params, lambda params, emb, lengths: lstm_encode(
            params, emb, lengths
        )
    raise ValueError("unknown encoder config %r" % (config,))
