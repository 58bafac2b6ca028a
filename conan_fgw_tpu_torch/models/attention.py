"""Self-attention of the classification model (port of
``conan_fgw_tpu/models/attention.py``).

The model applies ``SelfAttention`` to sequences of length 1 (one fused
embedding per conformer), where the softmax over a singleton is 1 and the
block reduces to its value projection; the general form is kept, as in the
JAX package. ``AttentionLayer`` is the reference's unused
``Attention_Layer``, which the JAX package keeps for inventory parity.
"""

from __future__ import annotations

import torch
from torch import nn


class AttentionLayer(nn.Module):
    """Gated softmax attention map ``softmax(x * lin(x), dim=1)``; ``lin``
    is flax's ``Dense_0``."""

    def __init__(self, n_feats: int):
        super().__init__()
        self.lin = nn.Linear(n_feats, n_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x * self.lin(x), dim=1)


class SelfAttention(nn.Module):
    """``softmax(q k^T / sqrt(d)) v`` with ``q, k, v`` three Linear maps of
    ``x (..., L, D)``; ``qkv.0/1/2`` are flax's ``Dense_0/1/2``."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.qkv = nn.ModuleList(nn.Linear(input_dim, input_dim) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (lin(x) for lin in self.qkv)
        scores = q @ k.transpose(-1, -2) / (self.input_dim ** 0.5)
        return torch.softmax(scores, dim=-1) @ v
