"""An embedding table with flax's ``Embed`` initialisation and its
``attend`` call (no JAX counterpart file: flax's ``nn.Embed``).

``Embed(vocab, dim)`` is an ``nn.Embedding`` whose weight starts as a
normal of variance ``1 / dim`` (flax's default embedding init), and whose
:meth:`Embed.attend` computes the tied decoder's logits ``x E^T`` (no
bias). K-FAC's capture registers it like an ``nn.Embedding`` and, with
tied embeddings on, wraps ``attend`` to capture that call site too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Embed(nn.Embedding):
    """``forward(ids) -> (..., dim)`` lookup; ``attend(x) -> (..., vocab)``
    logits against the same table."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__(num_embeddings, embedding_dim)
        nn.init.normal_(self.weight, std=embedding_dim ** -0.5)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)
