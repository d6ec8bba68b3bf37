"""An embedding table with flax's ``Embed`` initialisation and its
``attend`` call (no JAX counterpart file: flax's ``nn.Embed``).

``Embed(vocab, dim)`` is an ``nn.Embedding`` whose weight starts as a
normal of variance ``1 / dim`` (flax's default embedding init), and whose
:meth:`Embed.attend` computes the tied decoder's logits ``x E^T`` (no
bias). K-FAC's capture registers it like an ``nn.Embedding`` and, with
tied embeddings on, wraps ``attend`` to capture that call site too. Under
a compute dtype (``modules.precision.set_compute_dtype`` sets
``compute_dtype``) ``attend`` casts its query and the table to it, as
flax's ``Embed.attend`` promotes both to its ``dtype``.
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
        self.compute_dtype = None

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return F.linear(x, self.weight)
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))
