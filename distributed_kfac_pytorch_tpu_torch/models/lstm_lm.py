"""LSTM language model (PyTorch port of
``distributed_kfac_pytorch_tpu/models/lstm_lm.py``).

Embedding -> dropout -> K-FAC-friendly LSTM stack -> dropout -> decoder.
With ``tie_weights`` there is no decoder: the logits are
``embed.attend(x)``, ``x E^T`` with no bias, as flax's ``Embed.attend``.
Submodule names match the flax model (``embed``, ``lstm``, ``decoder``).
``dtype`` is the compute dtype, as the JAX model's: the embedding, every
gate Linear, the decoder and the attend compute in it with fp32
parameters, and the cell state is carried in it
(``modules.precision.set_compute_dtype``).
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch.modules.embed import Embed
from distributed_kfac_pytorch_tpu_torch.modules.lstm import LSTM, dense, \
    dropout
from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)


class LSTMLanguageModel(nn.Module):
    """``forward(ids (B, T) int) -> (logits (B, T, vocab), states)``.

    ``dropout_generator`` (a ``torch.Generator`` on the model's device)
    draws every dropout mask of a training-mode call.
    """

    def __init__(self, vocab_size: int, embedding_dim: int = 650,
                 hidden_dim: int = 650, num_layers: int = 2,
                 dropout: float = 0.5, tie_weights: bool = False,
                 kfac_cell: bool = True, dtype=torch.float32):
        super().__init__()
        dtype = check_compute_dtype(dtype)
        if tie_weights and embedding_dim != hidden_dim:
            raise ValueError('tie_weights requires embedding_dim == '
                             f'hidden_dim, got {embedding_dim} and '
                             f'{hidden_dim}')
        self.dropout = dropout
        self.tie_weights = tie_weights
        self.embed = Embed(vocab_size, embedding_dim)
        self.lstm = LSTM(embedding_dim, hidden_dim, num_layers=num_layers,
                         dropout=dropout, kfac_cell=kfac_cell)
        if not tie_weights:
            self.decoder = dense(hidden_dim, vocab_size)
        set_compute_dtype(self, dtype)

    def forward(self, ids, states=None, *,
                dropout_generator: torch.Generator | None = None):
        x = dropout(self.embed(ids), self.dropout, self.training,
                    dropout_generator)
        x, states = self.lstm(x, states,
                              dropout_generator=dropout_generator)
        x = dropout(x, self.dropout, self.training, dropout_generator)
        if self.tie_weights:
            logits = self.embed.attend(x)
        else:
            logits = self.decoder(x)
        return logits, states
