"""LSTM built from ``nn.Linear`` submodules so K-FAC sees every gate
(PyTorch port of ``distributed_kfac_pytorch_tpu/modules/lstm.py``).

Each gate (or fused gate stack) is an ``nn.Linear`` that ``KFACCapture``
registers, with one ``(a, g)`` capture per timestep: the timestep loop is
a Python unroll, so a layer's factors are the sum of its per-call factors.
Inputs are batch-major ``(batch, time, features)``. Submodule names match
the flax modules (``layer{l}_d{d}.cell.w_{g}{x|h}``, ``w_ih``, ``w_hh``),
so parameters convert name for name (``convert.py``); weights start as
flax's Dense defaults (truncated-normal LeCun kernel, zero bias).
"""

from __future__ import annotations

import math

import torch
from torch import nn

GATES = ('i', 'f', 'g', 'o')


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal of variance ``1 / fan_in``
    truncated at two standard deviations (of the untruncated normal)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def dense(in_features: int, out_features: int,
          bias: bool = True) -> nn.Linear:
    """``nn.Linear`` initialized as a flax ``Dense``."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    with torch.no_grad():
        lecun_normal_(layer.weight, in_features)
        if bias:
            layer.bias.zero_()
    return layer


class LSTMCellKFAC(nn.Module):
    """LSTM cell with 8 per-gate ``nn.Linear`` (one K-FAC block per gate),
    gate order (i, f, g, o); every projection carries a bias."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for g in GATES:
            self.add_module(f'w_{g}x', dense(input_size, hidden_size))
            self.add_module(f'w_{g}h', dense(hidden_size, hidden_size))

    def forward(self, x, state):
        h, c = state
        z = {g: getattr(self, f'w_{g}x')(x) + getattr(self, f'w_{g}h')(h)
             for g in GATES}
        new_c = (torch.sigmoid(z['f']) * c
                 + torch.sigmoid(z['i']) * torch.tanh(z['g']))
        new_h = torch.sigmoid(z['o']) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class LSTMCell(nn.Module):
    """LSTM cell with 2 fused 4H ``nn.Linear`` (input and recurrent): two
    K-FAC blocks per cell."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_ih = dense(input_size, 4 * hidden_size)
        self.w_hh = dense(hidden_size, 4 * hidden_size)

    def forward(self, x, state):
        h, c = state
        i, f, g, o = torch.chunk(self.w_ih(x) + self.w_hh(h), 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class LSTMLayer(nn.Module):
    """One direction of one layer: the Python-unrolled timestep loop.

    ``lengths`` (a ``(batch,)`` integer tensor) masks rows past their
    length as the JAX layer does: their cell inputs (x_t and the
    recurrent h and c) are zeroed, their state is carried unchanged and
    their outputs are zero. Returns ``(outputs (B, T, H), (h, c))``.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 kfac_cell: bool = True, reverse: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.cell = (LSTMCellKFAC if kfac_cell else LSTMCell)(
            input_size, hidden_size)

    def forward(self, xs, state=None, lengths=None):
        batch = xs.shape[0]
        if state is None:
            h = xs.new_zeros((batch, self.hidden_size))
            state = (h, h)
        steps = range(xs.shape[1])
        if self.reverse:
            steps = reversed(steps)
        outs = []
        for t in steps:
            if lengths is None:
                y, state = self.cell(xs[:, t], state)
            else:
                mask = (t < lengths).to(xs.dtype)[:, None]
                h_old, c_old = state
                y_new, (h_new, c_new) = self.cell(
                    xs[:, t] * mask, (h_old * mask, c_old * mask))
                state = (torch.where(mask > 0, h_new, h_old),
                         torch.where(mask > 0, c_new, c_old))
                y = y_new * mask
            outs.append(y)
        if self.reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=1), state


class LSTM(nn.Module):
    """Stacked (optionally bidirectional) K-FAC-friendly LSTM: directions
    concatenated, dropout between stacked layers only (not after the
    last). ``states`` is a list with one ``(h, c)`` per layer-direction;
    ``dropout_generator`` seeds the dropout masks in training mode."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 bidirectional: bool = False, kfac_cell: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.n_dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            size = input_size if layer == 0 else hidden_size * self.n_dirs
            for d in range(self.n_dirs):
                self.add_module(f'layer{layer}_d{d}', LSTMLayer(
                    size, hidden_size, kfac_cell=kfac_cell,
                    reverse=(d == 1)))

    def forward(self, xs, states=None, *, lengths=None,
                dropout_generator: torch.Generator | None = None):
        if states is None:
            states = [None] * (self.num_layers * self.n_dirs)
        new_states = []
        out = xs
        for layer in range(self.num_layers):
            dirs = []
            for d in range(self.n_dirs):
                seq, st = getattr(self, f'layer{layer}_d{d}')(
                    out, states[layer * self.n_dirs + d], lengths=lengths)
                dirs.append(seq)
                new_states.append(st)
            out = dirs[0] if self.n_dirs == 1 else torch.cat(dirs, -1)
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, self.training,
                              dropout_generator)
        return out, new_states


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (the flax
    ``Dropout`` form: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``); the identity outside training or at
    rate 0."""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
