"""Decoder-only Transformer language model (PyTorch port of
``distributed_kfac_pytorch_tpu/models/transformer_lm.py``).

Pre-LN blocks of multi-head causal self-attention built from four plain
``nn.Linear`` projections (``q_proj``, ``k_proj``, ``v_proj``,
``out_proj``, each one K-FAC layer) and a GELU MLP (``mlp_in``,
``mlp_out``), learned position embeddings, a final LayerNorm and either
the tied decoder (``embed.attend``: logits ``x E^T``, no bias) or a
``decoder`` Linear. Module and parameter names match the flax model
(``embed``, ``pos_embed``, ``block{i}.attn.{q,k,v,out}_proj``, ``ln1``,
``ln2``, ``mlp_in``, ``mlp_out``, ``ln_f``, ``decoder``).

flax's conventions are kept: LayerNorm epsilon 1e-6, the tanh GELU,
lecun-normal Linear weights with zero biases, flax's ``Embed`` init,
``pos_embed`` from N(0, 0.02), dropout after the embeddings, after the
attention projection and after the MLP, its masks drawn from
``dropout_generator``.

Long contexts, as in the JAX model: ``attn_block_size`` folds attention
over K/V blocks of that many tokens on one device
(``parallel.sequence.chunked_causal_attention``); ``seq_group`` (a
``torch.distributed`` sequence group) shards the sequence over its ranks
and runs attention as a ring (``ring_self_attention``): each rank passes
its contiguous block of ids and its first position as ``pos_offset``. The
two are exclusive. :func:`whole_sequences` runs a ring model over whole
sequences on each rank (the JAX CLI's evaluation twin). ``dtype`` is the
compute dtype, as the JAX model's (``torch.float16`` under the CLI's
``--fp16``): the embedding, the Linears and the tied attend compute in it
with fp32 parameters, while the LayerNorm statistics and the attention
scores and softmax stay fp32 (``modules.precision.set_compute_dtype``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch.modules.embed import Embed
from distributed_kfac_pytorch_tpu_torch.modules.lstm import dense, dropout
from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)
from distributed_kfac_pytorch_tpu_torch.parallel.sequence import (
    chunked_causal_attention,
    local_causal_attention,
    ring_self_attention,
)

LN_EPS = 1e-6


class CausalSelfAttention(nn.Module):
    """Multi-head (causal) self-attention from four K-FAC-visible
    Linears: over the whole sequence, folded over K/V blocks of
    ``attn_block_size`` tokens, or as a ring over ``seq_group``."""

    def __init__(self, d_model: int, num_heads: int, causal: bool = True,
                 attn_block_size: int | None = None, seq_group=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f'{d_model=} not divisible by {num_heads=}')
        if seq_group is not None and attn_block_size is not None:
            raise ValueError(
                'seq_axis and attn_block_size are mutually exclusive: '
                'the ring already folds blockwise per device (set '
                'attn_block_size=None under sequence parallelism)')
        self.num_heads = num_heads
        self.causal = causal
        self.attn_block_size = attn_block_size
        self.seq_group = seq_group
        self.q_proj = dense(d_model, d_model)
        self.k_proj = dense(d_model, d_model)
        self.v_proj = dense(d_model, d_model)
        self.out_proj = dense(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d_model = x.shape[-1]

        def heads(y):
            return y.reshape(*y.shape[:-1], self.num_heads,
                             d_model // self.num_heads)

        q, k, v = (heads(proj(x))
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        if self.seq_group is not None:
            o = ring_self_attention(q, k, v, group=self.seq_group,
                                    causal=self.causal)
        elif self.attn_block_size is not None:
            o = chunked_causal_attention(q, k, v,
                                         block_size=self.attn_block_size,
                                         causal=self.causal)
        else:
            o = local_causal_attention(q, k, v, causal=self.causal)
        return self.out_proj(o.reshape(x.shape).to(x.dtype))


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> attention -> dropout -> residual, LN -> GELU
    MLP -> dropout -> residual."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, causal: bool = True,
                 attn_block_size: int | None = None, seq_group=None):
        super().__init__()
        self.dropout = dropout
        self.attn = CausalSelfAttention(d_model, num_heads, causal,
                                        attn_block_size, seq_group)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_in = dense(d_model, mlp_ratio * d_model)
        self.mlp_out = dense(mlp_ratio * d_model, d_model)

    def forward(self, x, generator=None):
        h = self.attn(self.ln1(x))
        x = x + dropout(h, self.dropout, self.training, generator)
        y = self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)),
                                approximate='tanh'))
        return x + dropout(y, self.dropout, self.training, generator)


class TransformerLM(nn.Module):
    """``forward(ids (B, T) int) -> logits (B, T, vocab)``: embed +
    learned positions -> blocks -> LN -> tied attend or decoder.

    ``pos_offset`` is the position of ``ids``' first token: under
    ``seq_group``, the rank's block start (its group index times the local
    length). ``dropout_generator`` (a ``torch.Generator`` on the model's
    device) draws every dropout mask of a training-mode call.
    """

    def __init__(self, vocab_size: int, d_model: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 max_len: int = 2048, dropout: float = 0.1,
                 tie_weights: bool = True, mlp_ratio: int = 4,
                 attn_block_size: int | None = None, seq_group=None,
                 dtype=torch.float32):
        super().__init__()
        dtype = check_compute_dtype(dtype)
        self.dropout = dropout
        self.tie_weights = tie_weights
        self.num_layers = num_layers
        self.embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(num_layers):
            setattr(self, f'block{i}', TransformerBlock(
                d_model, num_heads, mlp_ratio, dropout,
                attn_block_size=attn_block_size, seq_group=seq_group))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        if not tie_weights:
            self.decoder = dense(d_model, vocab_size)
        set_compute_dtype(self, dtype)

    def forward(self, ids: torch.Tensor, *, pos_offset: int = 0,
                dropout_generator: torch.Generator | None = None
                ) -> torch.Tensor:
        pos = self.pos_embed[pos_offset:pos_offset + ids.shape[-1]]
        x = self.embed(ids)
        x = x + pos.to(x.dtype)
        x = dropout(x, self.dropout, self.training, dropout_generator)
        for i in range(self.num_layers):
            x = getattr(self, f'block{i}')(x, dropout_generator)
        x = self.ln_f(x)
        if self.tie_weights:
            return self.embed.attend(x)
        return self.decoder(x)


@contextlib.contextmanager
def whole_sequences(model: nn.Module):
    """Inside, every attention of ``model`` runs over its input's whole
    sequence on this rank (no ring): the JAX CLI evaluates with a twin
    built with ``seq_axis=None`` and the same parameters. A model without
    a sequence group is unchanged."""
    ring = [m for m in model.modules()
            if isinstance(m, CausalSelfAttention) and m.seq_group is not None]
    groups = [m.seq_group for m in ring]
    for m in ring:
        m.seq_group = None
    try:
        yield model
    finally:
        for m, group in zip(ring, groups):
            m.seq_group = group


#: The JAX ``get_model`` sizes: (d_model, num_layers, num_heads).
SIZES = {
    'tiny': dict(d_model=128, num_layers=2, num_heads=4),
    'small': dict(d_model=512, num_layers=6, num_heads=8),
    'base': dict(d_model=768, num_layers=12, num_heads=12),
    # Transformer-XL large: d 1024, 18 layers, MLP 4096.
    'xl': dict(d_model=1024, num_layers=18, num_heads=16),
    'xxl': dict(d_model=2048, num_layers=24, num_heads=16),
}


def get_model(vocab_size: int, size: str = 'small',
              **overrides) -> TransformerLM:
    """A named size (``SIZES``) with ``overrides`` of any constructor
    argument (``attn_block_size`` and ``seq_group`` among them)."""
    if size not in SIZES:
        raise ValueError(f'unknown size {size!r}; have {sorted(SIZES)}')
    return TransformerLM(vocab_size=vocab_size,
                         **{**SIZES[size], **overrides})
