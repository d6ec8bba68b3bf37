"""Vision Transformer (Dosovitskiy et al. 2021), NCHW (PyTorch port of
``distributed_kfac_pytorch_tpu/models/vit.py``): the encoder-attention
workload.

Every weight layer is K-FAC-visible: the patch embedding is an
``nn.Conv2d`` with kernel = stride = ``patch_size`` and no padding (a
``conv2d`` factor whose A covariance runs over non-overlapping patches;
under ``kfac_approx='reduce'`` it is the ``sharing.approx.is_patch_conv``
signature and takes the reduce factors), and each encoder block is the
LM's :class:`~distributed_kfac_pytorch_tpu_torch.models.transformer_lm.
TransformerBlock` with ``causal=False``: four attention Linears and two MLP
Linears under bidirectional attention. ``cls_token`` and ``pos_embed``
are plain parameters (SGD-updated, outside K-FAC's blocks), as the LM's
``pos_embed``.

``attn_block_size`` folds attention over K/V blocks of that many tokens
on one device (``parallel.sequence.chunked_causal_attention``; the cls
token's ragged ``num_patches + 1`` length takes the fold's masked
padding). Names mirror the flax model (``patch_embed``, ``cls_token``,
``pos_embed``, ``block{i}``, ``ln_f``, ``head``), so parameters convert
name for name (``convert.py``). flax fixes ``pos_embed``'s length at
``init`` from the first input; here the constructor's ``image_size`` does.
``dtype`` is the compute dtype, as the JAX model's: the patch embedding,
the Linears and the head compute in it with fp32 parameters, the
LayerNorm statistics and the attention scores stay fp32, and
``cls_token`` and ``pos_embed`` join the stream cast to it
(``modules.precision.set_compute_dtype``).
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch.models.transformer_lm import (
    LN_EPS,
    TransformerBlock,
)
from distributed_kfac_pytorch_tpu_torch.modules.lstm import (
    dense,
    dropout,
    lecun_normal_,
)
from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)

POOLS = ('cls', 'mean')


class VisionTransformer(nn.Module):
    """``forward(x (B, 3, H, W)) -> logits (B, num_classes)``: patch-embed
    conv -> cls token + learned positions -> bidirectional encoder blocks
    -> final LayerNorm -> Linear head on the cls token (``pool='mean'``:
    on the mean over the patches, without a cls token)."""

    def __init__(self, num_classes: int, image_size: int = 224,
                 patch_size: int = 16, d_model: int = 384,
                 num_layers: int = 12, num_heads: int = 6,
                 mlp_ratio: int = 4, dropout: float = 0.0,
                 pool: str = 'cls', attn_block_size: int | None = None,
                 dtype=torch.float32):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        dtype = check_compute_dtype(dtype)
        if image_size % patch_size:
            raise ValueError(f'input {image_size}x{image_size} not '
                             f'divisible by patch_size={patch_size}')
        self.patch_size = patch_size
        self.image_size = image_size
        self.pool = pool
        self.dropout = dropout
        self.num_layers = num_layers
        self.patch_embed = nn.Conv2d(3, d_model, patch_size,
                                     stride=patch_size, padding=0)
        with torch.no_grad():
            lecun_normal_(self.patch_embed.weight,
                          3 * patch_size * patch_size)
            self.patch_embed.bias.zero_()
        tokens = (image_size // patch_size) ** 2 + (pool == 'cls')
        if pool == 'cls':
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.empty(tokens, d_model))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(num_layers):
            setattr(self, f'block{i}', TransformerBlock(
                d_model, num_heads, mlp_ratio, dropout, causal=False,
                attn_block_size=attn_block_size))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = dense(d_model, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, *,
                dropout_generator: torch.Generator | None = None
                ) -> torch.Tensor:
        if x.shape[-2:] != (self.image_size, self.image_size):
            raise ValueError(f'input {tuple(x.shape[-2:])} is not the '
                             f'{self.image_size} px this model was built '
                             'for')
        y = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, N, D)
        if self.pool == 'cls':
            y = torch.cat([self.cls_token.expand(y.shape[0], -1, -1)
                           .to(y.dtype), y], dim=1)
        y = y + self.pos_embed.to(y.dtype)
        y = dropout(y, self.dropout, self.training, dropout_generator)
        for i in range(self.num_layers):
            y = getattr(self, f'block{i}')(y, dropout_generator)
        y = self.ln_f(y)
        y = y[:, 0] if self.pool == 'cls' else y.mean(dim=1)
        return self.head(y)


#: The JAX ``get_model`` sizes: the ViT paper's Ti/S/B ladder at patch 16,
#: and a CIFAR-scale variant (patch 4 on 32 x 32 inputs, 64 patches).
SIZES = {
    'cifar': dict(patch_size=4, d_model=192, num_layers=6, num_heads=3),
    'tiny': dict(patch_size=16, d_model=192, num_layers=12, num_heads=3),
    'small': dict(patch_size=16, d_model=384, num_layers=12, num_heads=6),
    'base': dict(patch_size=16, d_model=768, num_layers=12, num_heads=12),
}


def get_model(num_classes: int, size: str = 'small', image_size: int = 224,
              **overrides) -> VisionTransformer:
    """A named size (:data:`SIZES`) for ``image_size`` px inputs, with
    ``overrides`` of any constructor argument."""
    if size not in SIZES:
        raise ValueError(f'unknown size {size!r}; have {sorted(SIZES)}')
    return VisionTransformer(num_classes=num_classes, image_size=image_size,
                             **{**SIZES[size], **overrides})
