"""Single-device causal attention (PyTorch port of
``distributed_kfac_pytorch_tpu/parallel/sequence.py``:
``local_causal_attention`` only).

The same contract as the JAX function: ``1/sqrt(head_dim)`` scale, masked
logits set to ``-1e30`` (a finite sentinel, not ``-inf``), softmax
statistics in fp32, the normalizer clamped at ``1e-30``, and an fp32
result. Plain torch ops: attention is not a Pallas kernel in the JAX
package. Ring attention over a sequence-parallel group and the chunked
single-device fold are not ported yet.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, qpos: torch.Tensor, kpos: torch.Tensor,
                  causal: bool):
    """One block's ``(max, exp-scores @ v, exp-scores sum)``: ``q`` is
    ``(B, Tq, H, D)``, ``k``/``v`` ``(B, Tk, H, D)``, ``qpos``/``kpos``
    the tokens' positions; the statistics are ``(B, H, Tq)`` fp32."""
    logits = torch.einsum('bqhd,bkhd->bhqk', q, k).float() * scale
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        # A fully masked row has m == -1e30 and p == 1 everywhere.
        p = torch.where((m == _NEG_INF)[..., None], 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return m, o, l


def local_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True
                           ) -> torch.Tensor:
    """Attention of ``(B, T, H, D)`` queries, keys and values over one
    device's whole sequence; returns ``(B, T, H, D)`` fp32."""
    t, d = q.shape[1], q.shape[-1]
    pos = torch.arange(t, device=q.device)
    _, o, l = _block_attend(q, k, v, 1.0 / (d ** 0.5), pos, pos, causal)
    return o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
