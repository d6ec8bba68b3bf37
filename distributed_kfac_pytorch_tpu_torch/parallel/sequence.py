"""Sequence parallelism and blockwise attention (PyTorch port of
``distributed_kfac_pytorch_tpu/parallel/sequence.py``).

``local_causal_attention`` attends over one device's whole sequence;
``chunked_causal_attention`` folds K/V blocks of one device through the
online-softmax update, recomputing each block's logits in the backward
pass; ``ring_self_attention`` shards the sequence over a
``torch.distributed`` sequence group and circulates the K/V blocks around
it. All three keep the JAX contract: ``1/sqrt(head_dim)`` scale, masked
logits set to ``-1e30`` (a finite sentinel, not ``-inf``), fully masked
rows zeroed, the scores, softmax statistics and the result in fp32 at any
input dtype, the normalizer clamped at ``1e-30``. Plain torch ops: attention is not a Pallas kernel in
the JAX package.

The ring's K/V shift is an autograd function whose backward is the
reverse shift (the transpose of ``ppermute`` that JAX's autodiff takes),
so ``backward()`` on every rank gives ``jax.grad``'s gradients through the
ring. Its transport follows the group's backend: NCCL exchanges the CUDA
tensors, gloo (which has no send/recv on CUDA tensors) goes through host
memory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, qpos: torch.Tensor, kpos: torch.Tensor,
                  causal: bool, kvalid: torch.Tensor | None = None):
    """One block's ``(max, exp-scores @ v, exp-scores sum)``: ``q`` is
    ``(B, Tq, H, D)``, ``k``/``v`` ``(B, Tk, H, D)``, ``qpos``/``kpos``
    the tokens' positions, ``kvalid`` (optional, ``(Tk,)`` bool) masks
    padding keys; the statistics are ``(B, H, Tq)`` fp32. ``q`` and ``k``
    enter the product widened to fp32 (exact for fp16 and bf16), so each
    logit is an fp32 sum of exact products, as JAX's fp32
    ``preferred_element_type`` gives: a half-precision product would round
    the scores, and overflow fp16's range."""
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if kvalid is not None:
        mask = kvalid[None, :] if mask is None else mask & kvalid[None, :]
    if mask is not None:
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        # A fully masked row has m == -1e30 and p == 1 everywhere.
        p = torch.where((m == _NEG_INF)[..., None], 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return m, o, l


def _fold_update(o, m, l, bm, bo, bl):
    """Fold one block's ``(max, out, sum)`` into the running online-softmax
    accumulators. Fully masked blocks carry ``m == -1e30`` (finite), so
    the corrections stay finite."""
    new_m = torch.maximum(m, bm)
    corr_old = torch.exp(m - new_m)
    corr_new = torch.exp(bm - new_m)
    l = l * corr_old + bl * corr_new
    o = (o * corr_old.transpose(1, 2)[..., None]
         + bo * corr_new.transpose(1, 2)[..., None])
    return o, new_m, l


def _accumulators(q: torch.Tensor):
    """Empty ``(o, m, l)`` for queries ``q``."""
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device))


def _normalize(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)


def local_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True
                           ) -> torch.Tensor:
    """Attention of ``(B, T, H, D)`` queries, keys and values over one
    device's whole sequence; returns ``(B, T, H, D)`` fp32."""
    t, d = q.shape[1], q.shape[-1]
    pos = torch.arange(t, device=q.device)
    _, o, l = _block_attend(q, k, v, 1.0 / (d ** 0.5), pos, pos, causal)
    return _normalize(o, l)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, block_size: int,
                             causal: bool = True) -> torch.Tensor:
    """Attention over one device's whole sequence with at most one
    ``(T, block_size)`` slab of logits live: K/V blocks fold through the
    ring's online-softmax update, each fold under
    ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX package), so
    the backward pass recomputes a block's logits instead of keeping them.
    Exact: the same dot products, fp32 statistics.

    ``T <= block_size`` is ``local_causal_attention``. Otherwise K/V are
    padded with zeros up to a block multiple (queries stay length ``T``)
    and the padded last block is folded once more with its padding keys
    masked. Returns ``(B, T, H, D)`` fp32.
    """
    b, t, h, d = q.shape
    if t <= block_size:
        return local_causal_attention(q, k, v, causal=causal)
    pad = -t % block_size
    if pad:
        k, v = (torch.cat([a, a.new_zeros((b, pad, h, d))], dim=1)
                for a in (k, v))
    scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(t, device=q.device)
    kpos = torch.arange(t + pad, device=q.device).reshape(-1, block_size)

    def fold(o, m, l, k_blk, v_blk, kp, kvalid):
        bm, bo, bl = _block_attend(q, k_blk, v_blk, scale, qpos, kp, causal,
                                   kvalid=kvalid)
        return _fold_update(o, m, l, bm, bo, bl)

    o, m, l = _accumulators(q)
    for i in range(kpos.shape[0]):
        blk = slice(i * block_size, (i + 1) * block_size)
        # Only the padded last block needs its padding keys masked.
        kvalid = kpos[i] < t if pad and i == kpos.shape[0] - 1 else None
        o, m, l = checkpoint(fold, o, m, l, k[:, blk], v[:, blk], kpos[i],
                             kvalid, use_reentrant=False)
    return _normalize(o, l)


# ---------------------------------------------------------------------------
# The ring over a sequence group
# ---------------------------------------------------------------------------

def make_sequence_group(seq_parallel: int):
    """Create the world's sequence groups and return this rank's (None
    for ``seq_parallel == 1``). World rank ``r`` is sequence index ``r %
    seq_parallel`` of K-FAC rank ``r // seq_parallel``: the
    ``seq_parallel`` ranks of one group are contiguous, as the JAX mesh's
    innermost sequence axis. ``dist.new_group`` is collective: every rank
    creates every group, in the same order."""
    if seq_parallel == 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % seq_parallel:
        raise ValueError(f'{seq_parallel=} does not divide the world of '
                         f'{world} processes')
    rank = dist.get_rank()
    mine = None
    for first in range(0, world, seq_parallel):
        group = dist.new_group(list(range(first, first + seq_parallel)))
        if first <= rank < first + seq_parallel:
            mine = group
    return mine


def _exchange(t: torch.Tensor, group, send_to: int, recv_from: int
              ) -> torch.Tensor:
    """Send ``t`` to global rank ``send_to`` and return the like tensor
    received from ``recv_from``, in one ``batch_isend_irecv``. The
    transport is the group's backend's: NCCL moves ``t`` where it lies;
    any other backend (gloo) moves a host copy."""
    wire = t.detach().contiguous()
    if dist.get_backend(group) != dist.Backend.NCCL:
        wire = wire.cpu()
    got = torch.empty_like(wire)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, send_to, group),
            dist.P2POp(dist.irecv, got, recv_from, group)]):
        req.wait()
    return got.to(t.device)


class _RingShift(torch.autograd.Function):
    """Forward: this rank's tensor goes to the next rank of the ring and
    the previous rank's arrives. Backward: the reverse shift of the
    incoming gradient (the transpose of the forward permutation)."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(x, group, send_to=nxt, recv_from=prv)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.group, send_to=ctx.prv,
                          recv_from=ctx.nxt), None, None, None)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group, causal: bool = True) -> torch.Tensor:
    """Exact attention over the sequence sharded on ``group`` (a
    ``torch.distributed`` process group). ``q``/``k``/``v`` are this
    rank's contiguous block, ``(B, T_local, H, D)``: the rank of group
    index ``i`` holds tokens ``[i * T_local, (i + 1) * T_local)``. K and V
    go round the ring as one message per shift (to group index ``i + 1``,
    from ``i - 1``): ``s - 1`` shifts and ``s`` folds, the last fold
    peeled out so no shift is thrown away. Every rank of the group must
    call it (and, in training, run ``backward``). Returns ``(B, T_local,
    H, D)`` fp32."""
    s = dist.get_world_size(group)
    idx = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(idx + 1) % s], ranks[(idx - 1) % s]
    t, d = q.shape[1], q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    local_pos = torch.arange(t, device=q.device)
    qpos = idx * t + local_pos
    o, m, l = _accumulators(q)
    kv = torch.stack([k, v])
    for step in range(s):
        if step:
            kv = _RingShift.apply(kv, group, nxt, prv)
        # After `step` shifts this rank holds the block of index idx - step.
        kpos = ((idx - step) % s) * t + local_pos
        bm, bo, bl = _block_attend(q, kv[0], kv[1], scale, qpos, kpos,
                                   causal)
        o, m, l = _fold_update(o, m, l, bm, bo, bl)
    return _normalize(o, l)
