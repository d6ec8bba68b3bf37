"""Kronecker-factor statistics (PyTorch port of
``distributed_kfac_pytorch_tpu/ops/factors.py``).

Same values as the JAX functions, in PyTorch's layouts: conv inputs and
output-grads are NCHW, and the conv A-factor basis is ``(c, kh, kw)`` --
the order of torch's ``(Cout, Cin, KH, KW)`` weight flattened to
``(Cout, Cin*KH*KW)`` -- where the JAX package uses ``(kh, kw, c)``.

Precision: ``compute_dtype=None`` and ``torch.float32`` are fp32
multiplicands with fp32 accumulation (the port's entry points turn TF32
off); ``torch.bfloat16`` rounds the multiplicands to bf16 and still
accumulates and returns fp32. Half-precision captures (bf16 from
``capture_dtype``, fp16 or bf16 from a model's compute ``dtype``) are
widened first, exactly, so every statistic, the KFAC-reduce sums over the
shared axes, multi-call layers, an embedding's A, a tied embedding's
extras and grouped convs included, accumulates in fp32, as the JAX
functions' ``preferred_element_type`` does.
"""

from __future__ import annotations

import torch

from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.ops.kernels import (  # noqa: F401
    _assemble_bias_factor,
    _canonical_pad,
    mult_bf16,
)


def get_cov(a: torch.Tensor, b: torch.Tensor | None = None,
            scale: float | None = None,
            compute_dtype=None) -> torch.Tensor:
    """Empirical second moment ``a^T b / scale`` of 2-D tensors.

    With ``b`` None the result is symmetrized, ``(C + C^T) / 2``. The
    scale is applied to the small output, never to the batch-sized input.
    """
    if a.ndim != 2:
        raise ValueError(f'get_cov expects a 2-D tensor, got shape '
                         f'{tuple(a.shape)}')
    if b is not None and a.shape != b.shape:
        raise ValueError(f'shape mismatch: {tuple(a.shape)} vs '
                         f'{tuple(b.shape)}')
    if scale is None:
        scale = a.shape[0]
    bf16 = mult_bf16(compute_dtype)
    a = kernels._round(a, bf16)
    if b is None:
        cov = a.T @ a
        return (cov + cov.T) * (0.5 / scale)
    return (a.T @ kernels._round(b, bf16)) * (1.0 / scale)


def update_running_avg(new: torch.Tensor, current: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """EWMA ``alpha * current + (1 - alpha) * new`` (returns a new tensor),
    rounded as K1's fused blend (:func:`kernels.ema_blend`), in
    ``current``'s dtype: a bf16 factor is blended in fp32 and rounded
    once."""
    return kernels.ema_blend(current, new, alpha)


def collapse_batch_dims(x: torch.Tensor) -> torch.Tensor:
    """Collapse all but the last dim: (..., d) -> (prod(...), d)."""
    return x.reshape(-1, x.shape[-1])


def _column_mean(x: torch.Tensor) -> torch.Tensor:
    """Column mean of a 2-D tensor, accumulated in fp32."""
    return x.float().sum(0) / x.shape[0]


def linear_a_factor(a: torch.Tensor, has_bias: bool,
                    compute_dtype=None) -> torch.Tensor:
    """A = cov(inputs (+ ones column)) for a dense layer; leading dims of
    ``a`` are collapsed into rows."""
    a = collapse_batch_dims(a)
    cov = get_cov(a, compute_dtype=compute_dtype)
    if not has_bias:
        return cov
    return _assemble_bias_factor(cov, _column_mean(a), 1.0)


def linear_g_factor(g: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """G = cov(grad wrt layer outputs) for a dense layer."""
    return get_cov(collapse_batch_dims(g), compute_dtype=compute_dtype)


def _reduce_shared_axes(x: torch.Tensor, mean: bool) -> torch.Tensor:
    """``(B, *, d)`` reduced over the middle (shared) axes to fp32 ``(B,
    d)`` rows: their mean with ``mean``, else their sum. A 2-D ``x`` is
    returned as fp32 rows."""
    if x.ndim <= 2:
        return x.float()
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    out = x3.sum(1)
    return out / x3.shape[1] if mean else out


def linear_a_factor_reduced(a: torch.Tensor, has_bias: bool,
                            compute_dtype=None) -> torch.Tensor:
    """KFAC-reduce A of a weight-shared dense layer: ``a`` is ``(B, T...,
    d)``, MEAN-reduced over the shared axes before the covariance, which
    then runs over the ``B`` rows (the bias column stays exactly 1)."""
    return linear_a_factor(_reduce_shared_axes(a, mean=True), has_bias,
                           compute_dtype=compute_dtype)


def linear_g_factor_reduced(g: torch.Tensor,
                            compute_dtype=None) -> torch.Tensor:
    """KFAC-reduce G of a weight-shared dense layer: output-grads SUMMED
    over the shared axes, then their covariance over the ``B`` rows."""
    return linear_g_factor(_reduce_shared_axes(g, mean=False),
                           compute_dtype=compute_dtype)


def conv2d_a_factor(a: torch.Tensor, kernel_size, strides, padding,
                    has_bias: bool, compute_dtype=None) -> torch.Tensor:
    """A factor for conv2d from an NCHW input: the covariance of the
    im2col patch rows over ``B*OH*OW`` rows, scaled by ``1/spatial^2``
    (reference ``a / spatial_size`` before the covariance), with the bias
    row/column and corner ``1/spatial^2`` when ``has_bias``.

    Always the patch-covariance kernel's wrapper (:func:`kernels.
    patch_cov`): its CUDA kernel for tensors on the card, its plain
    version for CPU tensors. The JAX package's ``KFAC_CONV_PATCH_IMPL``
    variants are XLA lowering strategies for this one value and are not
    ported.
    """
    return kernels.patch_cov(a, kernel_size, strides, padding, has_bias,
                             compute_dtype=compute_dtype)


def conv2d_g_factor(g: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """G factor for conv2d from NCHW output grads: the channel covariance
    over ``B*H*W`` rows, divided by ``rows * spatial^2``."""
    b, c, h, w = g.shape
    spatial = h * w
    g2 = g.permute(0, 2, 3, 1).reshape(-1, c)
    return get_cov(g2, scale=g2.shape[0] * spatial * spatial,
                   compute_dtype=compute_dtype)


def conv2d_a_factor_reduced(a: torch.Tensor, kernel_size, strides,
                            padding, has_bias: bool,
                            compute_dtype=None) -> torch.Tensor:
    """KFAC-reduce A of a patch-embedding conv (NCHW input): the patch
    rows MEAN-reduced over the ``(OH, OW)`` grid, then the plain
    covariance over the ``B`` reduced rows (not the expand path's
    ``1/spatial^2`` convention), in the ``(c, kh, kw)`` basis."""
    patches = kernels.extract_conv2d_patches(a, kernel_size, strides,
                                             padding)
    rows = patches.reshape(a.shape[0], -1, patches.shape[-1])
    return linear_a_factor(_reduce_shared_axes(rows, mean=True), has_bias,
                           compute_dtype=compute_dtype)


def conv2d_g_factor_reduced(g: torch.Tensor,
                            compute_dtype=None) -> torch.Tensor:
    """KFAC-reduce G of a patch-embedding conv: NCHW output-grads summed
    over the ``(H, W)`` grid, covariance over the ``B`` rows."""
    b, c = g.shape[:2]
    return linear_g_factor(g.float().reshape(b, c, -1).sum(-1),
                           compute_dtype=compute_dtype)


#: Rows per partial product of the grouped factors' sums: each partial
#: sums at most this many rows, and the partials are added afterwards, so
#: a layer with ~500k rows (MobileNet's first depthwise conv at 176 px)
#: keeps the fp32 error of a short sum.
GROUPED_ROW_CHUNK = 4096


def _grouped_gram(x: torch.Tensor) -> torch.Tensor:
    """``sum_r x[r, g, :]^T x[r, g, :]`` of ``(rows, G, d)`` fp32 rows:
    ``(G, d, d)``, summed over chunks of :data:`GROUPED_ROW_CHUNK` rows
    (one batched product per chunk and group, then the sum of the
    partials)."""
    rows, groups, d = x.shape
    pad = -rows % GROUPED_ROW_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros((pad, groups, d))])
    x = x.reshape(-1, GROUPED_ROW_CHUNK, groups, d).permute(2, 0, 1, 3)
    return (x.mT @ x).sum(1)


def conv2d_grouped_a_factor(a: torch.Tensor, kernel_size, strides, padding,
                            groups: int, has_bias: bool,
                            compute_dtype=None) -> torch.Tensor:
    """Per-group A factors of a grouped / depthwise conv from an NCHW
    input: ``(G, da, da)``, ``da = (cin/G)*kh*kw [+1]``.

    Group ``g``'s outputs see only its ``cin/G`` input channels, so the
    layer's Fisher block is block-diagonal over groups and each block
    factorizes on its own: ``A_g`` is the patch covariance of group
    ``g``'s channels over ``B*OH*OW`` rows, scaled by ``1/spatial^2`` as
    in :func:`conv2d_a_factor`, with the bias row / column and corner
    ``1/spatial^2`` when ``has_bias``. The per-group basis is ``(cpg, kh,
    kw)`` (the JAX package's is ``(kh, kw, cpg)``). Stock torch (im2col
    and batched products in fp32 over row chunks, :func:`_grouped_gram`),
    as the JAX function is a plain einsum outside any Pallas kernel.
    """
    c = a.shape[1]
    if c % groups:
        raise ValueError(f'{c=} channels not divisible by {groups=}')
    patches = kernels.extract_conv2d_patches(a.float(), kernel_size,
                                             strides, padding)
    _, oh, ow = kernels.conv_out_geometry(a.shape, kernel_size, strides,
                                          padding)
    spatial = oh * ow
    rows = patches.shape[0]
    # (rows, G * cpg*kh*kw): each group's features are contiguous.
    p = kernels._round(patches.reshape(rows, groups, -1),
                       mult_bf16(compute_dtype))
    cov = _grouped_gram(p)
    cov = (cov + cov.mT) * (0.5 / (rows * spatial * spatial))
    if not has_bias:
        return cov
    bias_cols = p.sum(0) / (rows * spatial * spatial)
    d = cov.shape[-1]
    out = cov.new_zeros((groups, d + 1, d + 1))
    out[:, :d, :d] = cov
    out[:, d, :d] = bias_cols
    out[:, :d, d] = bias_cols
    out[:, d, d] = 1.0 / (spatial * spatial)
    return out


def conv2d_grouped_g_factor(g: torch.Tensor, groups: int,
                            compute_dtype=None) -> torch.Tensor:
    """Per-group G factors of a grouped conv from NCHW output-grads:
    ``(G, dg, dg)``, the covariance of each contiguous ``cout/G`` channel
    block over ``B*H*W`` rows, divided by ``rows * spatial^2`` as in
    :func:`conv2d_g_factor`."""
    b, cout, h, w = g.shape
    if cout % groups:
        raise ValueError(f'{cout=} outputs not divisible by {groups=}')
    spatial = h * w
    g2 = g.float().permute(0, 2, 3, 1).reshape(-1, groups, cout // groups)
    g2 = kernels._round(g2, mult_bf16(compute_dtype))
    rows = g2.shape[0]
    cov = _grouped_gram(g2)
    return (cov + cov.mT) * (0.5 / (rows * spatial * spatial))


def embedding_a_factor(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Diagonal A of an embedding layer, as a ``(vocab_size,)`` vector:
    the frequency of each id among the looked-up ids (the diagonal of
    ``E[onehot onehot^T]``). Ids outside the vocabulary count nowhere."""
    ids = ids.reshape(-1)
    counts = torch.bincount(ids, minlength=vocab_size)[:vocab_size]
    return counts.float() / ids.shape[0]


def embedding_tied_a_diag(g: torch.Tensor) -> torch.Tensor:
    """Vocab-side diagonal of a tied attend site: ``E[g_v^2]`` of the
    output-grads of the logits ``x E^T`` per vocabulary entry (the
    diagonal of their covariance), which keeps the tied embedding's A
    diagonal."""
    g2 = collapse_batch_dims(g).float()
    return (g2 * g2).sum(0) / g2.shape[0]


def pack_symmetric(m: torch.Tensor) -> torch.Tensor:
    """Pack a symmetric (n, n) matrix into ``(n_pad/2 + 1, n_pad)``.

    The JAX package's layout (``n_pad`` = n rounded up to even, ``k =
    n_pad/2``): the top ``k`` rows of ``triu(m)`` with their strictly-lower
    slots filled by the transposed strict-lower part of the bottom-right
    ``k x k`` triangle, plus one row holding that triangle's diagonal.
    """
    n = m.shape[-1]
    n_pad = n + (n % 2)
    if n_pad != n:
        m = torch.nn.functional.pad(m, (0, 1, 0, 1))
    k = n_pad // 2
    u = torch.triu(m)
    top = u[:k, :].clone()
    low = u[k:, k:]
    top[:, :k] += torch.tril(low.T, -1)
    extra = m.new_zeros((1, n_pad))
    extra[0, :k] = torch.diagonal(low)
    return torch.cat([top, extra], dim=0)


def unpack_symmetric(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_symmetric`."""
    n_pad = packed.shape[-1]
    k = n_pad // 2
    top = packed[:k]
    u = packed.new_zeros((n_pad, n_pad))
    u[:k, :k] = torch.triu(top[:, :k])
    u[:k, k:] = top[:, k:]
    u[k:, k:] = torch.tril(top[:, :k], -1).T + torch.diag(packed[k, :k])
    full = u + u.T - torch.diag(torch.diagonal(u))
    return full[:n, :n]


def get_triu(x: torch.Tensor) -> torch.Tensor:
    """The upper triangle of a 2-D ``(n, m)`` tensor, ``n <= m``, flattened
    row by row: the reference's ``n(n+1)/2``-element wire format for a
    symmetric factor (the packed factor average uses
    :func:`pack_symmetric`)."""
    if x.ndim != 2:
        raise ValueError('get_triu expects a 2-D tensor')
    n, m = x.shape
    if n > m:
        raise ValueError('tensor cannot have more rows than columns')
    rows, cols = torch.triu_indices(n, m, device=x.device)
    return x[rows, cols]


def fill_triu(shape, triu: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`get_triu`: the ``(n, m)`` tensor whose upper
    triangle is ``triu`` and whose strictly-lower triangle mirrors it."""
    if len(shape) != 2:
        raise ValueError('shape must be 2 dimensional')
    n, m = shape
    if n > m:
        raise ValueError('shape cannot have more rows than columns')
    rows, cols = torch.triu_indices(n, m, device=triu.device)
    out = triu.new_zeros((n, m))
    out[rows, cols] = triu
    sq = out[:, :n]
    strict = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                   device=triu.device), -1)
    sym_sq = torch.where(strict, sq.T, sq)
    return torch.cat([sym_sq, out[:, n:]], dim=1)
