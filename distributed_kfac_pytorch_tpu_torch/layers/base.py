"""Layer-kind dispatch (PyTorch port of
``distributed_kfac_pytorch_tpu/layers/base.py``).

Pure functions over a :class:`~distributed_kfac_pytorch_tpu_torch.capture.
LayerSpec` and that layer's captures or parameter gradients:

  - ``compute_a_factor`` / ``compute_g_factor``: per-call factors, summed
    over calls, dispatched on the kind and on ``spec.kfac_approx``
    (expand, or reduce over the shared axis);
  - ``compute_tied_factor_extras``: a tied embedding's attend-site terms;
  - ``grads_to_matrix`` / ``matrix_to_grads``: a layer's ``{'weight',
    'bias'}`` gradients to and from the 2-D ``(out_dim, in_dim[+1])``
    matrix the preconditioner works in. torch layouts: Linear weight
    ``(out, in)``; Conv2d weight ``(cout, cin, kh, kw)`` flattened to
    ``(cout, cin*kh*kw)``, so the A basis is ``(c, kh, kw)``; a grouped
    conv's ``(cout, cin/G, kh, kw)`` weight as a ``(G, cout/G,
    (cin/G)*kh*kw [+1])`` stack, one block per group (its factors are
    ``(G, d, d)`` stacks); an embedding's ``(vocab, dim)`` table as it is
    (A is a diagonal over the vocabulary, G is ``(dim, dim)``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_kfac_pytorch_tpu_torch.capture import CONV2D, \
    CONV2D_GROUPED, EMBEDDING, KFAC_REDUCE, LINEAR, LayerSpec
from distributed_kfac_pytorch_tpu_torch.ops import factors as F

KNOWN_KINDS = (LINEAR, CONV2D, CONV2D_GROUPED, EMBEDDING)

#: Capture-entry keys QUADRATIC in the output-gradients: under data
#: parallelism with a local-mean loss they take the ``1/world^2`` rescale
#: the primary 'G' gets; 'A' and 'G_a' are activation-derived.
GRAD_QUADRATIC_KEYS = ('G', 'A_g2')


def _sum_calls(fn, calls: Sequence[torch.Tensor], name: str):
    if not calls:
        raise ValueError(f'layer {name}: no captures to compute factors '
                         'from')
    out = None
    for x in calls:
        cur = fn(x)
        out = cur if out is None else out + cur
    return out


def compute_a_factor(spec: LayerSpec, a_calls: Sequence[torch.Tensor],
                     compute_dtype=None) -> torch.Tensor:
    """Input-covariance factor A from per-call activations (an embedding:
    the diagonal, as a vector, from its ids)."""
    reduced = spec.kfac_approx == KFAC_REDUCE
    if spec.kind == LINEAR:
        fn = F.linear_a_factor_reduced if reduced else F.linear_a_factor
        return _sum_calls(lambda a: fn(
            a, spec.has_bias, compute_dtype=compute_dtype), a_calls,
            spec.name)
    if spec.kind == CONV2D:
        fn = F.conv2d_a_factor_reduced if reduced else F.conv2d_a_factor
        return _sum_calls(lambda a: fn(
            a, spec.kernel_size, spec.strides, spec.padding, spec.has_bias,
            compute_dtype=compute_dtype), a_calls, spec.name)
    if spec.kind == CONV2D_GROUPED:
        return _sum_calls(lambda a: F.conv2d_grouped_a_factor(
            a, spec.kernel_size, spec.strides, spec.padding,
            spec.feature_group_count, spec.has_bias,
            compute_dtype=compute_dtype), a_calls, spec.name)
    if spec.kind == EMBEDDING:
        return _sum_calls(lambda ids: F.embedding_a_factor(
            ids, spec.vocab_size), a_calls, spec.name)
    raise ValueError(f'unknown layer kind {spec.kind!r}')


def compute_g_factor(spec: LayerSpec, g_calls: Sequence[torch.Tensor],
                     compute_dtype=None) -> torch.Tensor:
    """Output-gradient covariance factor G from per-call output grads."""
    reduced = spec.kfac_approx == KFAC_REDUCE
    if spec.kind in (LINEAR, EMBEDDING):
        fn = (F.linear_g_factor_reduced if reduced and spec.kind == LINEAR
              else F.linear_g_factor)
        return _sum_calls(lambda g: fn(
            g, compute_dtype=compute_dtype), g_calls, spec.name)
    if spec.kind == CONV2D:
        fn = F.conv2d_g_factor_reduced if reduced else F.conv2d_g_factor
        return _sum_calls(lambda g: fn(
            g, compute_dtype=compute_dtype), g_calls, spec.name)
    if spec.kind == CONV2D_GROUPED:
        return _sum_calls(lambda g: F.conv2d_grouped_g_factor(
            g, spec.feature_group_count, compute_dtype=compute_dtype),
            g_calls, spec.name)
    raise ValueError(f'unknown layer kind {spec.kind!r}')


def compute_tied_factor_extras(spec: LayerSpec, entry: dict,
                               compute_dtype=None) -> dict | None:
    """A tied embedding's attend-site contributions to its one factor
    pair, or None for a layer without ``a_tied`` / ``g_tied`` captures:

      - ``A_g2``: ``diag cov(dL/dlogits)`` over the vocabulary, added to
        the lookup's frequency diagonal (quadratic in the output grads);
      - ``G_a``: ``cov(attend inputs)``, added to the lookup's
        output-grad covariance (activation-derived).
    """
    if spec.kind != EMBEDDING or not entry.get('g_tied'):
        return None
    a_diag = _sum_calls(F.embedding_tied_a_diag, entry['g_tied'], spec.name)
    g_cov = _sum_calls(lambda x: F.get_cov(
        F.collapse_batch_dims(x), compute_dtype=compute_dtype),
        entry['a_tied'], spec.name)
    return {'A_g2': a_diag, 'G_a': g_cov}


def grads_to_matrix(spec: LayerSpec, grads: dict) -> torch.Tensor:
    """``{'weight', 'bias'}`` gradients -> ``(out_dim, in_dim[+1])`` (an
    embedding: its ``(vocab, dim)`` table gradient)."""
    if spec.kind not in KNOWN_KINDS:
        raise ValueError(f'unknown layer kind {spec.kind!r}')
    w = grads['weight']
    if spec.kind == EMBEDDING:
        return w
    if spec.kind == CONV2D_GROUPED:
        # Output channels are contiguous per group: (G, cout/G, d).
        groups = spec.feature_group_count
        mat = w.reshape(groups, w.shape[0] // groups, -1)
        if spec.has_bias:
            mat = torch.cat([mat, grads['bias'].reshape(groups, -1, 1)],
                            dim=-1)
        return mat
    mat = w.reshape(w.shape[0], -1)
    if spec.has_bias:
        mat = torch.cat([mat, grads['bias'][:, None]], dim=1)
    return mat


def matrix_to_grads(spec: LayerSpec, mat: torch.Tensor,
                    like: dict) -> dict:
    """Inverse of :func:`grads_to_matrix`, shaped like ``like``."""
    if spec.kind not in KNOWN_KINDS:
        raise ValueError(f'unknown layer kind {spec.kind!r}')
    out = dict(like)
    if spec.has_bias:
        out['bias'] = mat[..., -1].reshape(like['bias'].shape)
        mat = mat[..., :-1]
    out['weight'] = mat.reshape(like['weight'].shape)
    return out


def factor_shapes(spec: LayerSpec, params: dict) -> tuple[int, int]:
    """(A_dim, G_dim) of a layer from its ``{'weight', ...}`` shapes (an
    embedding: ``(vocab, dim)``, A being a diagonal of length vocab; a
    grouped conv: the dims of one group's blocks)."""
    w = params['weight']
    if spec.kind == LINEAR:
        out_dim, in_dim = w.shape
        return in_dim + int(spec.has_bias), out_dim
    if spec.kind == CONV2D:
        cout, cin, kh, kw = w.shape
        return cin * kh * kw + int(spec.has_bias), cout
    if spec.kind == CONV2D_GROUPED:
        # Per-group dims: the layer carries feature_group_count stacked
        # (da, da) / (dg, dg) blocks.
        cout, cpg, kh, kw = w.shape
        return (cpg * kh * kw + int(spec.has_bias),
                cout // spec.feature_group_count)
    if spec.kind == EMBEDDING:
        vocab, dim = w.shape
        return vocab, dim
    raise ValueError(f'unknown layer kind {spec.kind!r}')
