"""Layer-kind dispatch (PyTorch port of
``distributed_kfac_pytorch_tpu/layers/base.py``).

Pure functions over a :class:`~distributed_kfac_pytorch_tpu_torch.capture.
LayerSpec` and that layer's captures or parameter gradients:

  - ``compute_a_factor`` / ``compute_g_factor``: per-call factors, summed
    over calls;
  - ``grads_to_matrix`` / ``matrix_to_grads``: a layer's ``{'weight',
    'bias'}`` gradients to and from the 2-D ``(out_dim, in_dim[+1])``
    matrix the preconditioner works in. torch layouts: Linear weight
    ``(out, in)``; Conv2d weight ``(cout, cin, kh, kw)`` flattened to
    ``(cout, cin*kh*kw)``, so the A basis is ``(c, kh, kw)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_kfac_pytorch_tpu_torch.capture import CONV2D, LINEAR, \
    LayerSpec
from distributed_kfac_pytorch_tpu_torch.ops import factors as F


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
    """Input-covariance factor A from per-call activations."""
    if spec.kind == LINEAR:
        return _sum_calls(lambda a: F.linear_a_factor(
            a, spec.has_bias, compute_dtype=compute_dtype), a_calls,
            spec.name)
    if spec.kind == CONV2D:
        return _sum_calls(lambda a: F.conv2d_a_factor(
            a, spec.kernel_size, spec.strides, spec.padding, spec.has_bias,
            compute_dtype=compute_dtype), a_calls, spec.name)
    raise ValueError(f'unknown layer kind {spec.kind!r}')


def compute_g_factor(spec: LayerSpec, g_calls: Sequence[torch.Tensor],
                     compute_dtype=None) -> torch.Tensor:
    """Output-gradient covariance factor G from per-call output grads."""
    if spec.kind == LINEAR:
        return _sum_calls(lambda g: F.linear_g_factor(
            g, compute_dtype=compute_dtype), g_calls, spec.name)
    if spec.kind == CONV2D:
        return _sum_calls(lambda g: F.conv2d_g_factor(
            g, compute_dtype=compute_dtype), g_calls, spec.name)
    raise ValueError(f'unknown layer kind {spec.kind!r}')


def grads_to_matrix(spec: LayerSpec, grads: dict) -> torch.Tensor:
    """``{'weight', 'bias'}`` gradients -> ``(out_dim, in_dim[+1])``."""
    if spec.kind not in (LINEAR, CONV2D):
        raise ValueError(f'unknown layer kind {spec.kind!r}')
    w = grads['weight']
    mat = w.reshape(w.shape[0], -1)
    if spec.has_bias:
        mat = torch.cat([mat, grads['bias'][:, None]], dim=1)
    return mat


def matrix_to_grads(spec: LayerSpec, mat: torch.Tensor,
                    like: dict) -> dict:
    """Inverse of :func:`grads_to_matrix`, shaped like ``like``."""
    if spec.kind not in (LINEAR, CONV2D):
        raise ValueError(f'unknown layer kind {spec.kind!r}')
    out = dict(like)
    if spec.has_bias:
        out['bias'] = mat[:, -1].reshape(like['bias'].shape)
        mat = mat[:, :-1]
    out['weight'] = mat.reshape(like['weight'].shape)
    return out


def factor_shapes(spec: LayerSpec, params: dict) -> tuple[int, int]:
    """(A_dim, G_dim) of a layer from its ``{'weight', ...}`` shapes."""
    w = params['weight']
    if spec.kind == LINEAR:
        out_dim, in_dim = w.shape
        return in_dim + int(spec.has_bias), out_dim
    if spec.kind == CONV2D:
        cout, cin, kh, kw = w.shape
        return cin * kh * kw + int(spec.has_bias), cout
    raise ValueError(f'unknown layer kind {spec.kind!r}')
