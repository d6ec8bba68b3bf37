"""Weight-sharing Kronecker approximation policy, KFAC-expand / reduce
(PyTorch port of ``distributed_kfac_pytorch_tpu/sharing/approx.py``).

A layer whose weight is shared across a sequence or patch axis admits two
factorizations (arXiv:2311.00636):

  - **expand**: every shared-axis position is a covariance row
    (``(B, T, d)`` flattened to ``B*T`` rows), the default;
  - **reduce**: activations are averaged and output-grads summed over the
    shared axis before the covariance, which then sees ``B`` rows.

Setting grammar (``KFAC(kfac_approx=...)``):

  - ``'expand'`` (default): every layer expand;
  - ``'reduce'``: reduce for sequence/patch-shared Linears (a Linear whose
    input has more than 2 dims) and for patch-embedding convs (stride ==
    kernel, zero padding); expand everywhere else;
  - ``{pattern: 'expand' | 'reduce'}``: per layer; a pattern matches a
    layer when it equals the layer name or is a substring of it.
    Unmatched layers stay expand. A pattern that matches nothing, or
    forces reduce onto a kind without a reduce path, raises.

Host-side policy only: the resolved choice is carried in
``LayerSpec.kfac_approx`` and the factor math dispatches on it.
"""

from __future__ import annotations

import dataclasses

from distributed_kfac_pytorch_tpu_torch.capture import (
    CONV2D,
    KFAC_APPROXES,
    KFAC_EXPAND,
    KFAC_REDUCE,
    LINEAR,
    LayerSpec,
)


def is_patch_conv(spec: LayerSpec) -> bool:
    """True for a non-overlapping patch-embedding conv: stride equal to
    the kernel and zero padding (the ViT ``patch_embed`` signature)."""
    if spec.kind != CONV2D or spec.kernel_size is None:
        return False
    if tuple(spec.strides or ()) != tuple(spec.kernel_size):
        return False
    pad = spec.padding
    if isinstance(pad, str):
        return pad.lower() == 'valid'
    try:
        return all(int(lo) == 0 and int(hi) == 0 for lo, hi in pad)
    except (TypeError, ValueError):
        return False


def layer_is_shared(spec: LayerSpec) -> bool:
    """Does this layer's weight see several shared-axis positions? A
    Linear seen with a >2-D input, or a patch-embedding conv."""
    if spec.kind == LINEAR:
        return spec.shared_positions > 1
    return is_patch_conv(spec)


def _supports_reduce(spec: LayerSpec) -> bool:
    """Kinds with a reduce path: Linear and patch-embedding conv."""
    return spec.kind == LINEAR or is_patch_conv(spec)


def resolve_approx(setting, specs: dict[str, LayerSpec]) -> dict[str, str]:
    """``{layer: 'expand' | 'reduce'}`` for ``specs`` under ``setting``
    (the module docstring's grammar), in registration order."""
    if setting is None:
        setting = KFAC_EXPAND
    if isinstance(setting, str):
        if setting not in KFAC_APPROXES:
            raise ValueError(
                f'kfac_approx={setting!r}: expected one of '
                f'{KFAC_APPROXES} or a {{pattern: approx}} dict')
        if setting == KFAC_EXPAND:
            return {name: KFAC_EXPAND for name in specs}
        return {name: (KFAC_REDUCE if layer_is_shared(spec)
                       else KFAC_EXPAND)
                for name, spec in specs.items()}
    if not isinstance(setting, dict):
        raise ValueError(
            f'kfac_approx must be a string or dict, got '
            f'{type(setting).__name__}')
    out = {name: KFAC_EXPAND for name in specs}
    for pattern, approx in setting.items():
        if approx not in KFAC_APPROXES:
            raise ValueError(
                f'kfac_approx[{pattern!r}]={approx!r}: expected one of '
                f'{KFAC_APPROXES}')
        matched = [name for name in specs
                   if pattern == name or pattern in name]
        if not matched:
            raise ValueError(
                f'kfac_approx pattern {pattern!r} matches no registered '
                f'layer (have {sorted(specs)})')
        for name in matched:
            if approx == KFAC_REDUCE and not _supports_reduce(specs[name]):
                raise ValueError(
                    f'kfac_approx[{pattern!r}]=reduce: layer {name!r} '
                    f'(kind {specs[name].kind!r}) has no reduce path — '
                    'reduce is defined for Dense layers and '
                    'non-overlapping patch-embedding convs')
            out[name] = approx
    return out


def annotate_specs(specs: dict[str, LayerSpec], setting
                   ) -> dict[str, LayerSpec]:
    """``specs`` with each layer's resolved ``kfac_approx``."""
    resolved = resolve_approx(setting, specs)
    return {name: (spec if spec.kfac_approx == resolved[name]
                   else dataclasses.replace(spec,
                                            kfac_approx=resolved[name]))
            for name, spec in specs.items()}


def approx_summary(specs: dict[str, LayerSpec]) -> dict[str, str]:
    """``{layer: approx}``, a tied embedding labelled ``'<approx>+tied'``."""
    return {name: spec.kfac_approx + ('+tied' if spec.tied_calls else '')
            for name, spec in specs.items()}
