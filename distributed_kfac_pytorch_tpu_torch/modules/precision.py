"""A model's compute ``dtype`` with flax's meaning (no JAX counterpart
file: flax's ``dtype`` attribute on ``Dense``, ``Conv``, ``Embed`` and the
norms).

:func:`set_compute_dtype` makes every ``nn.Linear``, ``nn.Conv2d`` and
``nn.Embedding`` of a model compute in ``dtype``: at each call the
layer's floating input and its parameters are cast to ``dtype`` (flax's
``promote_dtype``), so its output is in ``dtype``, while the parameters
stay stored in fp32 and receive fp32 gradients through the cast. The
norms keep fp32 parameters and statistics, as flax's do: a BatchNorm takes
the ``dtype`` input as it is (torch's mixed-precision BatchNorm computes
its statistics in fp32 and returns the input's dtype, on the CPU and in
cuDNN), a LayerNorm or GroupNorm normalizes the input widened to fp32 and
returns its result cast to the input's dtype (flax's arithmetic; torch's
CUDA LayerNorm takes no fp16 input with fp32 parameters). An ``Embed``'s
``attend`` casts its query and table too.

The cast is two module hooks: a forward pre-hook casts the input and
swaps each parameter for its cast copy for the duration of the call, and
a forward hook (run even when the call raises, as a rematerialized
block's early-stopped recomputation does) puts the fp32 parameters back.
The layers stay plain ``nn.Linear`` / ``nn.Conv2d`` / ``nn.Embedding``,
so the K-FAC capture registers each of them; it records a layer's input
as the model passes it, before this cast (``capture.KFACCapture``): the
stem's ``a`` is the fp32 image, as JAX sows the module's input before
flax casts it.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

#: The compute dtypes a model takes: fp32 (no cast), fp16 and bf16.
COMPUTE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)

_CAST_LAYERS = (nn.Linear, nn.Conv2d, nn.Embedding)
_FP32_NORMS = (nn.LayerNorm, nn.GroupNorm)


def check_compute_dtype(dtype) -> torch.dtype:
    """``dtype`` as a torch dtype (None is fp32); anything but fp32, fp16
    and bf16 raises ``NotImplementedError`` naming it."""
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f'compute dtype={dtype} is not ported (the port computes in '
            'torch.float32, torch.float16 or torch.bfloat16)')
    return dtype


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Make every ``nn.Linear``, ``nn.Conv2d`` and ``nn.Embedding`` of
    ``model`` compute in ``dtype`` (see the module docstring); fp32 (or
    None) leaves the model as it is. Returns ``model``."""
    dtype = check_compute_dtype(dtype)
    if dtype == torch.float32:
        return model
    for mod in model.modules():
        if isinstance(mod, _CAST_LAYERS):
            mod.register_forward_pre_hook(
                functools.partial(_cast_call, dtype=dtype))
            mod.register_forward_hook(_restore_params, always_call=True)
        elif isinstance(mod, _FP32_NORMS):
            mod.register_forward_pre_hook(_widen_input)
            mod.register_forward_hook(_narrow_output)
        if hasattr(mod, 'attend'):
            mod.compute_dtype = dtype
    return model


def _cast_call(mod: nn.Module, args: tuple, *, dtype) -> tuple:
    """Forward pre-hook: the parameters swapped for their ``dtype`` copies
    (kept for :func:`_restore_params`) and a floating input cast."""
    saved = {}
    for name, p in mod._parameters.items():
        if p is not None and p.is_floating_point():
            saved[name] = p
            mod._parameters[name] = p.to(dtype)
    mod._fp32_params = saved
    x = args[0]
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return (x.to(dtype), *args[1:])
    return args


def _restore_params(mod: nn.Module, args, output) -> None:
    """Forward hook: the fp32 parameters back in place."""
    mod._parameters.update(getattr(mod, '_fp32_params', {}))
    mod._fp32_params = {}


def _widen_input(mod: nn.Module, args: tuple) -> tuple:
    """A norm's forward pre-hook: its input in fp32 (the dtype it came in
    kept for :func:`_narrow_output`)."""
    mod._input_dtype = args[0].dtype
    return (args[0].float(), *args[1:])


def _narrow_output(mod: nn.Module, args, output) -> torch.Tensor:
    """A norm's forward hook: its output in the dtype its input came in."""
    return output.to(mod._input_dtype)
