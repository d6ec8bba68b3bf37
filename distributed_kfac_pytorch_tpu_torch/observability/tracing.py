"""Host-side wall-clock tracing: the trace table (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/tracing.py``; the names are
re-exported from ``distributed_kfac_pytorch_tpu_torch.utils``).

``@trace(sync=True)`` synchronizes the card before and after the call
when an argument or the result holds a CUDA tensor
(``torch.cuda.synchronize``), so the time covers the device work and not
only its dispatch; on the CPU it does nothing more. Two faults of the
reference's ``utils.py`` stay fixed, as in the JAX package: ``clear_trace``
clears the table, and ``get_trace`` has no undefined name.

The table is the host-visible stage attribution: phases a caller
decorates, and the engine's ``train_step_dispatch`` per step. Device time
inside a step is attributed by the profiler scopes of
:mod:`observability.profiling`; the sink snapshots this table into each
epoch record (:func:`snapshot_trace`), which ``observability.report``
prints.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch

_FUNC_TRACES: dict[str, list[float]] = {}


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (tensors, or lists,
    tuples and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _cuda_devices(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, out)
    return out


def _sync(obj) -> None:
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


def trace(sync: bool = False, name: str | None = None) -> Callable:
    """Decorator appending each call's duration to the trace table.

    Args:
      sync: synchronize the card before the call (on the CUDA tensors
        among the arguments) and after it (on those of the result), so
        the time covers device execution, not only dispatch.
      name: trace key (defaults to the function's ``__name__``).
    """
    def decorator(fn):
        key = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if sync:
                _sync([args, kwargs])
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                _sync(out)
            _FUNC_TRACES.setdefault(key, []).append(
                time.perf_counter() - start)
            return out

        return wrapper

    return decorator


def get_trace(average: bool = True, max_history: int | None = None
              ) -> dict[str, float]:
    """Per-key mean (or total) duration in seconds; ``max_history``
    keeps the most recent N samples."""
    out = {}
    for key, times in _FUNC_TRACES.items():
        window = times[-max_history:] if max_history else times
        if not window:
            continue
        out[key] = (sum(window) / len(window)) if average else sum(window)
    return out


def print_trace(average: bool = True, max_history: int | None = None
                ) -> None:
    for key, val in sorted(get_trace(average, max_history).items()):
        print(f'{key}: {val * 1000:.3f} ms')


def clear_trace() -> None:
    _FUNC_TRACES.clear()


def record(key: str, seconds: float) -> None:
    """Append one duration measured elsewhere (the engine's per-step
    dispatch time) to the table the decorator feeds."""
    _FUNC_TRACES.setdefault(key, []).append(seconds)


def snapshot_trace() -> dict[str, dict[str, float]]:
    """``{key: {'mean_ms', 'total_ms', 'count'}}``: the table as the
    epoch records carry it."""
    out = {}
    for key, times in _FUNC_TRACES.items():
        if not times:
            continue
        total = sum(times)
        out[key] = {'mean_ms': total / len(times) * 1000.0,
                    'total_ms': total * 1000.0,
                    'count': len(times)}
    return out
