"""Memory telemetry: the device allocator's watermarks and the K-FAC
state footprint (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/memory.py``).

  - :func:`device_memory_stats`: the caching allocator's counters
    (``torch.cuda.memory_stats``) under the JAX package's names:
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``, which is
    ``torch.cuda.max_memory_allocated``), and the memory the allocator
    holds from the driver, ``bytes_reserved`` and ``peak_bytes_reserved``
    (``reserved_bytes.all.current`` / ``.peak``). Off a CUDA device it
    returns ``{}``, as the JAX function does off an accelerator, so callers
    emit records unconditionally. The counters are host-side: no
    synchronize, no transfer.
  - :func:`state_footprint`: a walk over the K-FAC state's tensors by
    group and dtype (shapes and dtypes only).

The engine samples every ``memory_interval`` steps (``--memory-interval``
in the CLIs) into ``kind='memory'`` records; ``observability.report``
prints them and ``observability.gate`` regresses the peak.
"""

from __future__ import annotations

from typing import Any

import torch

# state_footprint groups; other top-level keys (step, inv_chunk_phase,
# accum_decay) fold into 'other'. A DistributedKFAC's row stacks, its
# diagonal and grouped inverses count as inverses, as the single
# device's 'inverses' do.
STATE_GROUPS = {
    'factors': 'factors',
    'inverses': 'inverses',
    'inv_stacks': 'inverses',
    'diag_inv': 'inverses',
    'grouped_inv': 'inverses',
    'metrics': 'metrics',
    'factor_accum': 'factor_accum',
    'frozen_factors': 'frozen_factors',
}

#: ``torch.cuda.memory_stats`` keys -> the record's names.
STAT_KEYS = {'allocated_bytes.all.current': 'bytes_in_use',
             'allocated_bytes.all.peak': 'peak_bytes_in_use',
             'reserved_bytes.all.current': 'bytes_reserved',
             'reserved_bytes.all.peak': 'peak_bytes_reserved'}


def device_memory_stats(device=None) -> dict:
    """Allocator watermarks of one CUDA device (``{}`` off CUDA).

    ``device`` defaults to the current CUDA device when one is present;
    a CPU device, or a process without CUDA, gives ``{}``.
    """
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
        return {}
    stats = torch.cuda.memory_stats(device)
    return {name: int(stats[key]) for key, name in STAT_KEYS.items()
            if key in stats}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``'float32'`` (the JAX record's names)."""
    return str(dtype).rsplit('.', 1)[-1]


def state_footprint(state: Any) -> dict:
    """Byte breakdown of a K-FAC state by group and dtype::

      {'total_bytes': int,
       'by_group': {'factors': int, 'inverses': int, ...},
       'by_dtype': {'float32': int, 'bfloat16': int, ...},
       'by_group_dtype': {'inverses/bfloat16': int, ...}}

    Groups follow :data:`STATE_GROUPS`. Tensors that share storage (the
    stale snapshot shares the factors' tensors until the next factor
    update) each count. Python scalars count nothing; a state that is
    not a dict (the SGD baseline's None) gives zeros.
    """
    out = {'total_bytes': 0, 'by_group': {}, 'by_dtype': {},
           'by_group_dtype': {}}
    if not isinstance(state, dict):
        return out
    for key, sub in state.items():
        group = STATE_GROUPS.get(key, 'other')
        for t in _leaves(sub):
            n = t.numel() * t.element_size()
            if not n:
                continue
            dt = _dtype_name(t.dtype)
            out['total_bytes'] += n
            out['by_group'][group] = out['by_group'].get(group, 0) + n
            out['by_dtype'][dt] = out['by_dtype'].get(dt, 0) + n
            gk = f'{group}/{dt}'
            out['by_group_dtype'][gk] = out['by_group_dtype'].get(gk, 0) + n
    return out


def format_bytes(n: float) -> str:
    """Human-readable byte count for the report tables."""
    try:
        n = float(n)
    except (TypeError, ValueError):
        return '-'
    for unit in ('B', 'KiB', 'MiB', 'GiB', 'TiB'):
        if abs(n) < 1024.0 or unit == 'TiB':
            return (f'{n:.0f} {unit}' if unit == 'B'
                    else f'{n:.2f} {unit}')
        n /= 1024.0
    return f'{n:.2f} TiB'
