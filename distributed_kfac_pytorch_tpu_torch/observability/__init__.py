"""K-FAC observability of the PyTorch port (the JAX package's
``distributed_kfac_pytorch_tpu/observability``), one discipline —
*observing a run must not change it*:

  - :mod:`metrics` — the on-device metrics of ``KFAC(collect_metrics=
    True)`` (``state['metrics']``); metrics off is the plain step, bit
    for bit and launch for launch;
  - :mod:`sink` — the schema-versioned JSONL writer (rank-0 gated,
    atomic write-then-rename, rotation, ``metrics_interval``) and its
    readers;
  - :mod:`health` — non-finite / staleness / damping / step-spike /
    memory-growth monitors with warn / skip / raise actions;
  - :mod:`report` — ``python -m distributed_kfac_pytorch_tpu_torch.
    observability.report run.jsonl`` (``--json`` for machines);
  - :mod:`gate` — the regression gate over a stream against a baseline
    (``python -m ...observability.gate run.jsonl --baseline B.json``);
  - :mod:`memory` — the CUDA allocator's watermarks and the K-FAC state
    footprint (``kind='memory'`` records);
  - :mod:`profiling` — the ``kfac/*`` profiler scopes
    (``torch.profiler.record_function`` and NVTX) and the
    ``--profile-dir`` session;
  - :mod:`tracing` — the host trace table the epoch records carry;
  - :mod:`stragglers` — per-rank shards, the barrier probe and the
    readers the report merges;
  - :mod:`cli` — the CLIs' observability flags.

Every submodule loads on first attribute access.
"""

from __future__ import annotations

import importlib

_LAZY = ('metrics', 'sink', 'health', 'report', 'cli', 'stragglers',
         'gate', 'memory', 'profiling', 'tracing')

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(
            f'distributed_kfac_pytorch_tpu_torch.observability.{name}')
        globals()[name] = mod
        return mod
    raise AttributeError(name)
