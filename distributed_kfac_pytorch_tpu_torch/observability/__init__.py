"""K-FAC observability of the PyTorch port (the core of
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
  - :mod:`stragglers` — the readers of per-rank shards the report merges;
  - :mod:`cli` — the CLIs' ``--kfac-metrics`` / ``--metrics-interval`` /
    ``--health-action`` wiring.

Every submodule loads on first attribute access.
"""

from __future__ import annotations

import importlib

_LAZY = ('metrics', 'sink', 'health', 'report', 'cli', 'stragglers')

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(
            f'distributed_kfac_pytorch_tpu_torch.observability.{name}')
        globals()[name] = mod
        return mod
    raise AttributeError(name)
