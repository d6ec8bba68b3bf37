"""The CLIs' observability flags (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/cli.py``, the flags the port
runs):

    add_observability_args(parser)   # --kfac-metrics / --metrics-interval
                                     # / --health-action
    sink = make_metrics_sink(args, rank, meta={...})
    emit_layer_meta(sink, kfac)      # after the layers are registered

``--log-dir`` is each CLI's own (its default names the CLI). The other
observability flags of the JAX CLIs (``--profile-dir``,
``--memory-interval``, ``--no-perf-anomalies``, ``--straggler-shards``,
``--straggler-sample-every``) raise by name (``engine.UNPORTED_FLAGS``).
"""

from __future__ import annotations

import os

from distributed_kfac_pytorch_tpu_torch.observability import health as \
    obs_health
from distributed_kfac_pytorch_tpu_torch.observability import sink as \
    obs_sink


def add_observability_args(p) -> None:
    """``--kfac-metrics``, ``--metrics-interval`` and ``--health-action``
    (the JAX CLIs' names, defaults and meaning)."""
    p.add_argument('--kfac-metrics', nargs='?', const='auto',
                   default=None, metavar='PATH',
                   help='collect on-device K-FAC step metrics (damping, '
                        'KL-clip nu, grad/precond norms, firing counts, '
                        'non-finite events) into a schema-versioned '
                        'JSONL — default PATH <log-dir>/'
                        'kfac_metrics.jsonl, rank-0 only, no host '
                        'syncs added to the step. Summarize with: '
                        'python -m distributed_kfac_pytorch_tpu_torch'
                        '.observability.report PATH')
    p.add_argument('--metrics-interval', type=int, default=10,
                   help='keep every Nth step record in the metrics '
                        'JSONL (epoch records always kept)')
    p.add_argument('--health-action', default=None,
                   choices=list(obs_health.ACTIONS),
                   help='K-FAC health monitoring over the drained '
                        'metrics (non-finite events, factor staleness, '
                        'damping jumps, step-time spikes). skip/raise '
                        'also arm the non-finite factor-update guard, '
                        'which protects the FACTOR STATISTICS only; '
                        'for a whole-step skip on non-finite gradients '
                        'use --fp16. Requires --kfac-metrics')


def wants_guard(args) -> bool:
    """True when the non-finite factor guard should be armed ('warn'
    observes only; 'skip' / 'raise' protect the state)."""
    return getattr(args, 'health_action', None) in ('skip', 'raise')


def metrics_path(args) -> str:
    """The resolved ``--kfac-metrics`` path (``<log-dir>/
    kfac_metrics.jsonl`` for the bare flag)."""
    return (os.path.join(args.log_dir, 'kfac_metrics.jsonl')
            if args.kfac_metrics == 'auto' else args.kfac_metrics)


def make_metrics_sink(args, rank: int, meta: dict | None = None):
    """The JSONL sink (with a health monitor under ``--health-action``)
    for a CLI, or None without ``--kfac-metrics``.

    Rank gating happens inside the sink (ranks other than 0 get a no-op
    sink). The monitor's factor-staleness limit is 10x the CLI's factor
    cadence, and the step-spike (8 sigma) and memory-growth (6 samples)
    checks are on, as in the JAX CLIs. A health action without the stream
    raises the JAX CLIs' ``SystemExit``, as does the bare flag without a
    ``--log-dir`` to write under.
    """
    if args.health_action and not args.kfac_metrics:
        raise SystemExit('--health-action requires --kfac-metrics '
                         '(the monitor consumes the drained metrics)')
    if args.kfac_metrics == 'auto' and not args.log_dir:
        raise SystemExit('--kfac-metrics without a PATH writes under '
                         '--log-dir, which is not set')
    if not args.kfac_metrics:
        return None
    monitor = None
    if args.health_action:
        cov_freq = max(1, int(getattr(args, 'kfac_cov_update_freq', 1)))
        monitor = obs_health.HealthMonitor(
            action=args.health_action, stale_after_steps=10 * cov_freq,
            step_spike_zscore=8.0, memory_growth_windows=6)
    return obs_sink.JsonlMetricsSink(
        metrics_path(args), interval=args.metrics_interval,
        process_index=rank, monitor=monitor, meta=meta)


def emit_layer_meta(sink, kfac) -> None:
    """Append the per-layer weight-sharing approximation of the registered
    layers (``KFAC.approx_summary``) and the global setting as a second
    ``kind='meta'`` record: the CLIs build the sink before the model, so
    this comes after registration. No-op without a sink or K-FAC."""
    if sink is None or kfac is None:
        return
    sink.meta_record({
        'kfac_approx': kfac.approx_summary(),
        'kfac_approx_setting': (kfac.kfac_approx
                                if isinstance(kfac.kfac_approx, str)
                                else dict(kfac.kfac_approx)),
        'tied_embeddings': bool(kfac.tied_embeddings)})
