"""The CLIs' observability flags (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/cli.py``):

    add_observability_args(parser)   # --kfac-metrics / --metrics-interval
                                     # / --health-action / --profile-dir /
                                     # --memory-interval /
                                     # --no-perf-anomalies /
                                     # --straggler-shards /
                                     # --straggler-sample-every
    sink = make_metrics_sink(args, rank, meta={...})
    rank_sink = make_rank_shard_sink(args, rank, meta={...})
    emit_layer_meta(sink, kfac)      # after the layers are registered
    with profile_epoch(args.profile_dir, rank): ...   # one epoch

``--log-dir`` is each CLI's own (its default names the CLI).
"""

from __future__ import annotations

import contextlib
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
    p.add_argument('--profile-dir', default=None,
                   help='capture a torch.profiler trace (CPU and CUDA '
                        'activity, a Chrome trace file) of the first '
                        'trained epoch into this dir; the kfac/* stage '
                        'scopes attribute its device time (rank 0 only)')
    p.add_argument('--memory-interval', type=int, default=100,
                   help='emit a memory-telemetry record (the CUDA '
                        'allocator watermarks + resident K-FAC state '
                        'footprint by group/dtype) every N steps into the '
                        'metrics JSONL; 0 disables. Host-side reads '
                        'only. Requires --kfac-metrics')
    p.add_argument('--no-perf-anomalies', action='store_true',
                   help='disable the live perf-anomaly monitors '
                        '(plain-step spike z-score, monotonic memory '
                        'growth) that --health-action otherwise arms '
                        'beside the numerics checks; the offline gate '
                        'still replays both checks from the stream')
    p.add_argument('--straggler-shards', action='store_true',
                   help='every rank writes its own sink shard '
                        '(PATH.rank<r>) with its per-step host time and '
                        'pre-collective barrier wait, for straggler '
                        'attribution (observability.report merges the '
                        'shards). The barrier probe synchronizes the '
                        'card on the steps it samples. Requires '
                        '--kfac-metrics')
    p.add_argument('--straggler-sample-every', type=int, default=1,
                   metavar='N',
                   help='run the barrier-wait probe only every Nth step '
                        '(a pure function of the global step, the same '
                        'steps on every rank); other steps carry no wait '
                        'field. Requires --straggler-shards')


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
    checks are on unless ``--no-perf-anomalies``, as in the JAX CLIs. A
    health action or straggler shards without the stream raise the JAX
    CLIs' ``SystemExit``, as do a bad ``--straggler-sample-every`` and
    the bare flag without a ``--log-dir`` to write under.
    """
    if args.health_action and not args.kfac_metrics:
        raise SystemExit('--health-action requires --kfac-metrics '
                         '(the monitor consumes the drained metrics)')
    if getattr(args, 'straggler_shards', False) and not args.kfac_metrics:
        raise SystemExit('--straggler-shards requires --kfac-metrics '
                         '(shards live next to the metrics path)')
    if getattr(args, 'straggler_sample_every', 1) < 1:
        raise SystemExit('--straggler-sample-every must be >= 1')
    if (getattr(args, 'straggler_sample_every', 1) > 1
            and not getattr(args, 'straggler_shards', False)):
        raise SystemExit('--straggler-sample-every requires '
                         '--straggler-shards (it paces the barrier '
                         'probe those shards record)')
    if args.kfac_metrics == 'auto' and not args.log_dir:
        raise SystemExit('--kfac-metrics without a PATH writes under '
                         '--log-dir, which is not set')
    if not args.kfac_metrics:
        return None
    monitor = None
    if args.health_action:
        cov_freq = max(1, int(getattr(args, 'kfac_cov_update_freq', 1)))
        perf = not getattr(args, 'no_perf_anomalies', False)
        monitor = obs_health.HealthMonitor(
            action=args.health_action, stale_after_steps=10 * cov_freq,
            step_spike_zscore=8.0 if perf else None,
            memory_growth_windows=6 if perf else 0)
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


def make_rank_shard_sink(args, rank: int, meta: dict | None = None):
    """The rank's straggler shard sink at ``<metrics-path>.rank<r>`` under
    ``--straggler-shards`` (None otherwise); its meta carries
    ``launch.host_metadata()``, so the merged report can name the host."""
    if not getattr(args, 'straggler_shards', False):
        return None
    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.observability import stragglers
    return stragglers.make_rank_shard_sink(
        metrics_path(args), rank,
        meta={**launch.host_metadata(), **(meta or {})})


@contextlib.contextmanager
def profile_epoch(profile_dir: str | None, rank: int):
    """Profile the epoch run inside into ``profile_dir`` on rank 0
    (``--profile-dir``: the engine's epoch loop profiles the first epoch
    it trains); a no-op without a directory or on another rank. Kernel
    builds that happen inside land in the window."""
    from distributed_kfac_pytorch_tpu_torch.observability import profiling
    active = (profile_dir is not None
              and profiling.start_trace(profile_dir, process_index=rank))
    try:
        yield
    finally:
        if active:
            profiling.stop_trace()
