"""Performance-regression gate over a recorded metrics JSONL (PyTorch
port of ``distributed_kfac_pytorch_tpu/observability/gate.py``)::

    python -m distributed_kfac_pytorch_tpu_torch.observability.gate \\
        run.jsonl --baseline BASELINE_OBS.json

The gate reduces a stream to a metric vector (:func:`gate_metrics`):

  - ``step_p50_ms`` / ``step_p95_ms`` / ``step_p99_ms``: the host
    step-time distribution (the report's percentiles);
  - ``max_over_median``: the spike ratio;
  - ``peak_hbm_bytes``: the highest ``peak_bytes_in_use`` of the
    ``kind='memory'`` records (absent without allocator stats, e.g. on
    the CPU);
  - ``retraces``, ``selfheal_rollbacks``, ``supervisor_restarts`` and
    ``fleet_quarantines``: counts of those events (the port emits no
    ``retrace``; a JAX stream may);

and compares it with a baseline file under per-metric relative
tolerances (the counts absolutely), exiting non-zero on any breach.
``--write-baseline`` reduces a known-good run to a baseline file. It
also replays the stream through the online anomaly monitors
(``observability.health``: the step-time spike z-score and the
monotonic memory-growth detector); anomalies fail like breaches
(``--no-anomaly`` opts out).

The exit codes (0 pass, 1 breach or anomaly, 2 usage or read error),
the baseline file's format and the metric names are the JAX gate's: each
gate reads the other's baselines and either package's streams, so the
port's streams gate on a machine without JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from distributed_kfac_pytorch_tpu_torch.observability import health as \
    obs_health
from distributed_kfac_pytorch_tpu_torch.observability import report as \
    obs_report
from distributed_kfac_pytorch_tpu_torch.observability.sink import (
    SUPERVISOR_SIDECAR_SUFFIX,
    peak_hbm_bytes,
    read_jsonl_tolerant,
)

BASELINE_FORMAT = 'kfac-obs-baseline-v1'

# Per-metric relative tolerances (fraction above baseline that still
# passes). 'retraces' is absolute: a baseline of 0 retraces tolerates
# exactly 0. Current values may always be BETTER than baseline.
DEFAULT_TOLERANCES = {
    'step_p50_ms': 0.10,
    'step_p95_ms': 0.15,
    'step_p99_ms': 0.25,
    'max_over_median': 0.25,
    'peak_hbm_bytes': 0.05,
    'retraces': 0.0,
    # Self-healing: in-process rollbacks are recoveries, but a run that
    # needed one regressed against a baseline that needed none (an
    # absolute count, like retraces). Baselines without the metric skip
    # it ("not in baseline").
    'selfheal_rollbacks': 0.0,
    # Supervision: the same logic one level up — a supervised run that
    # needed process-level restarts (crash/hang relaunches) recovered,
    # but it regressed against a baseline that ran clean. Counted from
    # supervisor_restart events (the <jsonl>.supervisor sidecar is
    # merged by main(); inline events count too).
    'supervisor_restarts': 0.0,
    # Fleet: quarantined jobs (crash loops, exhausted budgets,
    # rejected specs) are the fleet-level recovered-but-regressed
    # signal — the pool stayed healthy, but a job mix that quarantined
    # one regressed against a baseline mix that ran clean. Counted
    # from fleet_quarantine events when the gate is pointed at a fleet
    # scheduler's event stream (absolute count, like retraces).
    'fleet_quarantines': 0.0,
}
_ABSOLUTE_METRICS = ('retraces', 'selfheal_rollbacks',
                     'supervisor_restarts', 'fleet_quarantines')


def gate_metrics(records: list[dict]) -> dict:
    """Reduce a record stream to the gated metric vector."""
    dist = obs_report.step_time_distribution(records)
    peak = peak_hbm_bytes(records)
    retraces = sum(1 for r in records
                   if r.get('kind') == 'event'
                   and r.get('event') == 'retrace')
    rollbacks = sum(1 for r in records
                    if r.get('kind') == 'event'
                    and r.get('event') == 'selfheal_rollback')
    sup_restarts = sum(1 for r in records
                       if r.get('kind') == 'event'
                       and r.get('event') == 'supervisor_restart')
    fleet_q = sum(1 for r in records
                  if r.get('kind') == 'event'
                  and r.get('event') == 'fleet_quarantine')
    out = {
        'n_steps': dist['n_steps'] if dist else 0,
        'step_p50_ms': dist['p50_ms'] if dist else None,
        'step_p95_ms': dist['p95_ms'] if dist else None,
        'step_p99_ms': dist['p99_ms'] if dist else None,
        'max_over_median': (dist['max_over_median'] if dist else None),
        'peak_hbm_bytes': peak,
        'retraces': retraces,
        'selfheal_rollbacks': rollbacks,
        'supervisor_restarts': sup_restarts,
        'fleet_quarantines': fleet_q,
    }
    for k, v in out.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
    return out


def compare(current: dict, baseline: dict,
            tolerances: dict | None = None,
            allow_missing: bool = False) -> tuple[list[dict], list[str]]:
    """Gate ``current`` against ``baseline``.

    Returns ``(breaches, skipped)``. A metric present in the baseline
    but absent from the current run is a breach (the regression the
    gate exists for could be hiding exactly there) unless
    ``allow_missing`` — the documented escape for platform differences
    (a CPU dev box has no HBM watermarks to compare against a TPU
    baseline). Metrics absent from the baseline are skipped: a
    baseline only vouches for what it measured.
    """
    tolerances = {**DEFAULT_TOLERANCES, **(tolerances or {})}
    breaches, skipped = [], []
    for metric, tol in tolerances.items():
        base = baseline.get(metric)
        if base is None:
            skipped.append(f'{metric}: not in baseline')
            continue
        cur = current.get(metric)
        if cur is None:
            if allow_missing:
                skipped.append(f'{metric}: absent from this run '
                               '(allowed)')
                continue
            breaches.append({'metric': metric, 'current': None,
                             'baseline': base, 'limit': None,
                             'kind': 'missing'})
            continue
        if metric in _ABSOLUTE_METRICS:
            limit = base + tol
        else:
            limit = base * (1.0 + tol)
        if cur > limit:
            breaches.append({'metric': metric, 'current': cur,
                             'baseline': base, 'limit': limit,
                             'kind': 'regression'})
    return breaches, skipped


def anomaly_events(records: list[dict], *,
                   spike_zscore: float = 8.0,
                   growth_windows: int = 6,
                   growth_min_frac: float = 0.05) -> list[str]:
    """Replay the stream through the online anomaly monitors.

    Returns only the perf-anomaly events (step-time spike, memory
    growth) — the numerics checks (non-finite, damping, staleness)
    have their own surface in the report/health path and are not this
    gate's business.
    """
    mon = obs_health.HealthMonitor(
        action='skip', step_spike_zscore=spike_zscore,
        memory_growth_windows=growth_windows,
        memory_growth_min_frac=growth_min_frac)
    for r in records:
        if r.get('kind') in ('step', 'memory'):
            mon.observe(r)
    return [e for e in mon.events
            if 'step-time spike' in e or 'memory grew' in e]


def write_baseline(metrics: dict, path: str,
                   meta: dict | None = None) -> dict:
    """Serialize a gate baseline file (the committed artifact)."""
    obj = {'format': BASELINE_FORMAT,
           'created_unix': int(time.time()),
           'meta': dict(meta or {}),
           'metrics': {k: v for k, v in metrics.items()
                       if v is not None}}
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write('\n')
    return obj


def read_baseline(path: str) -> dict:
    with open(path) as f:
        obj = json.load(f)
    if obj.get('format') != BASELINE_FORMAT:
        raise ValueError(
            f'{path}: not a {BASELINE_FORMAT} file '
            f'(format={obj.get("format")!r})')
    metrics = obj.get('metrics')
    if not isinstance(metrics, dict):
        raise ValueError(f'{path}: baseline has no metrics object')
    return obj


def _parse_tols(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        key, _, val = pair.partition('=')
        if key not in DEFAULT_TOLERANCES:
            raise ValueError(
                f'unknown gate metric {key!r} '
                f'(one of {sorted(DEFAULT_TOLERANCES)})')
        try:
            out[key] = float(val)
        except ValueError:
            raise ValueError(f'--tol {pair!r}: not KEY=FLOAT') from None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog='python -m distributed_kfac_pytorch_tpu_torch.observability'
             '.gate',
        description='Performance-regression gate over a K-FAC metrics '
                    'JSONL: step-time percentiles, peak HBM and '
                    'retrace count vs a committed baseline, plus '
                    'online anomaly checks. Exit 0 = pass, 1 = '
                    'breach/anomaly, 2 = usage/read error.')
    p.add_argument('jsonl', help='metrics stream from --kfac-metrics')
    p.add_argument('--baseline', default=None,
                   help='committed BASELINE_OBS.json to gate against')
    p.add_argument('--write-baseline', default=None, metavar='PATH',
                   help='reduce this (known-good) run to a baseline '
                        'file instead of gating')
    p.add_argument('--tol', action='append', default=[],
                   metavar='METRIC=FRAC',
                   help='override one tolerance (relative fraction; '
                        'retraces is an absolute count), e.g. '
                        '--tol step_p95_ms=0.2; repeatable')
    p.add_argument('--allow-missing', action='store_true',
                   help='a baseline metric absent from this run is '
                        'skipped instead of breaching (platform '
                        'differences, e.g. no HBM stats on CPU)')
    p.add_argument('--no-anomaly', action='store_true',
                   help='skip the online anomaly replay (spike '
                        'z-score, memory growth)')
    p.add_argument('--spike-zscore', type=float, default=8.0)
    p.add_argument('--growth-windows', type=int, default=6)
    p.add_argument('--growth-min-frac', type=float, default=0.05)
    p.add_argument('--json', action='store_true',
                   help='machine-readable verdict on stdout')
    args = p.parse_args(argv)

    try:
        records, torn = read_jsonl_tolerant(args.jsonl)
        tols = _parse_tols(args.tol)
        baseline = (read_baseline(args.baseline)
                    if args.baseline else None)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f'error: {e}', file=sys.stderr)
        return 2
    # Supervisor sidecar: supervisor_restart events live in
    # <jsonl>.supervisor (the supervisor outlives child incarnations);
    # merge them so the supervisor_restarts metric sees the whole
    # session. Unreadable sidecar = skip, like the report.
    sidecar = args.jsonl + SUPERVISOR_SIDECAR_SUFFIX
    if os.path.exists(sidecar):
        try:
            sup_records, sup_torn = read_jsonl_tolerant(sidecar)
            records = records + sup_records
            torn += sup_torn
        except (OSError, ValueError) as e:
            print(f'note: supervisor sidecar {sidecar} unreadable: '
                  f'{e}', file=sys.stderr)
    current = gate_metrics(records)
    # The tolerances actually applied (defaults + --tol overrides):
    # part of the verdict artifact, so a recorded gate run is
    # self-describing — without this you cannot tell from the output
    # which overrides were in effect.
    applied_tols = {**DEFAULT_TOLERANCES, **tols}

    if args.write_baseline:
        obj = write_baseline(current, args.write_baseline,
                             meta={'source': args.jsonl,
                                   'torn_lines': torn})
        print(f'wrote baseline {args.write_baseline}: '
              + json.dumps(obj['metrics'], sort_keys=True))
        if not args.baseline:
            return 0

    breaches, skipped = ([], [])
    if baseline is not None:
        breaches, skipped = compare(current, baseline['metrics'],
                                    applied_tols,
                                    allow_missing=args.allow_missing)
    anomalies = [] if args.no_anomaly else anomaly_events(
        records, spike_zscore=args.spike_zscore,
        growth_windows=args.growth_windows,
        growth_min_frac=args.growth_min_frac)
    failed = bool(breaches or anomalies)

    if args.json:
        print(json.dumps({'pass': not failed, 'current': current,
                          'baseline': (baseline or {}).get('metrics'),
                          'tolerances': applied_tols,
                          'breaches': breaches, 'skipped': skipped,
                          'anomalies': anomalies,
                          'torn_lines': torn}, sort_keys=True))
        return 1 if failed else 0

    print('== K-FAC observability gate ==')
    if torn:
        print(f'note: skipped {torn} torn trailing line(s)')
    print('current: ' + json.dumps(current, sort_keys=True))
    if baseline is not None:
        print('tolerances: ' + json.dumps(applied_tols,
                                          sort_keys=True))
    if baseline is None:
        print('no --baseline: anomaly checks only')
    for s in skipped:
        print(f'  skip   {s}')
    for b in breaches:
        if b['kind'] == 'missing':
            print(f"  BREACH {b['metric']}: absent from this run "
                  f"(baseline {b['baseline']:g}; --allow-missing to "
                  'skip)')
        else:
            print(f"  BREACH {b['metric']}: {b['current']:g} > limit "
                  f"{b['limit']:g} (baseline {b['baseline']:g})")
    for a in anomalies:
        print(f'  ANOMALY {a}')
    print('FAIL' if failed else 'PASS')
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
