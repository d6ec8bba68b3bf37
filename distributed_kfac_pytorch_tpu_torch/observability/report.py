"""Offline run report over a recorded K-FAC metrics JSONL (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/report.py``; the same text
and ``--json`` output for the same stream, without JAX).

    python -m distributed_kfac_pytorch_tpu_torch.observability.report run.jsonl

Prints, from the recorded stream alone (no live process needed):

  - run/meta header and record inventory;
  - the per-stage step-time breakdown (host trace-table snapshots from
    epoch records — the stages CLIs/benchmarks decorate with
    ``observability.tracing.trace`` — plus per-step host dispatch
    time);
  - K-FAC health: factor/inverse firing counts, non-finite skips,
    eigenvalue-floor clips, damping/ν trajectory, grad vs
    preconditioned-grad norm ratio;
  - per precondition-bucket norms (last recorded step);
  - resilience events: preemption / checkpoint-save / restore
    counts with checkpoint-save latency stats;
  - memory telemetry: device HBM watermarks (last/peak) and the
    resident K-FAC state footprint by group/dtype;
  - compile/retrace telemetry: the first-call wall time of each
    compiled unit (here each kernel library's first-use build or load;
    in a JAX stream each step variant's trace + compile) and any
    retrace events;
  - straggler attribution: when per-rank shards
    (``run.jsonl.rank<r>``, ``--straggler-shards``) sit next to the
    stream, per-host skew, slowest-rank frequency and barrier-wait
    stats;
  - the sections of subsystems this package does not have yet, read
    from any stream that carries their events (the JAX package's):
  - self-healing: the escalation ladder's decision trail —
    damping escalations/decays, bucket quarantines/readmits,
    in-process rollbacks, and checkpoint quarantines from the
    verified resume walk (``resilience.selfheal``);
  - supervision: the failure supervisor's decision trail —
    restarts, hang detections, survivor-mesh failovers/grow-backs,
    crash loops — merged from the ``run.jsonl.supervisor`` sidecar
    the supervisor writes next to the stream
    (``resilience.supervisor``);
  - fleet scheduling: when pointed at a fleet scheduler's own
    event stream (``<fleet-workdir>/fleet.jsonl``), the scheduler's
    decision counts (admits, preempts/regrows, quarantines) plus one
    SLO row per finished job — queue wait, run time, restarts,
    preemption count, final gate verdict — carried by its
    ``fleet_complete``/``fleet_quarantine`` events
    (``fleet.scheduler``).

A torn/truncated FINAL line (a host crashed mid-append) is skipped and
counted in the header instead of refusing the stream; torn lines
anywhere else are corruption and still fail. Exit status is non-zero
when the file fails schema validation, so the CI smoke can gate on it
directly. ``--json`` emits the machine-readable summary the
regression gate and CI consume (the JAX package's key set).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from distributed_kfac_pytorch_tpu_torch.observability.health import (
    HealthMonitor,
)
from distributed_kfac_pytorch_tpu_torch.observability.memory import (  # noqa: F401
    format_bytes,
)
from distributed_kfac_pytorch_tpu_torch.observability.sink import (
    SUPERVISOR_SIDECAR_SUFFIX,
    peak_hbm_bytes,
    percentile as _percentile,
    read_jsonl_tolerant,
    to_float as _num,
)


def _fmt(v: float, unit: str = '') -> str:
    if math.isnan(v):
        return '-'
    return f'{v:.4g}{unit}'


def step_time_distribution(records: list[dict]) -> dict | None:
    """Step-time percentiles + outlier attribution by fired stage.

    Backend-independent (host dispatch wall time per step, recorded by
    the engine for every step record): p50/p95/p99/max ms/iter, the
    max/median spike ratio — the step-time-uniformity metric the
    pipelined inverse firing targets — and, for outlier steps
    (> 2x the median, the firing-spike signature), counts and mean ms
    per fired stage ('factor' / 'inverse' / 'chunk<j>' / plain).
    """
    host = [(r['host_step_ms'], r.get('fired', 'plain'))
            for r in records
            if r.get('kind') == 'step' and 'host_step_ms' in r]
    if not host:
        return None
    vals = sorted(v for v, _ in host)
    p50 = _percentile(vals, 50)
    dist = {
        'n_steps': len(vals),
        'p50_ms': p50,
        'p95_ms': _percentile(vals, 95),
        'p99_ms': _percentile(vals, 99),
        'max_ms': vals[-1],
        'max_over_median': (vals[-1] / p50 if p50 else float('nan')),
    }
    threshold = 2.0 * p50
    dist['outlier_threshold_ms'] = threshold
    stages: dict[str, dict] = {}
    for v, f in host:
        s = stages.setdefault(f, {'count': 0, 'total_ms': 0.0,
                                  'outliers': 0, 'outlier_ms': 0.0})
        s['count'] += 1
        s['total_ms'] += v
        if v > threshold:
            s['outliers'] += 1
            s['outlier_ms'] += v
    dist['stages'] = {
        f: {'count': s['count'],
            'mean_ms': s['total_ms'] / s['count'],
            'outliers': s['outliers'],
            'outlier_mean_ms': (s['outlier_ms'] / s['outliers']
                                if s['outliers'] else float('nan'))}
        for f, s in stages.items()}
    return dist


# The supervisor's event vocabulary (registered in sink.EVENT_KINDS).
# Supervisor events normally live in a SIDECAR stream next to the
# run's JSONL (``<path>.supervisor`` — the supervisor outlives child
# incarnations, so its decisions cannot ride the rank-0 stream that
# each relaunch rotates away); ``main`` merges the sidecar, and
# ``summarize`` also picks up any supervision events recorded inline.
_SUPERVISION_KINDS = ('supervisor_restart', 'supervisor_failover',
                      'supervisor_growback', 'hang_detected',
                      'crash_loop', 'capacity_degraded')

# The fleet scheduler's event vocabulary (registered in
# sink.EVENT_KINDS). Fleet events live in the fleet's OWN stream
# (``<fleet-workdir>/fleet.jsonl`` — the scheduler outlives every job
# it packs); pointing this report at that stream renders the fleet
# section with one SLO row per job, built from the data each
# fleet_complete / fleet_quarantine event carries.
_FLEET_KINDS = ('fleet_admit', 'fleet_preempt', 'fleet_regrow',
                'fleet_quarantine', 'fleet_complete')

#: The per-job SLO row keys a fleet_complete / fleet_quarantine event
#: contributes to the report's ``fleet.jobs`` table (pinned by
#: the --json consumer's contract).
FLEET_SLO_KEYS = ('outcome', 'rc', 'devices', 'queue_wait_s', 'run_s',
                  'restarts', 'preemptions', 'gate', 'reason')


def _series(records, key):
    out = []
    for r in records:
        if r.get('kind') == 'step' and key in r.get('metrics', {}):
            out.append((r['step'], _num(r['metrics'][key])))
    return out


def summarize(records: list[dict],
              supervisor_records: list[dict] | None = None) -> dict:
    """Structured summary of a record stream (the report's data model).

    ``supervisor_records``: the supervisor's sidecar stream
    (``<path>.supervisor``), merged into the supervision section only —
    its events describe the whole supervised session, while the main
    stream may hold just the newest incarnation.
    """
    steps = [r for r in records if r.get('kind') == 'step']
    epochs = [r for r in records if r.get('kind') == 'epoch']
    meta = next((r['meta'] for r in records if r.get('kind') == 'meta'),
                {})

    # Per-stage breakdown: the LAST epoch record's trace snapshot holds
    # the cumulative table (snapshot_trace accumulates over the run).
    stages = {}
    for r in epochs:
        for k, v in r.get('trace', {}).items():
            stages[k] = v

    host_ms = [r['host_step_ms'] for r in steps if 'host_step_ms' in r]
    loss = _series(records, 'loss')
    gn = _series(records, 'kfac/grad_norm')
    pn = _series(records, 'kfac/precond_norm')
    ratio = [(s, p / g if g else float('nan'))
             for (s, g), (_, p) in zip(gn, pn)]
    damping = _series(records, 'kfac/damping')
    nu = _series(records, 'kfac/nu')

    last = steps[-1]['metrics'] if steps else {}
    buckets = {k.split('/', 2)[-1]: _num(v) for k, v in last.items()
               if k.startswith('kfac/bucket_norm/')}

    monitor = HealthMonitor(action='skip')
    for r in records:
        monitor.observe(r)

    # Resilience events: counts per kind plus checkpoint-save
    # latency stats (the forced preemption save is the one that gates
    # process exit — its latency is the grace budget consumed).
    events = [r for r in records if r.get('kind') == 'event']
    event_counts: dict[str, int] = {}
    for r in events:
        event_counts[r['event']] = event_counts.get(r['event'], 0) + 1
    save_lat = [_num(r.get('data', {}).get('latency_ms'))
                for r in events if r['event'] == 'checkpoint_save']
    save_lat = [v for v in save_lat if not math.isnan(v)]

    # Memory telemetry: device watermarks + state footprint.
    mem_records = [r for r in records if r.get('kind') == 'memory']
    memory = None
    if mem_records:
        peak = peak_hbm_bytes(mem_records)
        last_state = next((r['state'] for r in reversed(mem_records)
                           if r.get('state')), {})
        memory = {'n_samples': len(mem_records),
                  'peak_hbm_bytes': peak,
                  'last_device': dict(mem_records[-1].get('device',
                                                          {})),
                  'last_state': dict(last_state)}

    # Compile/retrace telemetry: one 'compile' event per first-use
    # build (this package: the kernel libraries' build or load; a JAX
    # stream: each step variant's trace + compile), and 'retrace' events
    # (JAX streams only).
    compiles = [dict(r.get('data', {})) for r in events
                if r['event'] == 'compile']
    retraces = [dict(r.get('data', {})) for r in events
                if r['event'] == 'retrace']

    # Autotune decision events: policy backoff/relax decisions
    # and the fail-closed --tuned-config load outcome. Rendered in
    # their own section (and pinned in the --json key set) so a run's
    # effective configuration story is auditable from the stream.
    # Counts cover the whole stream; the per-event detail list keeps
    # only the newest window — a mesh oscillating around the skew
    # threshold emits stretch/relax pairs indefinitely, and neither
    # the report nor its --json consumer should scale with that (the
    # full sequence is on disk in the stream itself).
    # Self-healing ladder events: escalation/de-escalation,
    # bucket quarantine/readmit, in-process rollbacks, and the verified
    # resume walk's checkpoint quarantines. Same newest-window cap
    # discipline as the autotune section (an oscillating ladder must
    # not grow the report); the full sequence is in the stream.
    selfheal_events = [{'event': r['event'], **dict(r.get('data', {}))}
                       for r in events
                       if r['event'].startswith('selfheal')
                       or r['event'] == 'ckpt_quarantine']
    selfheal = None
    if selfheal_events:
        count = lambda kind: sum(1 for e in selfheal_events
                                 if e['event'] == kind)
        selfheal = {
            'n_events': len(selfheal_events),
            'events': selfheal_events[-50:],
            'escalations': count('selfheal_escalate'),
            'deescalations': count('selfheal_deescalate'),
            'quarantines': count('selfheal_quarantine'),
            'readmits': count('selfheal_readmit'),
            'rollbacks': count('selfheal_rollback'),
            'ckpt_quarantines': count('ckpt_quarantine'),
        }

    # Failure supervision: the supervisor's decision trail —
    # restarts, hang detections, failover/grow-back resizes, crash
    # loops. Usually from the sidecar stream (the supervisor outlives
    # every child incarnation); inline events count too. Same
    # newest-window cap discipline as the other event sections.
    sup_source = list(events)  # inline events (filtered above) ...
    for r in (supervisor_records or []):
        if r.get('kind') == 'event':
            sup_source.append(r)  # ... plus the sidecar's
    supervision_events = [{'event': r['event'],
                           **dict(r.get('data', {}))}
                          for r in sup_source
                          if r['event'] in _SUPERVISION_KINDS]
    supervision = None
    if supervision_events:
        count = lambda kind: sum(1 for e in supervision_events
                                 if e['event'] == kind)
        supervision = {
            'n_events': len(supervision_events),
            'events': supervision_events[-50:],
            'restarts': count('supervisor_restart'),
            'failovers': count('supervisor_failover'),
            'growbacks': count('supervisor_growback'),
            'hangs': count('hang_detected'),
            'crash_loops': count('crash_loop'),
        }

    # Fleet scheduling: per-job SLO rows plus scheduler decision
    # counts. The terminal events (fleet_complete / fleet_quarantine)
    # carry each job's SLO data, so the table needs no second stream;
    # same newest-window cap discipline for the event detail list.
    fleet_events = [{'event': r['event'], **dict(r.get('data', {}))}
                    for r in events if r['event'] in _FLEET_KINDS]
    fleet = None
    if fleet_events:
        count = lambda kind: sum(1 for e in fleet_events
                                 if e['event'] == kind)
        jobs: dict[str, dict] = {}
        for e in fleet_events:
            if e['event'] not in ('fleet_complete', 'fleet_quarantine'):
                continue
            row = {k: e.get(k) for k in FLEET_SLO_KEYS}
            row['outcome'] = ('complete'
                              if e['event'] == 'fleet_complete'
                              else 'quarantined')
            jobs[str(e.get('job'))] = row
        fleet = {
            'n_events': len(fleet_events),
            'events': fleet_events[-50:],
            'admits': count('fleet_admit'),
            'preempts': count('fleet_preempt'),
            'regrows': count('fleet_regrow'),
            'quarantines': count('fleet_quarantine'),
            'completes': count('fleet_complete'),
            'jobs': jobs,
        }

    autotune_events = [{'event': r['event'], **dict(r.get('data', {}))}
                       for r in events
                       if r['event'].startswith('autotune')]
    autotune = None
    if autotune_events:
        autotune = {
            'n_events': len(autotune_events),
            'events': autotune_events[-50:],
            'backoffs': sum(1 for e in autotune_events
                            if e['event'] == 'autotune_backoff'
                            and e.get('action') == 'stretch'),
            'relaxes': sum(1 for e in autotune_events
                           if e['event'] == 'autotune_backoff'
                           and e.get('action') == 'relax'),
            'fallbacks': sum(1 for e in autotune_events
                             if e['event'] == 'autotune_fallback'),
            'applies': sum(1 for e in autotune_events
                           if e['event'] == 'autotune_apply'),
        }

    return {
        'autotune': autotune,
        'selfheal': selfheal,
        'supervision': supervision,
        'fleet': fleet,
        'memory': memory,
        'compiles': compiles,
        'retraces': retraces,
        'events': events,
        'event_counts': event_counts,
        'save_latency_ms': ((sum(save_lat) / len(save_lat),
                             max(save_lat)) if save_lat else None),
        'meta': meta,
        'n_records': len(records),
        'n_steps': len(steps),
        'n_epochs': len(epochs),
        'step_range': ((steps[0]['step'], steps[-1]['step'])
                       if steps else None),
        'stages': stages,
        'host_step_ms': (sum(host_ms) / len(host_ms) if host_ms
                         else float('nan')),
        'step_time': step_time_distribution(records),
        'loss': loss,
        'precond_ratio': ratio,
        'damping': damping,
        'nu': nu,
        'factor_updates': _num(last.get('kfac/factor_updates')),
        'inv_updates': _num(last.get('kfac/inv_updates')),
        'inv_chunk_firings': _num(last.get('kfac/inv_chunk_firings')),
        'nonfinite_skips': _num(last.get('kfac/nonfinite_skips')),
        'eig_clipped': _num(last.get('kfac/eig_clipped')),
        'bucket_norms': buckets,
        'health_events': list(monitor.events),
        # Per-check-kind counts.
        'health_event_counts': monitor.summary()['by_kind'],
    }


def _print_event_detail(w, events: list[dict], n_events: int,
                        cap: int = 10) -> None:
    """Shared newest-window event renderer (self-healing + autotune
    sections): '(newest K of N)' note plus one sorted-detail line per
    event — one place to change the cap or the formatting."""
    shown = events[-cap:]
    if n_events > len(shown):
        w(f"  (newest {len(shown)} of {n_events}; the full "
          'sequence is in the stream)')
    for e in shown:
        detail = ', '.join(f'{k}={v}' for k, v in sorted(e.items())
                           if k != 'event')
        w(f'  ! {e["event"]}: {detail}')


def print_report(s: dict, out=None, torn: int = 0,
                 stragglers: dict | None = None) -> None:
    out = out or sys.stdout
    w = lambda line='': print(line, file=out)
    w('== K-FAC run report ==')
    if torn:
        w(f'note: skipped {torn} torn trailing line(s) (crash '
          'mid-write; the rest of the stream is intact)')
    if s['meta']:
        w('meta: ' + ', '.join(f'{k}={v}' for k, v in
                               sorted(s['meta'].items())))
    rng = s['step_range']
    w(f"records: {s['n_records']} ({s['n_steps']} step / "
      f"{s['n_epochs']} epoch)"
      + (f", steps {rng[0]}..{rng[1]}" if rng else ''))
    w()
    w('-- step time --')
    w(f"host dispatch: {_fmt(s['host_step_ms'], ' ms/step')}")
    d = s.get('step_time')
    if d:
        w(f"distribution ({d['n_steps']} steps): "
          f"p50 {_fmt(d['p50_ms'])}  p95 {_fmt(d['p95_ms'])}  "
          f"p99 {_fmt(d['p99_ms'])}  max {_fmt(d['max_ms'])} ms/iter  "
          f"(max/median {_fmt(d['max_over_median'], 'x')})")
        outliers = {f: v for f, v in d['stages'].items()
                    if v['outliers']}
        if outliers:
            w(f"outlier steps (> {_fmt(d['outlier_threshold_ms'])} ms "
              '= 2x median), by fired stage:')
            for f in sorted(outliers):
                v = outliers[f]
                w(f'  {f:<10} x{v["outliers"]:<5} '
                  f'mean {_fmt(v["outlier_mean_ms"], " ms")}  '
                  f'(stage mean over all its steps: '
                  f'{_fmt(v["mean_ms"], " ms")})')
        else:
            w('no outlier steps (> 2x median).')
    if s['stages']:
        w('stage                              mean ms    total ms  calls')
        for k in sorted(s['stages']):
            v = s['stages'][k]
            w(f"{k:<34} {v['mean_ms']:>8.3f} {v['total_ms']:>11.3f}"
              f"  {v['count']:>5}")
    else:
        w('(no host trace-table snapshots in the records — epoch '
          'records absent or no host phase was timed; see '
          'observability.tracing)')
    w()
    w('-- K-FAC health --')
    w(f"factor updates: {_fmt(s['factor_updates'])}   "
      f"inverse updates: {_fmt(s['inv_updates'])}   "
      f"chunk firings: {_fmt(s['inv_chunk_firings'])}")
    w(f"non-finite skips: {_fmt(s['nonfinite_skips'])}   "
      f"eigenvalues at clip floor: {_fmt(s['eig_clipped'])}")
    for name, series in (('loss', s['loss']),
                         ('damping', s['damping']),
                         ('kl-clip nu', s['nu']),
                         ('precond/grad norm ratio',
                          s['precond_ratio'])):
        if series:
            vals = [v for _, v in series if not math.isnan(v)]
            if vals:
                w(f'{name}: first {_fmt(series[0][1])}  '
                  f'last {_fmt(series[-1][1])}  '
                  f'min {_fmt(min(vals))}  max {_fmt(max(vals))}')
    if s['bucket_norms']:
        w()
        w('-- precondition buckets (last step, |v| per shape) --')
        for k in sorted(s['bucket_norms']):
            w(f'{k:<16} {_fmt(s["bucket_norms"][k])}')
    if s.get('memory'):
        m = s['memory']
        w()
        w(f"-- memory ({m['n_samples']} samples) --")
        if m['peak_hbm_bytes'] is not None:
            w(f"peak device HBM: {format_bytes(m['peak_hbm_bytes'])}")
        dev = m['last_device']
        if dev:
            parts = [f'{k}={format_bytes(v)}' for k, v in sorted(
                dev.items()) if k in ('bytes_in_use',
                                      'peak_bytes_in_use',
                                      'bytes_limit')]
            if parts:
                w('last sample: ' + '  '.join(parts))
        else:
            w('(no device allocator stats on this backend — state '
              'footprint only)')
        st = m['last_state']
        if st.get('total_bytes'):
            w('resident K-FAC state (per device): '
              f"{format_bytes(st['total_bytes'])}")
            for gk in sorted(st.get('by_group_dtype', {})):
                w(f'  {gk:<24} '
                  f"{format_bytes(st['by_group_dtype'][gk])}")
    if s.get('compiles') or s.get('retraces'):
        w()
        w(f"-- compile/retrace ({len(s['compiles'])} variant "
          'compile(s)) --')
        for ev in s['compiles']:
            w(f"  compile {ev.get('variant', '?'):<28} "
              f"first call {_fmt(_num(ev.get('first_call_ms')), ' ms')}")
        if s['retraces']:
            w(f"  ! {len(s['retraces'])} RETRACE event(s) — a "
              'static-cadence variant recompiled mid-run '
              '(trace_counts contract violated):')
            for ev in s['retraces']:
                w(f"    {ev.get('variant', '?')} trace #"
                  f"{ev.get('trace_count', '?')}")
    if stragglers:
        w()
        w(f"-- stragglers ({stragglers['n_ranks']} rank shard(s), "
          f"{stragglers['n_common_steps']} common steps) --")
        for rank in sorted(stragglers.get('unreadable', {})):
            w(f"  ! rank {rank} shard unreadable: "
              f"{stragglers['unreadable'][rank]}")
        for rank in sorted(stragglers['per_rank']):
            pr = stragglers['per_rank'][rank]
            wait = ('' if pr['mean_wait_ms'] is None else
                    f"  wait mean {_fmt(pr['mean_wait_ms'], ' ms')}"
                    f" max {_fmt(pr['max_wait_ms'], ' ms')}")
            w(f"  rank {rank}: {pr['n_steps']} steps  "
              f"p50 {_fmt(pr['p50_ms'], ' ms')}  "
              f"p95 {_fmt(pr['p95_ms'], ' ms')}{wait}")
        ps = stragglers.get('per_slice')
        if ps:
            # Per-slice skew rows: pooled per-slice dispatch
            # percentiles + slowest-rank share, so a slow DCN domain
            # or sick slice reads in S rows instead of N rank rows.
            for sl in sorted(ps):
                row = ps[sl]
                ranks = ','.join(str(r) for r in row['ranks'])
                w(f"  slice {sl} (ranks {ranks}): "
                  f"{row['n_steps']} steps  "
                  f"p50 {_fmt(row['p50_ms'], ' ms')}  "
                  f"p95 {_fmt(row['p95_ms'], ' ms')}  "
                  f"slowest x{row['slowest_count']}")
        wbs = stragglers.get('wait_by_stage')
        if wbs:
            # Comm-wait attribution: the factor-step vs plain-
            # step barrier-wait split is where a deferred-reduce /
            # staleness overlap win shows up, readable from the JSONL
            # alone .
            parts = [f"{cls} mean {_fmt(v['mean_wait_ms'], ' ms')}"
                     f" max {_fmt(v['max_wait_ms'], ' ms')}"
                     f" (n={v['n']})"
                     for cls, v in sorted(wbs.items())]
            w('  comm wait by stage: ' + '  |  '.join(parts))
        if stragglers['n_common_steps']:
            counts = ', '.join(
                f'r{r}x{n}' for r, n in sorted(
                    stragglers['slowest_counts'].items()) if n)
            w(f'  slowest-rank frequency: {counts or "-"}')
            mean_skew = stragglers['mean_skew_ms']
            max_skew = stragglers['max_skew_ms']
            w(f"  per-step skew (slowest-fastest): mean "
              f"{_fmt(float('nan') if mean_skew is None else mean_skew, ' ms')}"
              f"  max "
              f"{_fmt(float('nan') if max_skew is None else max_skew, ' ms')}")
    if s.get('fleet'):
        fl = s['fleet']
        w()
        w(f"-- fleet ({fl['n_events']} scheduler event(s), "
          f"{len(fl['jobs'])} finished job(s)) --")
        w(f"admits: {fl['admits']}   preempts: {fl['preempts']} / "
          f"regrows: {fl['regrows']}   completes: {fl['completes']}   "
          f"quarantines: {fl['quarantines']}")
        for name in sorted(fl['jobs']):
            row = fl['jobs'][name]
            gate_note = ('' if row.get('gate') is None
                         else f"  gate {row['gate']}")
            w(f"  {name:<20} {row['outcome']:<12} rc {row['rc']}  "
              f"wait {_fmt(_num(row['queue_wait_s']), ' s')}  "
              f"run {_fmt(_num(row['run_s']), ' s')}  "
              f"restarts {row['restarts']}  "
              f"preemptions {row['preemptions']}{gate_note}")
        _print_event_detail(w, fl['events'], fl['n_events'])
    if s.get('supervision'):
        sup = s['supervision']
        w()
        w(f"-- supervision ({sup['n_events']} supervisor event(s)) --")
        w(f"restarts: {sup['restarts']}   hangs detected: "
          f"{sup['hangs']}   failovers: {sup['failovers']} / "
          f"grow-backs: {sup['growbacks']}   crash loops: "
          f"{sup['crash_loops']}")
        _print_event_detail(w, sup['events'], sup['n_events'])
    if s.get('selfheal'):
        sh = s['selfheal']
        w()
        w(f"-- self-healing ({sh['n_events']} ladder event(s)) --")
        w(f"damping escalations: {sh['escalations']} up / "
          f"{sh['deescalations']} decayed   quarantine: "
          f"{sh['quarantines']} gated / {sh['readmits']} re-admitted")
        w(f"rollbacks: {sh['rollbacks']} in-process   checkpoint "
          f"quarantines: {sh['ckpt_quarantines']}")
        _print_event_detail(w, sh['events'], sh['n_events'])
    if s.get('autotune'):
        a = s['autotune']
        w()
        w(f"-- autotune ({a['n_events']} decision event(s)) --")
        w(f"policy backoffs: {a['backoffs']} stretch / "
          f"{a['relaxes']} relax   tuned-config: {a['applies']} "
          f"applied / {a['fallbacks']} fell back to defaults")
        _print_event_detail(w, a['events'], a['n_events'])
    # Compile/retrace, autotune and self-healing events have their own
    # sections above; everything else in the event stream is
    # resilience lifecycle.
    resil_counts = {k: v for k, v in s['event_counts'].items()
                    if k not in ('compile', 'retrace',
                                 'ckpt_quarantine')
                    and k not in _SUPERVISION_KINDS
                    and k not in _FLEET_KINDS
                    and not k.startswith('autotune')
                    and not k.startswith('selfheal')}
    if resil_counts:
        w()
        w('-- resilience events --')
        for name in sorted(resil_counts):
            w(f'{name:<18} x{resil_counts[name]}')
        if s['save_latency_ms']:
            mean, worst = s['save_latency_ms']
            w(f'checkpoint save latency: mean {_fmt(mean, " ms")}  '
              f'max {_fmt(worst, " ms")}')
        for r in s['events']:
            # Lifecycle moments worth a per-event line: preemptions,
            # restores, and topology changes (elastic resizes) — the
            # grow/shrink events show up here alongside the
            # preemption that drained the old world.
            if r['event'] in ('preemption', 'restore',
                              'topology_change'):
                detail = ', '.join(f'{k}={v}' for k, v in
                                   sorted(r.get('data', {}).items()))
                w(f'  ! {r["event"]}: {detail}')
    w()
    if s['health_events']:
        w(f"-- {len(s['health_events'])} health event(s) --")
        for e in s['health_events']:
            w(f'  ! {e}')
    else:
        w('no health events.')


def _json_safe(x):
    """Recursively replace non-finite floats (json.dumps would emit
    bare NaN/Infinity, which strict parsers — and the gate — reject)
    and coerce tuple keys/values into JSON-clean structures."""
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def summary_json(s: dict, *, torn: int = 0,
                 stragglers: dict | None = None) -> dict:
    """The machine-readable report (``--json``; consumed by the gate
    and CI). The top-level key set is the JAX package's: extend, don't
    rename."""
    return _json_safe({
        'meta': s['meta'],
        'n_records': s['n_records'],
        'n_steps': s['n_steps'],
        'n_epochs': s['n_epochs'],
        'step_range': s['step_range'],
        'step_time': s['step_time'],
        'stages': s['stages'],
        'memory': s['memory'],
        'compiles': s['compiles'],
        'retraces': s['retraces'],
        'autotune': s['autotune'],
        'selfheal': s['selfheal'],
        'supervision': s['supervision'],
        'fleet': s['fleet'],
        'event_counts': s['event_counts'],
        'kfac': {
            'factor_updates': s['factor_updates'],
            'inv_updates': s['inv_updates'],
            'inv_chunk_firings': s['inv_chunk_firings'],
            'nonfinite_skips': s['nonfinite_skips'],
            'eig_clipped': s['eig_clipped'],
            'bucket_norms': s['bucket_norms'],
        },
        'health_events': s['health_events'],
        'health_event_counts': s['health_event_counts'],
        'stragglers': stragglers,
        'torn_lines': torn,
    })


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog='python -m distributed_kfac_pytorch_tpu_torch.observability'
             '.report',
        description='Summarize a recorded K-FAC metrics JSONL '
                    '(schema-validates; non-zero exit on invalid '
                    'files). A torn FINAL line is skipped and counted, '
                    'not fatal.')
    p.add_argument('jsonl', help='metrics file from --kfac-metrics '
                                 '(rotated segments are read too)')
    p.add_argument('--json', action='store_true',
                   help='machine-readable summary on stdout (the gate/'
                        'CI input; key set pinned by tests)')
    args = p.parse_args(argv)
    from distributed_kfac_pytorch_tpu_torch.observability import (
        stragglers as straggler_mod,
    )
    try:
        records, torn = read_jsonl_tolerant(args.jsonl)
        shards, shard_torn, shard_errors = straggler_mod.merge_shards(
            args.jsonl)
    except (OSError, ValueError) as e:
        print(f'error: {e}', file=sys.stderr)
        return 1
    torn += shard_torn
    # Supervisor sidecar: the supervision decision trail lives
    # next to the stream, written by a different process — torn-
    # tolerant like the shards, and an unreadable sidecar degrades the
    # supervision section rather than the report.
    supervisor_records = None
    sidecar = args.jsonl + SUPERVISOR_SIDECAR_SUFFIX
    if os.path.exists(sidecar):
        try:
            supervisor_records, sup_torn = read_jsonl_tolerant(sidecar)
            torn += sup_torn
        except (OSError, ValueError) as e:
            print(f'note: supervisor sidecar {sidecar} unreadable: {e}',
                  file=sys.stderr)
    stragglers = straggler_mod.straggler_summary(shards)
    if shard_errors:
        # Unreadable shards degrade the straggler section, never the
        # main report (one sick host must not hide the run summary).
        if stragglers is None:
            stragglers = {'n_ranks': 0, 'per_rank': {},
                          'n_common_steps': 0, 'slowest_counts': {},
                          'mean_skew_ms': None, 'max_skew_ms': None,
                          'wait_by_stage': None, 'per_slice': None}
        stragglers['unreadable'] = shard_errors
    s = summarize(records, supervisor_records=supervisor_records)
    if args.json:
        print(json.dumps(summary_json(s, torn=torn,
                                      stragglers=stragglers),
                         sort_keys=True))
        return 0
    print_report(s, torn=torn, stragglers=stragglers)
    from distributed_kfac_pytorch_tpu_torch.observability.sink import (
        incarnation_paths,
        read_incarnation,
    )
    prev = incarnation_paths(args.jsonl)
    if prev:
        print()
        print(f'-- {len(prev)} surviving prior incarnation(s) '
              '(newest first; each readable with this report CLI) --')
        for path in prev:
            try:
                n = len(read_incarnation(path))
                note = f'{n} records'
            except (OSError, ValueError) as e:
                note = f'unreadable: {e}'
            print(f'  {path}  ({note})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
