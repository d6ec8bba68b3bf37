"""Host-side K-FAC health monitoring over drained metric records
(PyTorch port of ``distributed_kfac_pytorch_tpu/observability/health.py``).

The on-device half lives in the preconditioner (the non-finite factor
guard: a NaN/Inf candidate factor update is *skipped* on device and
counted in ``metrics['nonfinite_skips']``, so the running factors are
never poisoned). This module is the host half: it watches the drained
JSONL records and turns anomalies into events with a configurable
``action``:

  - ``'warn'``  — ``warnings.warn`` once per event (default);
  - ``'skip'``  — record the event silently (the device guard already
    protected the state; useful for unattended sweeps);
  - ``'raise'`` — raise :class:`HealthError` (fail fast in CI or when a
    run's numerics must be pristine).

Checks (each one host-arithmetic over scalars — zero device work):

  - **non-finite events**: ``nonfinite_skips`` increments, or any
    non-finite ``loss`` / ``grad_norm`` / ``precond_norm``;
  - **factor staleness**: steps since ``factor_updates`` last
    incremented exceeds ``stale_after_steps``;
  - **damping trajectory**: the per-step damping jumps by more than
    ``damping_jump_factor`` between consecutive records (a scheduler
    bug signature), or goes non-positive/non-finite;
  - **eigenvalue floor**: ``eig_clipped`` (eigenvalues pinned at the
    0.0 clip floor) rises past ``eig_clip_limit`` — rising-edge
    detection, so a persistently floored (stable, damping-covered)
    spectrum fires once per new high, not once per record.
  - **step-time spike** (``step_spike_zscore``): a step's host
    dispatch time lands more than z sigmas above the running
    mean/stddev of the plain (non-firing) steps seen so far. Steps
    carrying a ``fired`` stage are excluded from both the statistics
    and the detection — factor/inverse firings are *expected* spikes
    with their own attribution in the report, and the engine labels a
    step whose wall time absorbed the kernels' first-use build or load
    ``fired='compile'`` for the same reason (one absorbed 30 s build
    sample would inflate the running stddev enough to blind the
    detector for the rest of the run). This check exists for
    the unexpected spikes (a data-loader stall, a host page-in, a
    sick chip). The stddev is floored at 1%% of the mean so
    near-constant step streams don't turn fp jitter into infinite z.
  - **memory growth** (``memory_growth_windows``): the
    ``kind='memory'`` records' ``bytes_in_use`` watermark rises over N
    consecutive samples by more than ``memory_growth_min_frac`` of the
    run's starting value — the leak signature (a healthy run's resident
    state is flat after warmup; a leak or host-buffer accumulation is
    monotone). Fires once per sustained climb (latched
    until the watermark dips), not per sample.

The monitor runs at sink drain time (off the step path) — see
``JsonlMetricsSink(monitor=...)`` — or standalone over records from
``sink.read_jsonl`` (that is how the report replays a recorded stream
through the same checks offline).
"""

from __future__ import annotations

import math
import warnings

from distributed_kfac_pytorch_tpu_torch.observability.sink import (
    to_float as _num,  # shared coercion ('nan'/'inf' strings round-trip)
)

ACTIONS = ('warn', 'skip', 'raise')


class HealthError(RuntimeError):
    """Raised by a monitor with ``action='raise'`` on a health event."""


class HealthMonitor:
    """Stateful record-stream watcher (one instance per run)."""

    def __init__(self, action: str = 'warn', *,
                 stale_after_steps: int | None = None,
                 damping_jump_factor: float = 10.0,
                 eig_clip_limit: int = 0,
                 step_spike_zscore: float | None = None,
                 step_spike_warmup: int = 16,
                 memory_growth_windows: int = 0,
                 memory_growth_min_frac: float = 0.05):
        if action not in ACTIONS:
            raise ValueError(f'action must be one of {ACTIONS}, '
                             f'got {action!r}')
        if step_spike_zscore is not None and step_spike_zscore <= 0:
            raise ValueError(f'{step_spike_zscore=} must be positive')
        self.action = action
        self.stale_after_steps = stale_after_steps
        self.damping_jump_factor = damping_jump_factor
        self.eig_clip_limit = eig_clip_limit
        self.step_spike_zscore = step_spike_zscore
        self.step_spike_warmup = max(2, int(step_spike_warmup))
        self.memory_growth_windows = int(memory_growth_windows)
        self.memory_growth_min_frac = memory_growth_min_frac
        self.events: list[str] = []
        # Parallel per-event check kinds (same order as ``events``):
        # the machine-readable classification ``summary()`` counts by.
        self.event_kinds: list[str] = []
        self._last_factor_updates: float | None = None
        self._last_factor_step: int | None = None
        self._last_damping: float | None = None
        self._nonfinite_skips = 0.0
        self._max_eig_clipped = float(eig_clip_limit)
        # Welford accumulators over plain (unfired) steps' dispatch ms.
        self._ms_n = 0
        self._ms_mean = 0.0
        self._ms_m2 = 0.0
        # Memory-growth run state (consecutive-rise tracking).
        self._mem_prev: float | None = None
        self._mem_run_start: float | None = None
        self._mem_run_len = 0
        self._mem_latched = False

    # -- the checks ----------------------------------------------------

    def observe(self, rec: dict) -> list[str]:
        """Consume one record; returns (and acts on) new events."""
        if rec.get('kind') == 'memory':
            return self._record(self._observe_memory(rec))
        if rec.get('kind') != 'step':
            return []
        step = int(rec.get('step', 0))
        m = rec.get('metrics', {})
        events: list[tuple[str, str]] = []  # (kind, message)

        ms = rec.get('host_step_ms')
        if self.step_spike_zscore is not None and \
                isinstance(ms, (int, float)) and math.isfinite(ms) \
                and 'fired' not in rec:
            # Plain steps only: firing steps are expected outliers with
            # their own report attribution. Spike check BEFORE the
            # Welford update so the spike cannot vouch for itself.
            if self._ms_n >= self.step_spike_warmup:
                var = self._ms_m2 / (self._ms_n - 1)
                std = max(math.sqrt(max(var, 0.0)),
                          0.01 * self._ms_mean, 1e-9)
                z = (ms - self._ms_mean) / std
                if z > self.step_spike_zscore:
                    events.append((
                        'step_spike',
                        f'step {step}: step-time spike {ms:.3g} ms is '
                        f'{z:.1f} sigma above the plain-step mean '
                        f'{self._ms_mean:.3g} ms (threshold '
                        f'{self.step_spike_zscore:g}) — no K-FAC stage '
                        'fired this step; suspect host/data/chip'))
            self._ms_n += 1
            delta = ms - self._ms_mean
            self._ms_mean += delta / self._ms_n
            self._ms_m2 += delta * (ms - self._ms_mean)

        skips = _num(m.get('kfac/nonfinite_skips'))
        if not math.isnan(skips) and skips > self._nonfinite_skips:
            events.append((
                'nonfinite',
                f'step {step}: non-finite candidate factor update '
                f'(total {int(skips)}) — gradients/captures contained '
                "NaN/Inf (skipped on device when the guard is armed, "
                "i.e. --health-action skip/raise)"))
            self._nonfinite_skips = skips
        for key in ('loss', 'kfac/grad_norm', 'kfac/precond_norm'):
            if key in m and not math.isfinite(_num(m[key])):
                events.append(('nonfinite',
                               f'step {step}: non-finite {key} = '
                               f'{m[key]!r}'))

        fu = _num(m.get('kfac/factor_updates'))
        if not math.isnan(fu):
            if self._last_factor_updates is None or \
                    fu > self._last_factor_updates:
                self._last_factor_updates = fu
                self._last_factor_step = step
            elif (self.stale_after_steps is not None
                  and self._last_factor_step is not None
                  and step - self._last_factor_step
                  > self.stale_after_steps):
                events.append((
                    'factor_stale',
                    f'step {step}: factors stale — no factor update '
                    f'for {step - self._last_factor_step} steps '
                    f'(limit {self.stale_after_steps})'))

        damping = _num(m.get('kfac/damping'))
        if 'kfac/damping' in m:
            if not math.isfinite(damping) or damping <= 0.0:
                events.append(('damping',
                               f'step {step}: damping '
                               f'{m["kfac/damping"]!r}'
                               ' is not a positive finite value'))
            elif self._last_damping is not None and self._last_damping > 0:
                ratio = max(damping / self._last_damping,
                            self._last_damping / damping)
                if ratio > self.damping_jump_factor:
                    events.append((
                        'damping',
                        f'step {step}: damping jumped {ratio:.1f}x '
                        f'({self._last_damping:g} -> {damping:g})'))
            if math.isfinite(damping):
                self._last_damping = damping

        # Rising-edge only: the stored spectra persist between inverse
        # firings, so a rank-deficient factor would otherwise re-fire
        # on EVERY drained record (warn-storm under 'warn', instant
        # abort under 'raise' — floored-but-stable eigenvalues are
        # numerically harmless, the damping carries them).
        clipped = _num(m.get('kfac/eig_clipped'))
        if not math.isnan(clipped) and clipped > self._max_eig_clipped:
            events.append((
                'eig_floor',
                f'step {step}: {int(clipped)} eigenvalues at the 0.0 '
                f'clip floor (limit {self.eig_clip_limit}, previous '
                f'high {int(self._max_eig_clipped)}) — factors are '
                'rank-deficient or numerically indefinite'))
            self._max_eig_clipped = clipped

        return self._record(events)

    def _record(self, events: list[tuple[str, str]]) -> list[str]:
        msgs = [msg for _kind, msg in events]
        self.events.extend(msgs)
        self.event_kinds.extend(kind for kind, _msg in events)
        for e in msgs:
            self._act(e)
        return msgs

    def _observe_memory(self, rec: dict) -> list[str]:
        """Monotonic device-memory-growth detection (leak signature)."""
        if not self.memory_growth_windows:
            return []
        b = rec.get('device', {}).get('bytes_in_use')
        if not isinstance(b, (int, float)) or not math.isfinite(b):
            return []
        b = float(b)
        events: list[tuple[str, str]] = []
        if self._mem_prev is None or b <= self._mem_prev:
            # Flat or falling watermark: a healthy steady state. Reset
            # the run and re-arm the latch.
            self._mem_run_start = b
            self._mem_run_len = 0
            self._mem_latched = False
        else:
            self._mem_run_len += 1
            start = self._mem_run_start or b
            grown = (b - start) / start if start > 0 else 0.0
            if (not self._mem_latched
                    and self._mem_run_len >= self.memory_growth_windows
                    and grown > self.memory_growth_min_frac):
                events.append((
                    'memory_growth',
                    f"step {rec.get('step', '?')}: device memory grew "
                    f'monotonically over {self._mem_run_len} samples '
                    f'({start:.4g} -> {b:.4g} bytes_in_use, '
                    f'+{grown * 100:.1f}%) — leak signature (resident '
                    'K-FAC state should be flat after warmup)'))
                self._mem_latched = True
        self._mem_prev = b
        return events

    def _act(self, event: str) -> None:
        if self.action == 'raise':
            raise HealthError(event)
        if self.action == 'warn':
            # stacklevel: warn -> _act -> _record -> observe -> caller,
            # so the warning names whoever fed the record in.
            warnings.warn(f'KFAC health: {event}', RuntimeWarning,
                          stacklevel=4)

    def summary(self) -> dict:
        """Run-level health summary.

        ``by_kind`` counts events per check kind ('step_spike' /
        'nonfinite' / 'factor_stale' / 'damping' / 'eig_floor' /
        'memory_growth'); ``report --json`` carries it as
        ``health_event_counts``.
        """
        by_kind: dict[str, int] = {}
        for kind in self.event_kinds:
            by_kind[kind] = by_kind.get(kind, 0) + 1
        return {'events': len(self.events),
                'by_kind': by_kind,
                'nonfinite_skips': int(self._nonfinite_skips),
                'last_damping': self._last_damping}
