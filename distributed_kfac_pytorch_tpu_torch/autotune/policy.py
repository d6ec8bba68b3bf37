"""The first dynamic in-run policy: straggler-aware cadence backoff
(PyTorch port of ``distributed_kfac_pytorch_tpu/autotune/policy.py``;
pure Python).

The barrier probe (``observability.stragglers.build_barrier_probe``)
measures, per sampled step, how long a rank waits for the rest of the
world before its next collective can proceed. Sustained skew means some
rank is slower than the cadence assumes, and every factor update then
*adds* synchronous collective work (the factor ``all_reduce``) on top of
the wait. The backoff stretches the factor-update cadence while the skew
persists and relaxes it back when the world recovers, trading factor
freshness for step time inside a bounded envelope (*Smart Parallelism*,
arXiv:2107.06533, makes the same trade explicit).

The engine's cadence drives the K-FAC stage flags from the host step
counter (``engine.cadence_flags``); the policy only ever turns a
scheduled ``factor_update=True`` into ``False``. It never touches
``inv_update`` / ``inv_chunk`` (the inverse pipeline's phases stay; the
inverses decompose the freshest factors there are) or the deferred
reduction's ``factor_reduce`` and the stale schedule's
``factor_snapshot``, and never suppresses step 0 (the first firing every
slot depends on).

Off by default: ``--cadence-backoff`` absent is the unchanged path, and
an armed policy that never sees skew above its threshold passes the flags
through untouched, bit for bit.

Every stretch / relax decision queues an ``autotune_backoff`` event the
engine drains into the metrics stream; ``observability.report`` renders
them in its autotune section.
"""

from __future__ import annotations

import dataclasses

#: queue bound for decision events awaiting a sink drain: a run wired
#: without --kfac-metrics has no drain, and a mesh oscillating around
#: the threshold emits stretch/relax pairs indefinitely — keep the
#: newest window instead of growing without bound.
MAX_PENDING_EVENTS = 256


@dataclasses.dataclass(frozen=True)
class BackoffConfig:
    """Envelope for the cadence backoff (all host-side).

    ``skew_threshold_ms``: barrier wait above this counts as skew.
    ``sustain_steps``: consecutive skewed steps before stretching.
    ``recover_steps``: consecutive calm steps before relaxing.
    ``max_stretch``: the bound — the effective factor interval never
    exceeds ``max_stretch *`` the scheduled one (factor staleness is
    bounded, the convergence contract the envelope exists for).
    """
    skew_threshold_ms: float = 5.0
    sustain_steps: int = 8
    recover_steps: int = 32
    max_stretch: int = 4

    def __post_init__(self):
        if self.skew_threshold_ms < 0:
            raise ValueError(f'{self.skew_threshold_ms=} must be >= 0')
        if self.sustain_steps < 1 or self.recover_steps < 1:
            raise ValueError('sustain_steps/recover_steps must be >= 1')
        if self.max_stretch < 1:
            raise ValueError(f'{self.max_stretch=} must be >= 1')


class StragglerCadencePolicy:
    """Stateful per-run backoff controller (one per training process).

    The engine calls :meth:`adjust` once per step with the step's cadence
    flags and the measured barrier wait (None when no probe is wired or
    the step is not sampled: the policy then only applies its current
    stretch) and drains :attr:`pending_events` into the metrics sink.
    Deterministic: decisions depend only on the wait sequence. Under a
    process group the ranks' own waits differ (the slow rank waits ~0),
    and a rank that suppressed a factor step would skip that step's
    factor ``all_reduce`` while the others enter it; so the engine feeds
    every rank the world's maximum of the ranks' waits on each sampled
    step, and every rank makes the same schedule.
    """

    def __init__(self, config: BackoffConfig | None = None):
        self.config = config or BackoffConfig()
        self.stretch = 1
        self.pending_events: list[dict] = []
        self._above = 0
        self._below = 0
        self._sched = 0       # scheduled factor firings seen (step>0)
        self._suppressed = 0

    def _observe(self, step: int, wait_ms: float) -> None:
        cfg = self.config
        if wait_ms > cfg.skew_threshold_ms:
            self._above += 1
            self._below = 0
            if (self._above >= cfg.sustain_steps
                    and self.stretch < cfg.max_stretch):
                self.stretch = min(self.stretch * 2, cfg.max_stretch)
                self._above = 0
                self.pending_events.append({
                    'event': 'autotune_backoff', 'action': 'stretch',
                    'stretch': self.stretch, 'step': int(step),
                    'skew_ms': float(wait_ms)})
        else:
            self._below += 1
            self._above = 0
            if self._below >= cfg.recover_steps and self.stretch > 1:
                self.stretch //= 2
                self._below = 0
                self.pending_events.append({
                    'event': 'autotune_backoff', 'action': 'relax',
                    'stretch': self.stretch, 'step': int(step),
                    'skew_ms': float(wait_ms)})

    def adjust(self, step: int, flags: dict,
               wait_ms: float | None) -> dict:
        """Apply the current stretch to one step's cadence flags."""
        if wait_ms is not None:
            self._observe(step, float(wait_ms))
            if len(self.pending_events) > MAX_PENDING_EVENTS:
                del self.pending_events[:-MAX_PENDING_EVENTS]
        if not flags.get('factor_update') or step == 0:
            return flags
        idx = self._sched
        self._sched += 1
        if self.stretch > 1 and idx % self.stretch != 0:
            self._suppressed += 1
            flags = dict(flags)
            flags['factor_update'] = False
        return flags

    def drain_events(self) -> list[dict]:
        events, self.pending_events = self.pending_events, []
        return events

    @property
    def suppressed_firings(self) -> int:
        return self._suppressed
