"""Candidate ranking over the gate's metric vector (PyTorch port of
``distributed_kfac_pytorch_tpu/autotune/score.py``; pure Python).

Hard constraints first (a violated one disqualifies the candidate
regardless of its timings):

  - probe-level disqualification (invalid construction; the
    :mod:`autotune.probe` marks these);
  - ``retraces`` (the field is kept so the table reads across both
    packages; the port has no program variants and probes count 0);
  - any non-finite-guard trip during the probe (a config that produces
    non-finite factor statistics must never be auto-committed);
  - empty probe (no scored steps);
  - ``peak_hbm_bytes`` above an optional ceiling (the KAISA memory axis:
    a config that fits is a precondition, not a tradeoff; on the card the
    allocator's peak over the probe).

Then the objective, over the surviving candidates (lower is better):

  - ``weighted`` (default): ``0.7*p50 + 0.2*p95 + 0.1*p99`` ms, a
    composed step-time proxy. p50 is throughput (most steps are plain
    steps); p95/p99 weight the firing-spike tail the pipelined firing
    exists to flatten, so a candidate that buys median speed by
    concentrating spikes is penalized in proportion to how rarely the
    spikes land.
  - ``lexicographic``: p50 quantized to a 2% grain, then p99, then
    max/median: "fastest typical step wins; ties (within timing noise)
    break toward the flattest tail", the priority order of the gate's
    tolerances.

Both objectives are pure functions of the metric vector, so a committed
artifact's candidate table can be re-ranked offline without re-probing.
"""

from __future__ import annotations

import math

OBJECTIVES = ('weighted', 'lexicographic')
WEIGHTS = {'step_p50_ms': 0.7, 'step_p95_ms': 0.2, 'step_p99_ms': 0.1}
#: lexicographic p50 grain: two candidates within this relative band
#: tie on the primary key (probe timing noise floor).
LEXI_P50_GRAIN = 0.02


def hard_violation(result, *, hbm_ceiling: float | None = None
                   ) -> str | None:
    """The first hard constraint ``result`` (a ProbeResult or its
    ``to_row()`` dict) violates, or None."""
    row = result if isinstance(result, dict) else result.to_row()
    if row.get('disqualified'):
        return row['disqualified']
    if row.get('retraces'):
        return 'retraces: a static-cadence variant recompiled mid-probe'
    skips = row.get('nonfinite_skips') or 0.0
    if skips and skips > 0:
        return f'nonfinite_guard tripped {skips:g} time(s)'
    metrics = row.get('metrics') or {}
    if not metrics.get('n_steps'):
        return 'empty probe (no scored steps)'
    if metrics.get('step_p50_ms') is None:
        return 'no step-time samples in the probe stream'
    if hbm_ceiling is not None:
        peak = metrics.get('peak_hbm_bytes')
        if peak is not None and peak > hbm_ceiling:
            return (f'peak HBM {peak:g} B above ceiling '
                    f'{hbm_ceiling:g} B')
    return None


def objective_value(metrics: dict, objective: str = 'weighted'):
    """Reduce a gate metric vector to a comparable score.

    ``weighted`` returns a float; ``lexicographic`` returns a tuple
    (JSON-serialized as a list in artifacts). Both compare with ``<``.
    """
    if objective == 'weighted':
        return sum(w * float(metrics[k]) for k, w in WEIGHTS.items())
    if objective == 'lexicographic':
        p50 = float(metrics['step_p50_ms'])
        grain = max(p50 * LEXI_P50_GRAIN, 1e-9)
        spike = metrics.get('max_over_median')
        return (round(p50 / grain),
                round(float(metrics['step_p99_ms']), 6),
                round(float(spike), 6) if spike is not None
                else float('inf'))
    raise ValueError(f'unknown objective {objective!r} '
                     f'(one of {OBJECTIVES})')


def rank_candidates(results, *, objective: str = 'weighted',
                    hbm_ceiling: float | None = None) -> list[dict]:
    """Score + rank probe results; best first, disqualified last.

    Returns rows (``ProbeResult.to_row()`` shape) extended with
    ``score`` (None when disqualified) and ``disqualified`` set to the
    violated hard constraint. Ties keep probe order (stable sort), so
    the earlier-enumerated — more default-like — candidate wins.
    """
    rows = []
    for r in results:
        row = r if isinstance(r, dict) else r.to_row()
        row = dict(row)
        reason = hard_violation(row, hbm_ceiling=hbm_ceiling)
        if reason is not None:
            row['disqualified'] = reason
            row['score'] = None
        else:
            row['score'] = objective_value(row['metrics'], objective)
        rows.append(row)

    def key(row):
        if row['score'] is None:
            return (1, ())
        s = row['score']
        return (0, tuple(s) if isinstance(s, (tuple, list)) else (s,))

    return sorted(rows, key=key)


def scores_close(a, b, rel_tol: float) -> bool:
    """Are two objective values within ``rel_tol`` of each other?

    The driver's self-check: the best candidate re-probed must re-score
    within tolerance, or the probe was measuring noise. Lexicographic
    tuples compare on their p50 grain (first element).
    """
    av = a[0] if isinstance(a, (tuple, list)) else a
    bv = b[0] if isinstance(b, (tuple, list)) else b
    av, bv = float(av), float(bv)
    if not (math.isfinite(av) and math.isfinite(bv)):
        return False
    denom = max(abs(av), abs(bv), 1e-12)
    return abs(av - bv) / denom <= rel_tol
