"""Declarative knob search space for the autotuner (PyTorch port of
``distributed_kfac_pytorch_tpu/autotune/space.py``; pure Python, so the
port keeps its own copy).

The tunable surface is the set of :class:`OptimConfig` fields of
``training.optimizers.TUNABLE_FIELDS``: precondition compute dtype, the
pipelined-firing chunk count, factor cadence and batch fraction, storage
dtypes and the schedule knobs. A :class:`SearchSpace` is a list of
:class:`Knob` value sets plus :class:`Constraint` validity predicates over
the *merged* config (base OptimConfig values overlaid with a candidate
assignment): the constraints the runtime enforces at construction time
(``inv_pipeline_chunks`` must divide ``kfac_inv_update_freq``, say),
checked here so invalid candidates are pruned before a probe is paid for
them.

Two pruners keep the space tractable beyond plain Cartesian enumeration:

  - :func:`coordinate_descent`: sweep one knob at a time from the base
    config, keeping the best value per knob: O(sum of value counts)
    probes instead of O(product).
  - :func:`successive_halving`: evaluate every candidate on a short probe,
    keep the best half, double the probe length, repeat (the budgeted
    racing scheme; cf. KAISA's per-workload tradeoff sweep,
    arXiv:2107.01739).

Both treat ``evaluate`` as a black box returning a score (lower is
better) or ``None`` (disqualified: invalid construction, non-finite
trips; see :mod:`autotune.score`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable config field and its candidate values."""
    name: str
    values: tuple
    doc: str = ''

    def __post_init__(self):
        if not self.values:
            raise ValueError(f'knob {self.name!r} has no values')


@dataclasses.dataclass(frozen=True)
class Constraint:
    """Validity predicate over a merged (base + assignment) config."""
    doc: str
    fn: Callable[[dict], bool]

    def ok(self, cfg: dict) -> bool:
        try:
            return bool(self.fn(cfg))
        except (KeyError, TypeError, ZeroDivisionError):
            # A constraint that cannot even evaluate over this config
            # marks it invalid rather than silently passing it.
            return False


def _divides_inv_freq(cfg: dict) -> bool:
    k = int(cfg.get('inv_pipeline_chunks', 1))
    freq = int(cfg.get('kfac_inv_update_freq', 0))
    return k >= 1 and (k == 1 or (freq > 0 and freq % k == 0))


def _staleness_fits_window(cfg: dict) -> bool:
    # inv_staleness=1 fires chunk j at phase j*stride+1, which needs
    # inv_update_freq/inv_pipeline_chunks >= 2 (the KFAC constructor's
    # constraint).
    if int(cfg.get('inv_staleness', 0) or 0) == 0:
        return True
    k = max(1, int(cfg.get('inv_pipeline_chunks', 1)))
    freq = int(cfg.get('kfac_inv_update_freq', 0))
    return freq > 0 and freq % k == 0 and freq // k >= 2


def _bf16_dispatch_supported(cfg: dict) -> bool:
    # bf16 precondition operands need an inverse method whose
    # preconditioning threads precond_compute_dtype.
    if not cfg.get('bf16_precond'):
        return True
    return cfg.get('inverse_method') in (
        None, 'auto', 'eigen', 'cholesky', 'newton')


def _lowrank_rank_valid(cfg: dict) -> bool:
    # The runtime constraint is rank < every ENGAGED dim; engaged dims are
    # >= inv_lowrank_dim_threshold, so rank < threshold is the
    # config-level proxy that holds on any model. rank 0 = knob off.
    rank = int(cfg.get('inv_lowrank_rank', 0) or 0)
    if rank == 0:
        return True
    thr = int(cfg.get('inv_lowrank_dim_threshold', 2048) or 0)
    return rank > 0 and thr >= 2 and rank < thr


#: constraints every candidate must satisfy regardless of the space.
BASE_CONSTRAINTS = (
    Constraint('inv_lowrank_rank must be 0 (off) or positive and '
               'below inv_lowrank_dim_threshold (>= 2), so the rank '
               'is below every engaged factor dim',
               _lowrank_rank_valid),
    Constraint('inv_pipeline_chunks must divide kfac_inv_update_freq',
               _divides_inv_freq),
    Constraint('bf16_precond requires a dispatch branch that supports '
               'precond_compute_dtype', _bf16_dispatch_supported),
    Constraint('factor_batch_fraction must be in (0, 1]',
               lambda c: 0.0 < float(c.get('factor_batch_fraction',
                                           1.0)) <= 1.0),
    Constraint('kfac_cov_update_freq must be >= 1',
               lambda c: int(c.get('kfac_cov_update_freq', 1)) >= 1),
    Constraint("kfac_approx must be 'expand' or 'reduce'",
               lambda c: c.get('kfac_approx', 'expand') in ('expand',
                                                            'reduce')),
    Constraint('inv_staleness must be 0 or 1',
               lambda c: int(c.get('inv_staleness', 0) or 0) in (0, 1)),
    Constraint('inv_staleness=1 needs kfac_inv_update_freq/'
               'inv_pipeline_chunks >= 2', _staleness_fits_window),
    Constraint('deferred_factor_reduction must be a bool',
               lambda c: isinstance(
                   c.get('deferred_factor_reduction', False), bool)),
)


class SearchSpace:
    """An ordered set of knobs plus validity constraints."""

    def __init__(self, knobs: Sequence[Knob],
                 constraints: Sequence[Constraint] = ()):
        names = [k.name for k in knobs]
        if len(set(names)) != len(names):
            raise ValueError(f'duplicate knob names: {names}')
        self.knobs = tuple(knobs)
        self.constraints = tuple(BASE_CONSTRAINTS) + tuple(constraints)

    def violations(self, base: dict, assignment: dict) -> list[str]:
        """Docs of every constraint the merged config violates."""
        cfg = {**base, **assignment}
        return [c.doc for c in self.constraints if not c.ok(cfg)]

    def enumerate(self, base: dict) -> list[dict]:
        """Cartesian product of knob values, constraint-filtered, in a
        deterministic order (knob declaration order, value order), so a
        candidate table is reproducible run to run."""
        out = []
        for combo in itertools.product(*(k.values for k in self.knobs)):
            assignment = dict(zip((k.name for k in self.knobs), combo))
            if not self.violations(base, assignment):
                out.append(assignment)
        return out


def default_space(overrides: dict[str, Sequence] | None = None
                  ) -> SearchSpace:
    """The stock knob set (mesh-shaping knobs excluded: they stay flags).

    ``overrides`` replaces a knob's value list (``{'name': [v, ...]}``);
    an empty/None entry drops the knob from the space entirely.
    """
    stock = [
        Knob('bf16_precond', (False, True),
             'bf16 precondition-contraction operands (K3 bf16 mode)'),
        Knob('inv_pipeline_chunks', (1, 2),
             'pipelined inverse firing chunk count'),
        Knob('factor_batch_fraction', (1.0, 0.5),
             'fraction of the batch used for factor statistics'),
        Knob('kfac_cov_update_freq', (1, 2),
             'factor-statistics update cadence'),
        Knob('kfac_approx', ('expand', 'reduce'),
             'weight-sharing Kronecker approximation: reduce collapses '
             'the shared sequence/patch axis before the covariance '
             '(cheaper factor updates on transformer/ViT workloads, a '
             'no-op elsewhere)'),
        Knob('deferred_factor_reduction', (False, True),
             'deferred window-boundary factor reduction: one bucketed '
             'collective per cadence window instead of one per factor '
             'step; exact by EMA linearity'),
        Knob('inv_staleness', (0, 1),
             'one-window-stale off-critical-path inverses: chunk firings '
             'of the frozen window-head snapshot across plain steps'),
        Knob('inv_lowrank_rank', (0, 128),
             'randomized truncated-eigendecomposition rank for large '
             'factor dims (arXiv:2206.15397): engages only on dims >= '
             'inv_lowrank_dim_threshold, a no-op on workloads without '
             'transformer-scale factors'),
        Knob('fused_factor_contraction', (False, True),
             'the factor contraction + EMA kernel (K1) against stock '
             'torch'),
        Knob('fused_precondition', (False, True),
             'the bucketed precondition + KL-clip v.g kernel (K3) '
             'against stock torch'),
    ]
    if overrides:
        unknown = set(overrides) - {k.name for k in stock}
        if unknown:
            raise ValueError(f'unknown knob override(s): '
                             f'{sorted(unknown)}')
        out = []
        for k in stock:
            if k.name in overrides:
                vals = tuple(overrides[k.name])
                if not vals:
                    continue  # dropped from the space
                k = Knob(k.name, vals, k.doc)
            out.append(k)
        stock = out
    return SearchSpace(stock)


# ---------------------------------------------------------------------------
# Pruners
# ---------------------------------------------------------------------------

def coordinate_descent(space: SearchSpace, base: dict,
                       evaluate: Callable[[dict], float | None],
                       *, rounds: int = 1
                       ) -> tuple[dict, list[dict]]:
    """One-knob-at-a-time descent from the base config.

    Each round sweeps every knob in declaration order, fixing the best
    value found so far before moving to the next knob. ``evaluate``
    returns a score (lower is better) or None (disqualified). Returns
    ``(best_assignment, table)``; the table rows carry every evaluated
    assignment with its score (memoized: an assignment is never probed
    twice).
    """
    current = {k.name: base.get(k.name, k.values[0])
               for k in space.knobs}
    cache: dict[tuple, float | None] = {}
    table: list[dict] = []

    def score_of(assignment: dict) -> float | None:
        key = tuple(sorted(assignment.items()))
        if key not in cache:
            if space.violations(base, assignment):
                cache[key] = None
            else:
                cache[key] = evaluate(assignment)
            table.append({'knobs': dict(assignment),
                          'score': cache[key]})
        return cache[key]

    best_score = score_of(dict(current))
    for _ in range(max(1, rounds)):
        improved = False
        for knob in space.knobs:
            for value in knob.values:
                cand = {**current, knob.name: value}
                s = score_of(cand)
                if s is not None and (best_score is None
                                      or s < best_score):
                    current, best_score, improved = cand, s, True
        if not improved:
            break
    return dict(current), table


def successive_halving(candidates: Sequence[dict],
                       evaluate: Callable[[dict, int], float | None],
                       *, min_steps: int, max_steps: int, eta: int = 2
                       ) -> tuple[dict | None, list[dict]]:
    """Budgeted racing: short probes for everyone, longer for survivors.

    ``evaluate(candidate, steps)`` probes a candidate for ``steps`` steps.
    Each rung keeps the best ``1/eta`` fraction (at least one) and
    multiplies the probe length by ``eta`` until ``max_steps`` is reached
    or one candidate remains. Returns ``(best, table)``; best is None when
    every candidate was disqualified at the first rung.
    """
    if eta < 2:
        raise ValueError(f'{eta=} must be >= 2')
    alive = [dict(c) for c in candidates]
    table: list[dict] = []
    steps = max(1, int(min_steps))
    while alive:
        scored = []
        for cand in alive:
            s = evaluate(cand, steps)
            table.append({'knobs': dict(cand), 'score': s,
                          'steps': steps})
            if s is not None:
                scored.append((s, cand))
        scored.sort(key=lambda x: x[0])
        if not scored:
            return None, table
        if len(scored) == 1 or steps >= max_steps:
            return scored[0][1], table
        keep = max(1, len(scored) // eta)
        alive = [c for _, c in scored[:keep]]
        steps = min(steps * eta, int(max_steps))
    return None, table
