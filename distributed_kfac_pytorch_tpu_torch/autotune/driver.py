"""Autotune driver: probe -> score -> commit a tuned-config artifact
(PyTorch port of ``distributed_kfac_pytorch_tpu/autotune/driver.py``).

    python -m distributed_kfac_pytorch_tpu_torch.autotune \\
        --workload cifar_resnet20 --out TUNED_cifar_resnet20.json

Enumerates the knob space (:mod:`autotune.space`), probes each candidate
through short warm segments (:mod:`autotune.probe`), ranks them on the
gate metrics (:mod:`autotune.score`), re-probes the winner as a
reproducibility self-check, and writes the per-workload artifact
``TUNED_<workload>.json`` in the JAX package's format:

  {"format": "kfac-autotune-v1", "workload": ..., "platform": "gpu",
   "topology": {topo_* ints}, "sink_schema": 4,
   "best": {knob: value}, "best_score": ..., "objective": ...,
   "candidates": [{knobs, metrics, score, disqualified}, ...],
   "self_check": {...}, "probe": {...}, "created_unix": ...}

The platform is JAX's name for the run's device (``'gpu'`` for CUDA,
``'cpu'``), so an artifact of either package loads under the same rules in
both. The best candidate's recorded probe stream lands next to the
artifact as ``<out>.probe.jsonl``.

Under a process group every rank runs :func:`tune` and probes each
candidate at once (the steps are collective); rank 0's probe results are
broadcast and stand for the world's, so every rank scores, prunes and
picks alike, and rank 0 alone writes the artifact.

Loading is **fail-closed** (:func:`load_tuned_config`): an unreadable /
torn / wrong-format artifact, a platform mismatch, a topology (world
size) mismatch, or a knob outside ``TUNABLE_FIELDS`` all fall back to
the defaults and queue exactly one ``autotune_fallback`` event for the
metrics stream; a clean load queues one ``autotune_apply`` event. The
CLIs consume this via ``--tuned-config`` (:mod:`autotune.cli`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

ARTIFACT_FORMAT = 'kfac-autotune-v1'


# ---------------------------------------------------------------------------
# Artifact IO + fail-closed loading
# ---------------------------------------------------------------------------

def tuned_path(workload: str) -> str:
    return f'TUNED_{workload}.json'


def write_tuned(path: str, obj: dict) -> dict:
    obj = {'format': ARTIFACT_FORMAT, **obj}
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write('\n')
    return obj


def read_tuned(path: str) -> dict:
    """Strict artifact read; raises on any problem (fail-closed consumers
    use :func:`load_tuned_config`)."""
    with open(path) as f:
        obj = json.load(f)
    if obj.get('format') != ARTIFACT_FORMAT:
        raise ValueError(f'{path}: not a {ARTIFACT_FORMAT} file '
                         f'(format={obj.get("format")!r})')
    if not isinstance(obj.get('best'), dict):
        raise ValueError(f'{path}: artifact has no best-knobs object')
    return obj


def platform_of(device) -> str:
    """The artifact's platform name for a run on ``device``: JAX's
    backend names, ``'gpu'`` for a CUDA device and ``'cpu'`` for the CPU
    (from the run's device, not from whether a card is present)."""
    import torch
    kind = torch.device(device).type
    return 'gpu' if kind == 'cuda' else kind


def live_world() -> dict:
    """The world-size slice of the live topology: the process group's size
    for both counts (a rank is a process, as
    ``elastic.TopologySpec.of_world`` records it), 1/1 without one. Read
    it after the process group is up."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {'devices': int(world), 'processes': int(world)}


def load_tuned_config(path: str, *, platform: str | None = None,
                      world: dict | None = None
                      ) -> tuple[dict | None, list[dict]]:
    """Fail-closed artifact load: ``(knobs | None, events)``.

    ``platform`` is :func:`platform_of` the run's device; ``world`` is
    :func:`live_world` (or a checkpoint ``TopologySpec``'s process/device
    counts). Validation compares the artifact's recorded platform and
    ``topo_devices``/``topo_processes``/``topo_seq`` world scalars: the
    tuning evidence only transfers within the world it was measured on.
    The KAISA grid scalars (``topo_rows``/``topo_cols``) are provenance,
    not preconditions: the tuned knob set cannot touch the grid
    (``TUNABLE_FIELDS``).

    Every outcome queues exactly one event dict (``autotune_fallback``
    with a ``reason``, or ``autotune_apply``); flush them into a metrics
    sink with :func:`emit_events` once one exists.
    """
    from distributed_kfac_pytorch_tpu_torch.training.optimizers import \
        TUNABLE_FIELDS

    def fallback(reason: str, **data) -> tuple[None, list[dict]]:
        return None, [{'event': 'autotune_fallback', 'path': str(path),
                       'reason': reason, **data}]

    try:
        obj = read_tuned(path)
    except FileNotFoundError:
        return fallback('missing')
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return fallback('unreadable', error=str(e)[:200])

    if platform is not None:
        recorded = obj.get('platform')
        if recorded != platform:
            return fallback('platform_mismatch',
                            artifact=str(recorded), live=str(platform))
    topo = obj.get('topology') or {}
    if world is not None:
        for live_key, topo_key, default in (
                ('devices', 'topo_devices', None),
                ('processes', 'topo_processes', None),
                ('seq', 'topo_seq', 1)):
            if live_key not in world:
                continue
            recorded = topo.get(topo_key, default)
            if recorded is None or int(recorded) != int(world[live_key]):
                return fallback('topology_mismatch', key=topo_key,
                                artifact=-1 if recorded is None
                                else int(recorded),
                                live=int(world[live_key]))
    knobs = dict(obj['best'])
    unknown = sorted(set(knobs) - set(TUNABLE_FIELDS))
    if unknown:
        return fallback('unknown_knobs', knobs=','.join(unknown))
    return knobs, [{'event': 'autotune_apply', 'path': str(path),
                    'workload': str(obj.get('workload')),
                    'knobs': json.dumps(knobs, sort_keys=True)}]


def apply_tuned(cfg, knobs: dict) -> tuple:
    """Overlay tuned knobs on an ``OptimConfig``: ``(new_cfg, error)``.

    ``error`` is non-None when the MERGED config violates a validity
    constraint (the artifact tuned ``inv_pipeline_chunks`` against another
    ``--kfac-update-freq`` than the CLI now runs, say): the caller falls
    back to the un-tuned config, fail-closed.
    """
    from distributed_kfac_pytorch_tpu_torch.autotune import space as \
        space_mod
    from distributed_kfac_pytorch_tpu_torch.training.optimizers import \
        TUNABLE_FIELDS
    unknown = sorted(set(knobs) - set(TUNABLE_FIELDS))
    if unknown:
        return cfg, f'unknown knob(s) {unknown}'
    new_cfg = dataclasses.replace(cfg, **knobs)
    merged = dataclasses.asdict(new_cfg)
    violated = [c.doc for c in space_mod.BASE_CONSTRAINTS
                if not c.ok(merged)]
    if violated:
        return cfg, '; '.join(violated)
    return new_cfg, None


def emit_events(sink, events: list[dict]) -> None:
    """Flush queued autotune events into a metrics sink (None ok)."""
    if sink is None:
        return
    emit = getattr(sink, 'event_record', None)
    if emit is None:
        return
    for ev in events:
        emit(ev['event'], **{k: v for k, v in ev.items()
                             if k != 'event'})


def kfac_overrides(knobs: dict) -> tuple[dict, int | None, list[str]]:
    """Map tuned OptimConfig knobs to raw ``KFAC(...)`` keywords, for a
    consumer that builds a bare ``KFAC`` instead of going through
    ``get_optimizer``. Returns ``(kwargs, inv_update_freq, ignored)``:
    ``ignored`` lists knobs such a harness cannot express (the engine's
    schedule knobs), surfaced rather than silently dropped.

    The JAX mapping with torch dtypes in JAX's place. One delta: the
    port's ``KFAC`` defaults ``fused_factor_contraction`` and
    ``fused_precondition`` on (the JAX package off), so both pass through
    with their value, False included.
    """
    import torch
    kwargs: dict = {}
    inv_freq = None
    ignored: list[str] = []
    for name, value in knobs.items():
        if name == 'bf16_precond':
            if value:
                kwargs['precond_compute_dtype'] = torch.bfloat16
        elif name == 'bf16_factors':
            if value:
                kwargs['factor_dtype'] = torch.bfloat16
                kwargs['factor_compute_dtype'] = torch.bfloat16
        elif name == 'bf16_inverses':
            if value:
                kwargs['inv_dtype'] = torch.bfloat16
        elif name == 'factor_batch_fraction':
            kwargs['factor_batch_fraction'] = float(value)
        elif name == 'eigh_polish_iters':
            kwargs['eigh_polish_iters'] = int(value)
        elif name == 'kfac_approx':
            kwargs['kfac_approx'] = str(value)
        elif name == 'inv_lowrank_rank':
            kwargs['inv_lowrank_rank'] = int(value)
        elif name == 'inv_lowrank_dim_threshold':
            kwargs['inv_lowrank_dim_threshold'] = int(value)
        elif name in ('fused_factor_contraction', 'fused_precondition'):
            kwargs[name] = bool(value)
        elif name == 'kfac_inv_update_freq':
            inv_freq = int(value)
        elif name in ('deferred_factor_reduction', 'inv_staleness',
                      'hierarchical_reduce'):
            # Engine-scheduled knobs (the window-boundary reduce, the
            # frozen-snapshot chunk phases, the two-level reduce of a
            # multi-slice world): a bare-KFAC harness that fires
            # monolithically has no factor_reduce / factor_snapshot
            # schedule, so constructing with them on would leave the
            # accumulator un-reduced forever.
            if value:
                ignored.append(name)
        else:
            ignored.append(name)
    return kwargs, inv_freq, sorted(ignored)


# ---------------------------------------------------------------------------
# The tuning run
# ---------------------------------------------------------------------------

def _agreed(obj):
    """Rank 0's ``obj`` on every rank of a process group (``obj`` itself
    in a process alone)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def tune(workload_name: str, *, out: str | None = None,
         steps: int = 8, warmup_windows: int = 2,
         inv_update_freq: int = 4, cov_update_freq: int = 1,
         objective: str = 'weighted', hbm_ceiling: float | None = None,
         max_candidates: int | None = None, pruner: str = 'auto',
         space_overrides: dict | None = None, seed: int = 0,
         self_check: bool = True, self_check_tol: float = 0.75,
         device='cuda', log=print) -> dict:
    """Run the probe -> score -> commit loop; returns the artifact (on
    every rank; rank 0 writes it)."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import elastic, resolve_device
    from distributed_kfac_pytorch_tpu_torch.autotune import probe as \
        probe_mod
    from distributed_kfac_pytorch_tpu_torch.autotune import score as \
        score_mod
    from distributed_kfac_pytorch_tpu_torch.autotune import space as \
        space_mod
    from distributed_kfac_pytorch_tpu_torch.observability.sink import \
        SCHEMA_VERSION
    from distributed_kfac_pytorch_tpu_torch.training import optimizers

    device = resolve_device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank != 0:
        log = lambda *a, **k: None  # noqa: E731
    workload = probe_mod.get_workload(workload_name)
    out = out or tuned_path(workload_name)
    base_cfg = optimizers.OptimConfig(
        kfac_inv_update_freq=int(inv_update_freq),
        kfac_cov_update_freq=int(cov_update_freq))
    base = {f: getattr(base_cfg, f) for f in optimizers.TUNABLE_FIELDS}
    if (not workload.weight_shared
            and 'kfac_approx' not in (space_overrides or {})):
        # No weight-shared layers: 'reduce' resolves to the same step as
        # 'expand', and probing both would double the table for nothing.
        # An explicit override still wins.
        space_overrides = {**(space_overrides or {}),
                           'kfac_approx': ['expand']}
        log(f'autotune[{workload_name}]: kfac_approx knob dropped '
            '(workload has no weight-shared layers; reduce == expand)')
    if (workload.max_factor_dim
            and workload.max_factor_dim
            < base_cfg.inv_lowrank_dim_threshold
            and 'inv_lowrank_rank' not in (space_overrides or {})):
        # No factor dim can reach the engagement threshold: every rank
        # value runs the exact path. An explicit override wins.
        space_overrides = {**(space_overrides or {}),
                           'inv_lowrank_rank': [0]}
        log(f'autotune[{workload_name}]: inv_lowrank_rank knob '
            f'dropped (max factor dim {workload.max_factor_dim} < '
            f'threshold {base_cfg.inv_lowrank_dim_threshold}; the '
            'low-rank path cannot engage)')
    space = space_mod.default_space(space_overrides)

    candidates = space.enumerate(base)
    dropped = 0
    if max_candidates is not None and len(candidates) > max_candidates:
        dropped = len(candidates) - max_candidates
        candidates = candidates[:max_candidates]
    log(f'autotune[{workload_name}]: {len(candidates)} candidate(s)'
        + (f' ({dropped} dropped by --max-candidates)' if dropped
           else '') + f', probe {steps} step(s) @ '
        f'f{cov_update_freq}/i{inv_update_freq}, '
        f'objective={objective}')

    def run_probe(knobs: dict, n_steps: int,
                  keep: str | None = None) -> probe_mod.ProbeResult:
        r = probe_mod.probe_candidate(
            workload, base_cfg, knobs, steps=n_steps,
            warmup_windows=warmup_windows, seed=seed,
            keep_stream=keep if rank == 0 else None, device=device)
        return _agreed(r)

    # Probe scores are only comparable at EQUAL probe length (a probe
    # starts on a firing step, so the firing-spike fraction in the
    # percentiles scales with 1/steps): the committed winner is picked
    # among full-length probes only. Shorter-rung rows stay in the
    # artifact's table as provenance (their metrics carry n_steps).
    results: list[probe_mod.ProbeResult] = []

    def pruner_eval(knobs, n_steps):
        r = run_probe(knobs, n_steps)
        results.append(r)
        reason = score_mod.hard_violation(r, hbm_ceiling=hbm_ceiling)
        if reason is not None:
            return None
        return score_mod.objective_value(r.metrics, objective)

    if pruner == 'auto':
        pruner = 'full' if len(candidates) <= 8 else 'halving'
    if pruner == 'full':
        for knobs in candidates:
            r = run_probe(knobs, steps)
            results.append(r)
            log(f'  probe {json.dumps(knobs, sort_keys=True)}: '
                + (f'DISQUALIFIED ({r.disqualified})'
                   if r.disqualified else
                   f"p50 {r.metrics.get('step_p50_ms'):.3g} ms"))
    elif pruner == 'halving':
        winner, _ = space_mod.successive_halving(
            candidates, pruner_eval, min_steps=max(2, steps // 4),
            max_steps=steps)
        if winner is not None and not any(
                r.knobs == winner
                and r.metrics.get('n_steps', 0) >= steps
                for r in results):
            # The last rung may have raced below the full budget.
            results.append(run_probe(winner, steps))
    elif pruner == 'coordinate':
        winner, _ = space_mod.coordinate_descent(
            space, base, lambda knobs: pruner_eval(knobs, steps))
    else:
        raise ValueError(f'unknown pruner {pruner!r}')

    full_length = [r for r in results
                   if r.disqualified is not None
                   or r.metrics.get('n_steps', 0) >= steps]
    ranked = score_mod.rank_candidates(full_length or results,
                                       objective=objective,
                                       hbm_ceiling=hbm_ceiling)
    best = next((r for r in ranked if r['disqualified'] is None), None)
    if best is None:
        all_rows = score_mod.rank_candidates(
            results, objective=objective, hbm_ceiling=hbm_ceiling)
        raise SystemExit(
            f'autotune[{workload_name}]: every candidate was '
            'disqualified — nothing to commit. Reasons: '
            + '; '.join(sorted({r['disqualified'] for r in all_rows
                                if r['disqualified']})))
    table = score_mod.rank_candidates(results, objective=objective,
                                      hbm_ceiling=hbm_ceiling)

    # Reproducibility self-check: re-probe the winner (fresh build, same
    # seed) and keep its recorded stream as the artifact's evidence.
    check: dict = {'enabled': bool(self_check)}
    stream_path = out + '.probe.jsonl'
    rescore = run_probe(best['knobs'], steps, keep=stream_path)
    if self_check:
        reason = score_mod.hard_violation(rescore,
                                          hbm_ceiling=hbm_ceiling)
        if reason is not None:
            check.update({'pass': False, 'reason': reason})
        else:
            s2 = score_mod.objective_value(rescore.metrics, objective)
            ok = score_mod.scores_close(best['score'], s2,
                                        self_check_tol)
            check.update({
                'pass': bool(ok), 'tol': self_check_tol,
                'rescore': list(s2) if isinstance(s2, tuple) else s2,
                'rescore_metrics': rescore.metrics})
        shown = {k: v for k, v in check.items() if k != 'rescore_metrics'}
        log(f"  self-check: {'PASS' if check.get('pass') else 'FAIL'} "
            f'({json.dumps(shown, sort_keys=True)})')

    def _json_score(s):
        return list(s) if isinstance(s, tuple) else s

    artifact = {
        'format': ARTIFACT_FORMAT,
        'created_unix': int(time.time()),
        'workload': workload_name,
        'platform': platform_of(device),
        'topology': (rescore.topology
                     or elastic.TopologySpec.of_world().scalars()),
        'sink_schema': SCHEMA_VERSION,
        'objective': objective,
        'base': {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in base.items()},
        'best': best['knobs'],
        'best_score': _json_score(best['score']),
        'best_metrics': best['metrics'],
        'candidates': [{**r, 'score': _json_score(r['score'])}
                       for r in table],
        'self_check': check,
        'probe': {'steps': int(steps),
                  'warmup_windows': int(warmup_windows),
                  'cov_update_freq': int(cov_update_freq),
                  'inv_update_freq': int(inv_update_freq),
                  'seed': int(seed), 'pruner': pruner,
                  'hbm_ceiling': hbm_ceiling,
                  'stream': stream_path},
    }
    if rank == 0:
        artifact = write_tuned(out, artifact)
    log(f'wrote {out}: best={json.dumps(best["knobs"], sort_keys=True)}'
        f' score={best["score"]}')
    return artifact


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_overrides(items: list[str]) -> dict:
    overrides = {}
    for item in items:
        name, _, raw = item.partition('=')
        vals = []
        for tok in filter(None, raw.split(',')):
            low = tok.lower()
            if low in ('true', 'false'):
                vals.append(low == 'true')
            else:
                try:
                    vals.append(int(tok))
                except ValueError:
                    vals.append(float(tok))
        overrides[name] = vals
    return overrides


def build_parser() -> argparse.ArgumentParser:
    from distributed_kfac_pytorch_tpu_torch.autotune import probe as \
        probe_mod
    from distributed_kfac_pytorch_tpu_torch.autotune import score as \
        score_mod
    p = argparse.ArgumentParser(
        prog='python -m distributed_kfac_pytorch_tpu_torch.autotune',
        description='Closed-loop perf autotuner: probe candidate configs '
                    'through short warm segments, score them on the gate '
                    'metrics, commit the winner as a per-workload '
                    'TUNED_<workload>.json the CLIs load via '
                    '--tuned-config (fail-closed).')
    p.add_argument('--workload', default='flagship_lm',
                   choices=sorted(probe_mod.WORKLOADS))
    p.add_argument('--out', default=None,
                   help='artifact path (default TUNED_<workload>.json; '
                        'the best probe stream lands at '
                        '<out>.probe.jsonl)')
    p.add_argument('--steps', type=int, default=8,
                   help='recorded probe steps per candidate')
    p.add_argument('--warmup-windows', type=int, default=2,
                   help='unrecorded cadence windows run before the '
                        'recorded segment')
    p.add_argument('--inv-update-freq', type=int, default=4,
                   help='probe inverse cadence (the recorded segment '
                        'covers steps/freq firing windows)')
    p.add_argument('--cov-update-freq', type=int, default=1)
    p.add_argument('--objective', default='weighted',
                   choices=score_mod.OBJECTIVES)
    p.add_argument('--hbm-ceiling', type=float, default=None,
                   metavar='BYTES',
                   help='hard-disqualify candidates whose probe peak '
                        'device memory exceeds this')
    p.add_argument('--max-candidates', type=int, default=None,
                   help='truncate the enumerated space (deterministic '
                        'order)')
    p.add_argument('--pruner', default='auto',
                   choices=['auto', 'full', 'halving', 'coordinate'],
                   help='auto = full enumeration up to 8 candidates, '
                        'successive halving beyond')
    p.add_argument('--set', action='append', default=[],
                   metavar='KNOB=V1,V2',
                   help="override a knob's value list, e.g. --set "
                        'inv_pipeline_chunks=1,2,4; an empty list '
                        '(KNOB=) drops the knob; repeatable')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--no-self-check', action='store_true',
                   help='skip the winner re-probe reproducibility check')
    p.add_argument('--self-check-tol', type=float, default=0.75,
                   help='max relative score drift between the two '
                        'winner probes')
    p.add_argument('--strict-self-check', action='store_true',
                   help='exit non-zero when the self-check fails '
                        '(default: record the failure in the artifact '
                        'and warn)')
    p.add_argument('--list', action='store_true',
                   help='print the constraint-filtered candidate table '
                        'and exit without probing')
    p.add_argument('--device', default='cuda',
                   help="the probes' device (cuda; cpu must be asked "
                        'for)')
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    overrides = _parse_overrides(args.set)
    if args.list:
        from distributed_kfac_pytorch_tpu_torch.autotune import space as \
            space_mod
        from distributed_kfac_pytorch_tpu_torch.training import optimizers
        base_cfg = optimizers.OptimConfig(
            kfac_inv_update_freq=args.inv_update_freq,
            kfac_cov_update_freq=args.cov_update_freq)
        base = {f: getattr(base_cfg, f) for f in optimizers.TUNABLE_FIELDS}
        for cand in space_mod.default_space(
                overrides or None).enumerate(base):
            print(json.dumps(cand, sort_keys=True))
        return 0

    from distributed_kfac_pytorch_tpu_torch import resolve_device, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.training import engine
    set_fp32_precision()
    device = resolve_device(args.device)
    engine.start_world(device)
    artifact = tune(
        args.workload, out=args.out, steps=args.steps,
        warmup_windows=args.warmup_windows,
        inv_update_freq=args.inv_update_freq,
        cov_update_freq=args.cov_update_freq,
        objective=args.objective, hbm_ceiling=args.hbm_ceiling,
        max_candidates=args.max_candidates, pruner=args.pruner,
        space_overrides=overrides or None, seed=args.seed,
        self_check=not args.no_self_check,
        self_check_tol=args.self_check_tol, device=device)
    check = artifact.get('self_check', {})
    if check.get('enabled') and not check.get('pass'):
        print('warning: self-check failed — the probe may be measuring '
              'noise; re-run with more --steps before committing this '
              'artifact', file=sys.stderr)
        if args.strict_self_check:
            return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
