"""The torch port's autotune surface against the JAX package's, on the CPU.

Pure functions, held to the JAX functions exactly on the same inputs: the
knob space and its constraints, both pruners under one scripted score, the
scorer, the fail-closed artifact load over a matrix of files (the
committed ``TUNED_flagship_lm.json`` included), ``apply_tuned``,
``kfac_overrides`` (torch dtypes in JAX's place) and the cadence policy's
flags and events over one wait sequence.

Then the six autotune flags, each through each of the three CLIs at a tiny
size (``--tuned-config`` overlays the artifact's knobs; ``--cadence-backoff``
alone has no barrier probe and changes nothing; each ``--backoff-*`` flag
shapes the schedule an injected wait sequence gives, step by step and in
the stream), and the engine under an armed policy: a suppressed factor
step against the deferred reduction, the stale schedule and gradient
accumulation, each run held bit for bit to the same steps driven with the
policy's flags by hand.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import jax.numpy as jnp
from distributed_kfac_pytorch_tpu.autotune import driver as jdriver
from distributed_kfac_pytorch_tpu.autotune import policy as jpolicy
from distributed_kfac_pytorch_tpu.autotune import score as jscore
from distributed_kfac_pytorch_tpu.autotune import space as jspace
from distributed_kfac_pytorch_tpu.training import optimizers as joptim
from distributed_kfac_pytorch_tpu_torch import autotune
from distributed_kfac_pytorch_tpu_torch.autotune import driver, policy, \
    probe, score, space
from distributed_kfac_pytorch_tpu_torch.observability import sink
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine, optimizers

from test_torch_obs_flags import CONFIGS

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / 'TUNED_flagship_lm.json'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _base(**kw) -> dict:
    """One base knob dict for both packages (the JAX OptimConfig's
    TUNABLE_FIELDS values at inverse cadence 4)."""
    cfg = joptim.OptimConfig(kfac_inv_update_freq=4)
    return {**{f: getattr(cfg, f) for f in joptim.TUNABLE_FIELDS}, **kw}


def test_tunable_fields_are_the_jax_fields():
    assert optimizers.TUNABLE_FIELDS == joptim.TUNABLE_FIELDS
    fields = {f.name for f in dataclasses.fields(optimizers.OptimConfig)}
    assert set(optimizers.TUNABLE_FIELDS) <= fields


# ---------------------------------------------------------------------------
# The space, its constraints and the pruners
# ---------------------------------------------------------------------------

OVERRIDES = [
    None,
    {'inv_pipeline_chunks': [1, 2, 3], 'factor_batch_fraction': [1.0],
     'kfac_cov_update_freq': [1], 'kfac_approx': ['expand'],
     'deferred_factor_reduction': [False], 'inv_staleness': [0],
     'inv_lowrank_rank': [0], 'fused_factor_contraction': [False],
     'fused_precondition': [False]},
    {'bf16_precond': [], 'inv_staleness': [0, 1],
     'inv_pipeline_chunks': [1, 2, 4], 'kfac_approx': [],
     'inv_lowrank_rank': [0, 64, 4096], 'fused_precondition': []},
    {'kfac_cov_update_freq': [1, 2], 'factor_batch_fraction': [1.0, 0.5],
     'inv_pipeline_chunks': [1, 2], 'bf16_precond': [],
     'kfac_approx': [], 'deferred_factor_reduction': [],
     'inv_staleness': [], 'inv_lowrank_rank': [],
     'fused_factor_contraction': [], 'fused_precondition': []},
]
BASES = [_base(), _base(kfac_inv_update_freq=3),
         _base(kfac_inv_update_freq=2, inverse_method='xla'),
         _base(inv_lowrank_dim_threshold=64)]


@pytest.mark.parametrize('overrides', range(len(OVERRIDES)))
def test_default_space_enumerates_as_jax(overrides):
    ov = OVERRIDES[overrides]
    ours, theirs = space.default_space(ov), jspace.default_space(ov)
    assert [(k.name, k.values) for k in ours.knobs] == \
        [(k.name, k.values) for k in theirs.knobs]
    for base in BASES:
        assert ours.enumerate(base) == theirs.enumerate(base)


def test_space_errors_as_jax():
    for mod in (space, jspace):
        with pytest.raises(ValueError, match='unknown knob override'):
            mod.default_space({'not_a_knob': [1]})
        with pytest.raises(ValueError, match='has no values'):
            mod.Knob('x', ())
        with pytest.raises(ValueError, match='duplicate'):
            mod.SearchSpace([mod.Knob('x', (1,)), mod.Knob('x', (2,))])


MERGED = [
    {}, {'inv_pipeline_chunks': 3, 'kfac_inv_update_freq': 4},
    {'inv_pipeline_chunks': 2, 'kfac_inv_update_freq': 4},
    {'inv_pipeline_chunks': 0}, {'bf16_precond': True,
                                 'inverse_method': 'jacobi'},
    {'bf16_precond': True, 'inverse_method': 'newton'},
    {'factor_batch_fraction': 0.0}, {'factor_batch_fraction': 1.5},
    {'factor_batch_fraction': 'x'}, {'kfac_cov_update_freq': 0},
    {'kfac_approx': 'both'}, {'inv_staleness': 2},
    {'inv_staleness': 1, 'kfac_inv_update_freq': 4,
     'inv_pipeline_chunks': 2},
    {'inv_staleness': 1, 'kfac_inv_update_freq': 4,
     'inv_pipeline_chunks': 4},
    {'deferred_factor_reduction': 1},
    {'inv_lowrank_rank': 128, 'inv_lowrank_dim_threshold': 64},
    {'inv_lowrank_rank': 32, 'inv_lowrank_dim_threshold': 64},
    {'inv_lowrank_rank': -1}, {'inv_lowrank_rank': 4,
                               'inv_lowrank_dim_threshold': 1},
]


def _verdict(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:        # a value no constraint can read
        return type(e)


def test_base_constraints_give_the_jax_verdicts():
    assert [c.doc for c in space.BASE_CONSTRAINTS] == \
        [c.doc for c in jspace.BASE_CONSTRAINTS]
    for cfg in MERGED:
        assert [_verdict(c.ok, cfg) for c in space.BASE_CONSTRAINTS] == \
            [_verdict(c.ok, cfg) for c in jspace.BASE_CONSTRAINTS], cfg
        base = _base()
        assert _verdict(space.SearchSpace([]).violations, base, cfg) == \
            _verdict(jspace.SearchSpace([]).violations, base, cfg)


def _scripted(knobs: dict, steps: int = 8):
    """A deterministic score of an assignment: None for some, lower for
    others, depending on the probe length too."""
    h = sum((i + 1) * (hash(str(v)) % 97) for i, (k, v) in
            enumerate(sorted(knobs.items()))) % 1000
    if h % 7 == 0:
        return None
    return h / 10.0 + 100.0 / steps


def test_coordinate_descent_as_jax():
    ov = {'bf16_precond': [False, True], 'inv_pipeline_chunks': [1, 2, 3],
          'factor_batch_fraction': [1.0, 0.5],
          'kfac_cov_update_freq': [1, 2], 'kfac_approx': ['expand']}
    base = _base()
    for rounds in (1, 3):
        ours = space.coordinate_descent(space.default_space(ov), base,
                                        _scripted, rounds=rounds)
        theirs = jspace.coordinate_descent(jspace.default_space(ov), base,
                                           _scripted, rounds=rounds)
        assert ours == theirs


def test_successive_halving_as_jax():
    cands = space.default_space(OVERRIDES[2]).enumerate(_base())
    assert len(cands) > 4
    for kw in ({'min_steps': 2, 'max_steps': 8},
               {'min_steps': 1, 'max_steps': 16, 'eta': 3},
               {'min_steps': 8, 'max_steps': 8}):
        assert space.successive_halving(cands, _scripted, **kw) == \
            jspace.successive_halving(cands, _scripted, **kw)
    dead = lambda c, s: None  # noqa: E731
    assert space.successive_halving(cands, dead, min_steps=2,
                                    max_steps=8) == \
        jspace.successive_halving(cands, dead, min_steps=2, max_steps=8)
    for mod in (space, jspace):
        with pytest.raises(ValueError, match='eta'):
            mod.successive_halving(cands, _scripted, min_steps=2,
                                   max_steps=8, eta=1)


# ---------------------------------------------------------------------------
# The scorer
# ---------------------------------------------------------------------------

def _metrics(p50, p95=None, p99=None, n=8, peak=None, spike=1.5):
    return {'n_steps': n, 'step_p50_ms': p50, 'step_p95_ms': p95 or p50,
            'step_p99_ms': p99 or p50, 'max_over_median': spike,
            'peak_hbm_bytes': peak, 'retraces': 0}


ROWS = [
    {'knobs': {'a': 1}, 'metrics': _metrics(10.0, 12.0, 30.0),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 2}, 'metrics': _metrics(10.1, 11.0, 12.0),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 3}, 'metrics': _metrics(9.0, peak=2e9),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 4}, 'metrics': {}, 'disqualified': 'invalid: x',
     'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 5}, 'metrics': _metrics(5.0), 'disqualified': None,
     'retraces': 2, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 6}, 'metrics': _metrics(5.0), 'disqualified': None,
     'retraces': 0, 'nonfinite_skips': 3.0},
    {'knobs': {'a': 7}, 'metrics': _metrics(5.0, n=0),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 8}, 'metrics': {**_metrics(5.0), 'step_p50_ms': None},
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 9}, 'metrics': _metrics(10.0, 12.0, 30.0, spike=None),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
    {'knobs': {'a': 10}, 'metrics': _metrics(11.0, 11.0, 11.0),
     'disqualified': None, 'retraces': 0, 'nonfinite_skips': 0.0},
]


def test_scorer_as_jax():
    assert score.WEIGHTS == jscore.WEIGHTS
    assert score.OBJECTIVES == jscore.OBJECTIVES
    assert score.LEXI_P50_GRAIN == jscore.LEXI_P50_GRAIN
    for ceiling in (None, 1e9):
        for row in ROWS:
            assert score.hard_violation(row, hbm_ceiling=ceiling) == \
                jscore.hard_violation(row, hbm_ceiling=ceiling)
        for objective in score.OBJECTIVES:
            assert score.rank_candidates(
                ROWS, objective=objective, hbm_ceiling=ceiling) == \
                jscore.rank_candidates(ROWS, objective=objective,
                                       hbm_ceiling=ceiling)
    for row in ROWS[:3]:
        for objective in score.OBJECTIVES:
            assert score.objective_value(row['metrics'], objective) == \
                jscore.objective_value(row['metrics'], objective)
    for mod in (score, jscore):
        with pytest.raises(ValueError, match='unknown objective'):
            mod.objective_value(ROWS[0]['metrics'], 'fastest')
    pairs = [(1.0, 1.2, 0.25), (1.0, 2.0, 0.25), ((5, 1.0), [5, 2.0], 0.1),
             ((5, 1.0), (7, 1.0), 0.1), (float('nan'), 1.0, 0.5),
             (0.0, 0.0, 0.1), (float('inf'), 1.0, 10.0)]
    for a, b, tol in pairs:
        assert score.scores_close(a, b, tol) == jscore.scores_close(a, b,
                                                                    tol)
    # A probe result scores as its row.
    r = probe.ProbeResult(knobs={'a': 1}, metrics=_metrics(3.0))
    assert score.hard_violation(r) is None
    assert score.rank_candidates([r])[0]['score'] == \
        jscore.rank_candidates([r.to_row()])[0]['score']


# ---------------------------------------------------------------------------
# The artifact: fail-closed loading, apply, the KFAC keywords
# ---------------------------------------------------------------------------

def _artifact(**over) -> dict:
    obj = {'created_unix': 1, 'workload': 'tiny_mlp', 'platform': 'cpu',
           'topology': {'topo_format': 1, 'topo_processes': 1,
                        'topo_devices': 1, 'topo_rows': 1, 'topo_cols': 1,
                        'topo_seq': 1, 'topo_dist_factors': 0},
           'sink_schema': sink.SCHEMA_VERSION,
           'best': {'bf16_precond': True, 'kfac_cov_update_freq': 2},
           'objective': 'weighted', 'candidates': []}
    obj.update(over)
    return obj


def _matrix(tmp: Path) -> dict:
    """Artifact files, by case (the committed artifact included)."""
    paths = {'committed': COMMITTED, 'missing': tmp / 'nope.json'}
    driver.write_tuned(str(tmp / 'good.json'), _artifact())
    paths['good'] = tmp / 'good.json'
    (tmp / 'torn.json').write_text(json.dumps(_artifact())[:40])
    paths['torn'] = tmp / 'torn.json'
    (tmp / 'fmt.json').write_text(json.dumps({'format': 'other',
                                              'best': {}}))
    paths['format'] = tmp / 'fmt.json'
    (tmp / 'nobest.json').write_text(json.dumps(
        {'format': driver.ARTIFACT_FORMAT, 'best': [1]}))
    paths['no_best'] = tmp / 'nobest.json'
    topo = _artifact()
    topo['topology'] = {**topo['topology'], 'topo_devices': 64}
    driver.write_tuned(str(tmp / 'topo.json'), topo)
    paths['topology'] = tmp / 'topo.json'
    seq = _artifact()
    seq['topology'] = {**seq['topology'], 'topo_seq': 2}
    driver.write_tuned(str(tmp / 'seq.json'), seq)
    paths['seq'] = tmp / 'seq.json'
    driver.write_tuned(str(tmp / 'plat.json'), _artifact(platform='tpu'))
    paths['platform'] = tmp / 'plat.json'
    driver.write_tuned(str(tmp / 'notopo.json'), _artifact(topology=None))
    paths['no_topology'] = tmp / 'notopo.json'
    driver.write_tuned(str(tmp / 'unk.json'), _artifact(
        best={'bf16_precond': True, 'comm_method': 'mem-opt'}))
    paths['unknown'] = tmp / 'unk.json'
    return paths


def test_fail_closed_load_matrix_as_jax(tmp_path):
    paths = _matrix(tmp_path)
    reasons = {}
    for case, path in paths.items():
        for platform in ('cpu', 'gpu', None):
            for world in ({'devices': 1, 'processes': 1},
                          {'devices': 2, 'processes': 2},
                          {'devices': 1, 'processes': 1, 'seq': 1}, None):
                ours = driver.load_tuned_config(str(path),
                                                platform=platform,
                                                world=world)
                theirs = jdriver.load_tuned_config(str(path),
                                                   platform=platform,
                                                   world=world)
                assert ours == theirs, (case, platform, world)
                assert len(ours[1]) == 1
        knobs, events = driver.load_tuned_config(
            str(path), platform='cpu', world=driver.live_world())
        reasons[case] = events[0].get('reason', events[0]['event'])
    assert reasons == {
        'committed': 'autotune_apply', 'missing': 'missing',
        'good': 'autotune_apply', 'torn': 'unreadable',
        'format': 'unreadable', 'no_best': 'unreadable',
        # live_world carries no seq: the recorded topo_seq is not read.
        'topology': 'topology_mismatch', 'seq': 'autotune_apply',
        'platform': 'platform_mismatch',
        'no_topology': 'topology_mismatch', 'unknown': 'unknown_knobs'}
    _, events = driver.load_tuned_config(
        str(paths['seq']), platform='cpu',
        world={**driver.live_world(), 'seq': 1})
    assert (events[0]['reason'], events[0]['key']) == ('topology_mismatch',
                                                       'topo_seq')
    # The committed CPU artifact on a CUDA run: the platform falls back.
    _, events = driver.load_tuned_config(
        str(COMMITTED), platform=driver.platform_of('cuda'),
        world=driver.live_world())
    assert events[0]['reason'] == 'platform_mismatch'
    assert (events[0]['artifact'], events[0]['live']) == ('cpu', 'gpu')


def test_platform_and_world_of_a_run():
    assert driver.platform_of('cpu') == 'cpu'
    assert driver.platform_of(torch.device('cuda', 0)) == 'gpu'
    assert driver.live_world() == {'devices': 1, 'processes': 1}


def test_read_and_write_as_jax(tmp_path):
    obj = driver.write_tuned(str(tmp_path / 'a.json'), _artifact())
    jobj = jdriver.write_tuned(str(tmp_path / 'b.json'), _artifact())
    assert obj == jobj
    assert (tmp_path / 'a.json').read_text() == \
        (tmp_path / 'b.json').read_text()
    assert driver.read_tuned(str(tmp_path / 'b.json')) == \
        jdriver.read_tuned(str(tmp_path / 'a.json'))
    assert driver.tuned_path('x') == jdriver.tuned_path('x')
    assert driver.ARTIFACT_FORMAT == jdriver.ARTIFACT_FORMAT


APPLY = [{'bf16_precond': True}, {'inv_pipeline_chunks': 2},
         {'not_a_field': 1}, {'kfac_cov_update_freq': 2,
                              'factor_batch_fraction': 0.5},
         {'inv_staleness': 1, 'inv_pipeline_chunks': 2},
         {'factor_batch_fraction': 1.5}, {'kfac_approx': 'reduce'},
         {'inv_lowrank_rank': 4096}]


@pytest.mark.parametrize('freq', [4, 5])
def test_apply_tuned_as_jax(freq):
    ours_cfg = optimizers.OptimConfig(kfac_inv_update_freq=freq)
    jax_cfg = joptim.OptimConfig(kfac_inv_update_freq=freq)
    for knobs in APPLY:
        new, err = driver.apply_tuned(ours_cfg, knobs)
        jnew, jerr = jdriver.apply_tuned(jax_cfg, knobs)
        assert err == jerr, knobs
        if err is None:
            assert {f: getattr(new, f) for f in optimizers.TUNABLE_FIELDS
                    if f not in ('fused_factor_contraction',
                                 'fused_precondition')} == \
                {f: getattr(jnew, f) for f in joptim.TUNABLE_FIELDS
                 if f not in ('fused_factor_contraction',
                              'fused_precondition')}
        else:
            assert new is ours_cfg


def _as_torch(v):
    return {jnp.bfloat16: torch.bfloat16}.get(v, v)


def test_kfac_overrides_as_jax():
    knob_sets = [
        {'bf16_precond': True, 'factor_batch_fraction': 0.5,
         'eigh_polish_iters': 16, 'kfac_inv_update_freq': 20,
         'inv_pipeline_chunks': 2, 'bf16_precond_off': False},
        {'bf16_factors': True, 'bf16_inverses': True, 'kfac_approx':
         'reduce', 'inv_lowrank_rank': 64, 'inv_lowrank_dim_threshold': 128,
         'fused_factor_contraction': True, 'fused_precondition': True,
         'deferred_factor_reduction': True, 'inv_staleness': 1,
         'hierarchical_reduce': True},
        {'bf16_precond': False, 'bf16_factors': False,
         'deferred_factor_reduction': False},
    ]
    for knobs in knob_sets:
        kw, freq, ignored = driver.kfac_overrides(knobs)
        jkw, jfreq, jignored = jdriver.kfac_overrides(knobs)
        assert kw == {k: _as_torch(v) for k, v in jkw.items()}
        assert (freq, ignored) == (jfreq, jignored)
        KFAC(probe.TinyMLP(), device='cpu', **kw)   # every keyword a knob
    # The port's KFAC runs the fused kernels by default: an off knob is
    # passed as False (JAX's default is off, so it passes nothing).
    kw, _, _ = driver.kfac_overrides({'fused_precondition': False})
    assert kw == {'fused_precondition': False}
    assert jdriver.kfac_overrides({'fused_precondition': False})[0] == {}


# ---------------------------------------------------------------------------
# The cadence policy
# ---------------------------------------------------------------------------

WAITS = ([None, 12.0, 12.0, 12.0, 1.0, None, 30.0, 30.0, 30.0, 30.0,
          30.0, 0.5, 0.5, 0.5, None, 0.5, 0.5, 0.5, 0.5, 0.5, 40.0, 40.0]
         + [0.1] * 30)


@pytest.mark.parametrize('config', [
    {}, {'skew_threshold_ms': 10.0, 'sustain_steps': 2,
         'recover_steps': 3, 'max_stretch': 4},
    {'skew_threshold_ms': 0.0, 'sustain_steps': 1, 'recover_steps': 1,
     'max_stretch': 8},
    {'skew_threshold_ms': 20.0, 'sustain_steps': 3, 'recover_steps': 2,
     'max_stretch': 2}])
@pytest.mark.parametrize('schedule', [
    (1, 4, {}), (2, 10, {}), (1, 8, {'inv_pipeline_chunks': 2}),
    (1, 4, {'deferred_reduce': True, 'inv_staleness': 1})])
def test_policy_flags_and_events_as_jax(config, schedule):
    f_freq, i_freq, kw = schedule
    ours = policy.StragglerCadencePolicy(policy.BackoffConfig(**config))
    theirs = jpolicy.StragglerCadencePolicy(jpolicy.BackoffConfig(**config))
    for step, wait in enumerate(WAITS):
        flags = engine.cadence_flags(step, f_freq, i_freq, **kw)
        assert ours.adjust(step, dict(flags), wait) == \
            theirs.adjust(step, dict(flags), wait), step
        assert ours.stretch == theirs.stretch
        if step % 7 == 0:
            assert ours.drain_events() == theirs.drain_events()
    assert ours.pending_events == theirs.pending_events
    assert ours.suppressed_firings == theirs.suppressed_firings


def test_policy_envelope_and_event_bound_as_jax():
    assert policy.MAX_PENDING_EVENTS == jpolicy.MAX_PENDING_EVENTS
    for bad in ({'skew_threshold_ms': -1.0}, {'sustain_steps': 0},
                {'recover_steps': 0}, {'max_stretch': 0}):
        with pytest.raises(ValueError):
            policy.BackoffConfig(**bad)
        with pytest.raises(ValueError):
            jpolicy.BackoffConfig(**bad)
    cfg = {'skew_threshold_ms': 1.0, 'sustain_steps': 1,
           'recover_steps': 1, 'max_stretch': 2}
    ours = policy.StragglerCadencePolicy(policy.BackoffConfig(**cfg))
    theirs = jpolicy.StragglerCadencePolicy(jpolicy.BackoffConfig(**cfg))
    for step in range(3 * policy.MAX_PENDING_EVENTS):
        wait = 5.0 if step % 2 == 0 else 0.0
        ours.adjust(step, {'factor_update': True}, wait)
        theirs.adjust(step, {'factor_update': True}, wait)
    assert len(ours.pending_events) == policy.MAX_PENDING_EVENTS
    assert ours.drain_events() == theirs.drain_events()


# ---------------------------------------------------------------------------
# The six flags through the three CLIs
# ---------------------------------------------------------------------------

STEPS = 4
SKEW = [100.0] * STEPS
#: flag -> (extra options, injected waits or None for the real observers)
AUTOTUNE_FLAGS = {
    'tuned_config': ({}, None),
    'cadence_backoff': ({'cadence_backoff': True}, None),
    'backoff_skew_ms': ({'cadence_backoff': True, 'backoff_skew_ms': 200.0,
                         'backoff_sustain_steps': 1}, SKEW),
    'backoff_sustain_steps': ({'cadence_backoff': True,
                               'backoff_sustain_steps': 1}, SKEW),
    'backoff_recover_steps': ({'cadence_backoff': True,
                               'backoff_sustain_steps': 1,
                               'backoff_recover_steps': 1},
                              [100.0, 0.0, 0.0, 0.0]),
    'backoff_max_stretch': ({'cadence_backoff': True,
                             'backoff_sustain_steps': 1,
                             'backoff_max_stretch': 2}, SKEW),
}


def _inject_waits(monkeypatch, waits):
    """The runs' observers, with the barrier probe replaced by ``waits``
    (a process alone has none) when given."""
    made = []
    real = engine.make_observers

    def make(*a, **k):
        obs = real(*a, **k)
        if waits is not None:
            it = iter(waits)
            obs.barrier_probe = lambda: next(it, 0.0)
        made.append(obs)
        return obs

    monkeypatch.setattr(engine, 'make_observers', make)
    return made


def _expected(cli_args, i_freq: int, f_freq: int, waits) -> tuple:
    """The fired stages, factor updates and events the policy of
    ``cli_args`` gives the schedule under ``waits``."""
    pol = autotune.cli.make_cadence_policy(cli_args)
    fired, factor = [], 0
    for step in range(STEPS):
        flags = engine.cadence_flags(step, f_freq, i_freq)
        if pol is not None:
            flags = pol.adjust(step, flags,
                               None if waits is None else waits[step])
        fired.append(engine.fired_stage(flags))
        factor += bool(flags['factor_update'])
    return fired, factor, pol.drain_events() if pol else []


def _config(cli: str, tmp_path: Path, **extra) -> dict:
    module, base = CONFIGS[cli]
    return {**base, 'epochs': 2, 'max_steps': STEPS,
            'kfac_metrics': str(tmp_path / 'm.jsonl'), 'metrics_interval': 1,
            **extra}


def _events(path: Path, kind: str) -> list:
    return [r.get('data', {}) for r in sink.read_jsonl(str(path))
            if r['kind'] == 'event' and r['event'] == kind]


@pytest.mark.parametrize('flag', list(AUTOTUNE_FLAGS))
@pytest.mark.parametrize('cli', list(CONFIGS))
def test_autotune_flag_takes_effect(tmp_path, monkeypatch, cli, flag):
    module, _ = CONFIGS[cli]
    option = '--' + flag.replace('_', '-')
    assert option in module.build_parser()._option_string_actions
    extra, waits = AUTOTUNE_FLAGS[flag]
    if flag == 'tuned_config':
        art = tmp_path / 'TUNED.json'
        driver.write_tuned(str(art), _artifact(
            best={'kfac_cov_update_freq': 2}))
        extra = {'tuned_config': str(art)}
    made = _inject_waits(monkeypatch, waits)
    config = _config(cli, tmp_path, **extra)
    res = module.train(config, device='cpu')
    args = engine.parse_args(module.build_parser(), config)
    i_freq = args.kfac_update_freq
    f_freq = 2 if flag == 'tuned_config' else args.kfac_cov_update_freq
    fired, factor, events = _expected(args, i_freq, f_freq, waits)
    assert res['steps'] == STEPS
    assert res['fired'] == fired
    stream = tmp_path / 'm.jsonl'
    steps = [r for r in sink.read_jsonl(str(stream)) if r['kind'] == 'step']
    assert [r.get('fired') for r in steps] == fired
    assert steps[-1]['metrics']['kfac/factor_updates'] == factor
    backoff = _events(stream, 'autotune_backoff')
    assert backoff == [{k: v for k, v in e.items() if k != 'event'}
                       for e in events]
    obs = made[0]
    if flag == 'tuned_config':
        applied = _events(stream, 'autotune_apply')
        assert len(applied) == 1
        assert json.loads(applied[0]['knobs']) == {'kfac_cov_update_freq': 2}
        kfac = res['state'].kfac
        assert kfac.factor_update_freq == 2
        assert obs.cadence_policy is None
        return
    pol = obs.cadence_policy
    assert isinstance(pol, policy.StragglerCadencePolicy)
    assert pol.config == policy.BackoffConfig(
        skew_threshold_ms=args.backoff_skew_ms,
        sustain_steps=args.backoff_sustain_steps,
        recover_steps=args.backoff_recover_steps,
        max_stretch=args.backoff_max_stretch)
    if flag == 'cadence_backoff':
        # A process alone: the single-device KFAC has no barrier probe.
        assert obs.barrier_probe is None and pol.stretch == 1
        assert backoff == []
    elif flag == 'backoff_skew_ms':
        assert backoff == []           # 100 ms waits below 200 ms
    else:
        assert backoff and backoff[0]['action'] == 'stretch'
        if flag == 'backoff_max_stretch':
            assert max(e['stretch'] for e in backoff) == 2
        if flag == 'backoff_recover_steps':
            assert [e['action'] for e in backoff] == ['stretch', 'relax']


@pytest.mark.parametrize('cli', list(CONFIGS))
def test_autotune_flags_need_the_kfac_step(cli, tmp_path):
    module, base = CONFIGS[cli]
    sgd = {**base, 'kfac_update_freq': 0}
    with pytest.raises(SystemExit, match='--cadence-backoff requires'):
        module.train({**sgd, 'cadence_backoff': True}, device='cpu')
    art = tmp_path / 'TUNED.json'
    driver.write_tuned(str(art), _artifact())
    with pytest.raises(SystemExit, match='--tuned-config requires'):
        module.train({**sgd, 'tuned_config': str(art)}, device='cpu')
    args = module.build_parser().parse_args([])
    assert (args.tuned_config, args.cadence_backoff, args.backoff_skew_ms,
            args.backoff_sustain_steps, args.backoff_recover_steps,
            args.backoff_max_stretch) == (None, False, 5.0, 8, 32, 4)


@pytest.mark.parametrize('cli', list(CONFIGS))
def test_fallback_runs_the_untuned_config(cli, tmp_path):
    """The committed CPU artifact under another world (fail-closed: one
    ``autotune_fallback`` event) and a merge its cadence breaks: both runs
    equal the run without the flag, bit for bit."""
    module, _ = CONFIGS[cli]
    plain = module.train(_config(cli, tmp_path / 'plain'), device='cpu')
    art = tmp_path / 'TUNED.json'
    driver.write_tuned(str(art), _artifact(
        best={'inv_pipeline_chunks': 3}))
    for path, reason in ((art, 'invalid_merge'),
                         (tmp_path / 'missing.json', 'missing')):
        out = tmp_path / reason
        res = module.train(_config(cli, out, tuned_config=str(path)),
                           device='cpu')
        assert res['losses'] == plain['losses']
        fallback = _events(out / 'm.jsonl', 'autotune_fallback')
        assert [e['reason'] for e in fallback] == [reason]
        assert not _events(out / 'm.jsonl', 'autotune_apply')


# ---------------------------------------------------------------------------
# The engine under an armed policy: suppression against the schedule
# ---------------------------------------------------------------------------

CASES = {'deferred': {'deferred_factor_reduction': True},
         'staleness': {'inv_staleness': 1},
         'grad_accum': {}, 'chunks': {'inv_pipeline_chunks': 2}}


def _engine_state(case: str):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = probe.TinyMLP()
    kfac = KFAC(model, inv_update_freq=4, factor_update_freq=1,
                collect_metrics=True, device='cpu', **CASES[case])
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return engine.make_train_state(
        model, opt, kfac, grad_accum=2 if case == 'grad_accum' else 1)


@pytest.mark.parametrize('case', list(CASES))
def test_armed_policy_against_the_schedule(case):
    """8 steps with a stretch armed at step 0 (sustained skew): the
    window heads' reduce and snapshot and the chunk firings still run on
    suppressed factor steps, an accumulated step sums no contributions,
    and the run equals the same steps driven with the policy's flags."""
    wl = probe.get_workload('tiny_mlp')
    batches = [wl.make_batch(i % 4) for i in range(8)]
    hyper = {'lr': 0.1, 'damping': 0.003, 'factor_update_freq': 1,
             'inv_update_freq': 4}
    cfg = policy.BackoffConfig(skew_threshold_ms=5.0, sustain_steps=1,
                               max_stretch=4)
    armed = _engine_state(case)
    obs = engine.Observers(cadence_policy=policy.StragglerCadencePolicy(cfg),
                           barrier_probe=lambda: 50.0)
    res = engine.train_epoch(armed, batches, hyper, device='cpu',
                             observers=obs)
    ref = _engine_state(case)
    pol = policy.StragglerCadencePolicy(cfg)
    schedule = engine.epoch_schedule(ref.kfac, 4)
    fired, suppressed = [], 0
    for step, (xb, yb) in enumerate(batches):
        sched = engine.cadence_flags(step, 1, 4, **schedule)
        flags = pol.adjust(step, sched, 50.0)
        suppressed += sched['factor_update'] and not flags['factor_update']
        fired.append(engine.fired_stage(flags))
        engine.train_step(ref, torch.as_tensor(xb), torch.as_tensor(yb),
                          hyper, flags)
        ref.step += 1
    assert res['fired'] == fired
    assert suppressed == 5 and pol.stretch == 4
    if case == 'deferred':
        assert fired[4] == 'inverse+reduce'
    if case == 'chunks':
        assert fired[6] == 'chunk1'
    for a, b in zip(armed.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
    for key in ('factors', 'factor_accum', 'frozen_factors'):
        if key in ref.kfac_state:
            got, want = armed.kfac_state[key], ref.kfac_state[key]
            for name in want:
                for side in want[name]:
                    assert torch.equal(got[name][side], want[name][side])
    assert int(armed.kfac_state['metrics']['factor_updates']) == 8 - 5


def test_unarmed_and_idle_policy_leave_the_step_alone():
    """No policy, and an armed policy whose waits never pass the
    threshold: the same run bit for bit."""
    wl = probe.get_workload('tiny_mlp')
    batches = [wl.make_batch(i % 4) for i in range(8)]
    hyper = {'lr': 0.1, 'damping': 0.003, 'factor_update_freq': 1,
             'inv_update_freq': 4}
    runs = []
    for obs in (None, engine.Observers(
            cadence_policy=policy.StragglerCadencePolicy(),
            barrier_probe=lambda: 1.0)):
        state = _engine_state('grad_accum')
        res = engine.train_epoch(state, batches, hyper, device='cpu',
                                 observers=obs)
        runs.append((res['losses'], res['fired'],
                     [p.detach().clone() for p in state.model.parameters()]))
    assert runs[0][:2] == runs[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
