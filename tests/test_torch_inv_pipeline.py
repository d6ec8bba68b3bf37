"""Pipelined inverse firing (``inv_pipeline_chunks``) of the torch port
against the JAX package, on the CPU.

  - **Schedule.** ``engine.cadence_flags`` equals the JAX function at every
    step of ``0..3 i_freq`` over a grid of ``(f_freq, i_freq, k,
    deferred, staleness)``, and ``fired_stage`` gives JAX's labels.
  - **Chunk plans.** ``plan_inverse_chunks`` equals JAX's on the flagship
    factor-dim sets of the JAX suite (and keeps its 1.5x balance bound);
    ``KFAC.inverse_chunk_plan`` equals JAX's item for item on ResNet-32,
    ResNet-50 and a tiny tied Transformer, with and without measured
    costs; ``parallel.distributed.plan_firing_chunks`` equals JAX's
    ``_plan_firing_chunks`` offset for offset on 1 x 4, 4 x 1 and 2 x 2
    grids. Plans are exact: they are host-side integers.
  - **Chunk firing.** ``KFAC.step(inv_chunk=j)`` on a deep MLP (six
    same-width layers, so chunks split size buckets) against the JAX
    ``KFAC.step`` on the same weights and batches, under the library
    eigh, Cholesky and Newton--Schulz: factors <= 1e-5 and preconditioned
    gradients <= 1e-4 of the largest reference entry, at every step.
  - **Frozen window.** On the port, a window of chunk firings over frozen
    factors equals one monolithic firing bit for bit (under every inverse
    method, the plain Jacobi included).
  - The constructor, plan and step checks of the JAX suite, each run on
    the port (the messages are JAX's), and the CLIs' flag.

The JAX side runs eagerly, as its own tests run it on the CPU (no Pallas
kernel is on this path). The port runs its kernels' plain versions.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu import preconditioner as JP
from distributed_kfac_pytorch_tpu.parallel import distributed as JD
from distributed_kfac_pytorch_tpu.training import engine as jengine
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
from distributed_kfac_pytorch_tpu_torch.preconditioner import (
    KFAC,
    plan_inverse_chunks,
)
from distributed_kfac_pytorch_tpu_torch.training import engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PRECOND_TOL = 1e-4
FACTOR_TOL = 1e-5
COMMON = dict(factor_update_freq=1, factor_decay=0.5, damping=0.01, lr=0.1,
              kl_clip=None)


# ---------------------------------------------------------------------------
# The deep MLP of the JAX suite (tests/test_inv_pipeline.py) and its twin
# ---------------------------------------------------------------------------

class DeepMLP(nn.Module):
    """Torch twin of the JAX suite's ``DeepMLP``: six tanh Linears of
    width 8 and a head of 4, named as flax names them (``d0``..``d5``,
    ``head``)."""

    def __init__(self, widths=(8, 8, 8, 8, 8, 8, 4), din=8):
        super().__init__()
        self.names = [f'd{i}' for i in range(len(widths) - 1)] + ['head']
        for name, w in zip(self.names, widths):
            setattr(self, name, nn.Linear(din, w))
            din = w

    def forward(self, x):
        for name in self.names[:-1]:
            x = torch.tanh(getattr(self, name)(x))
        return self.head(x)


def jax_deep_mlp():
    from test_inv_pipeline import DeepMLP as JDeepMLP
    return JDeepMLP()


def batches(n: int, batch: int = 16, din: int = 8, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, din)).astype(np.float32)
            for _ in range(n)]


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def run_pair(knobs: dict, flags_of, xs: list, jmodel=None, tmodel=None,
             i_freq: int = 4) -> list:
    """The JAX ``KFAC`` and the port's on the same weights, stepping with
    ``flags_of(step)`` on the batches ``xs`` (the weights stay put, so
    every step sees the same kind of input). Returns per step the
    largest factor and preconditioned-gradient error, and both states."""
    jmodel = jmodel or jax_deep_mlp()
    tmodel = tmodel or DeepMLP()
    jk = JKFAC(jmodel, inv_update_freq=i_freq, **COMMON, **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = variables['params']
    tmodel.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(tmodel, device='cpu', inv_update_freq=i_freq, **COMMON,
              **knobs)
    tstate = tk.init_state()
    out = []
    for i, x in enumerate(xs):
        flags = flags_of(i)
        _, _, jg, jc, _ = jk.capture.loss_and_grads(
            lambda o: jnp.mean(o ** 2), params, jnp.asarray(x))
        jp, jstate = jk.step(jstate, jg, jc, **flags)
        _, _, tg, tc = tk.capture.loss_and_grads(
            lambda o: torch.mean(o ** 2), torch.from_numpy(x))
        tp, tstate = tk.step(tstate, tg, tc, **flags)
        jf = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, jstate['factors']), tk.specs)
        jpt = convert.flax_to_torch(jax.tree.map(np.asarray, jp))
        out.append({
            'flags': flags,
            'factors': max(rel(tstate['factors'][n][s], jf[n][s])
                           for n in jf for s in 'AG'),
            'precond': max(rel(tp[n].detach(), jpt[n]) for n in jpt),
            'jstate': jstate, 'tstate': tstate, 'tk': tk, 'jk': jk})
    return out


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

GRID = [(f, i, k, d, s) for f in (1, 2) for i in (4, 6, 8)
        for k in (1, 2, 3, 4) for d in (False, True) for s in (0, 1)]


@pytest.mark.parametrize('f_freq,i_freq,k,deferred,staleness', GRID)
def test_cadence_flags_match_jax(f_freq, i_freq, k, deferred, staleness):
    for step in range(3 * i_freq + 1):
        kw = dict(deferred_reduce=deferred, inv_staleness=staleness)
        got = engine.cadence_flags(step, f_freq, i_freq, k, **kw)
        want = jengine.cadence_flags(step, f_freq, i_freq, k, **kw)
        assert got == want, (step, got, want)
        assert engine.fired_stage(got) == jengine.fired_stage(want)


@pytest.mark.parametrize('flags', [
    {'factor_update': True, 'inv_update': True},
    {'factor_update': True, 'inv_update': False, 'inv_chunk': 1},
    {'factor_update': True, 'factor_reduce': True},
    {'factor_update': True, 'factor_reduce': False},
    {'factor_reduce': True, 'inv_chunk': 1},
    {'factor_reduce': True, 'inv_update': True},
    {'factor_update': False},
    {'factor_update': False, 'factor_snapshot': True}])
def test_fired_stage_labels_match_jax(flags):
    assert engine.fired_stage(flags) == jengine.fired_stage(flags)


def test_cadence_flags_chunk_phases():
    """The JAX suite's case: k 4, window 8, stride 2."""
    flags = {s: engine.cadence_flags(s, 2, 8, 4) for s in range(17)}
    assert flags[0]['inv_update'] and 'inv_chunk' not in flags[0]
    for s, j in ((2, 1), (4, 2), (6, 3), (8, 0), (10, 1), (16, 0)):
        assert not flags[s]['inv_update']
        assert flags[s]['inv_chunk'] == j
    for s in (1, 3, 5, 7, 9, 15):
        assert not flags[s]['inv_update'] and 'inv_chunk' not in flags[s]
    assert engine.fired_stage(flags[0]) == 'inverse'
    assert engine.fired_stage(flags[2]) == 'chunk1'


# ---------------------------------------------------------------------------
# Chunk plans against JAX
# ---------------------------------------------------------------------------

def _flagship_dims():
    from test_inv_pipeline import RESNET50_DIMS, XL_LM_DIMS
    return {'resnet50': RESNET50_DIMS, 'xl_lm': XL_LM_DIMS}


@pytest.mark.parametrize('which,k', [('resnet50', 2), ('resnet50', 4),
                                     ('xl_lm', 2), ('xl_lm', 4),
                                     ('xl_lm', 8)])
def test_plan_inverse_chunks_matches_jax(which, k):
    dims = _flagship_dims()[which]
    items = [((i, d), float(d) ** 3) for i, d in enumerate(dims)]
    plan = plan_inverse_chunks(items, k)
    assert plan == JP.plan_inverse_chunks(items, k)
    loads = [0.0] * k
    for key, cost in items:
        loads[plan[key]] += cost
    assert max(loads) <= 1.5 * sum(loads) / k


class _Shape:
    """A stand-in factor: the planners read its shape only."""

    def __init__(self, *shape):
        self.shape = shape


_PAIRS = {}


def _pair(which):
    """``(jax KFAC with specs, port KFAC)`` of one model; the JAX side is
    registered through its capture alone (no K-FAC state is built)."""
    if which in _PAIRS:
        return _PAIRS[which]
    from test_torch_placement import _models
    if which == 'resnet50':
        from distributed_kfac_pytorch_tpu.models import imagenet_resnet as J
        from distributed_kfac_pytorch_tpu.sharing import approx
        jk = JKFAC(J.get_model('resnet50'))
        variables, specs = jk.capture.init(jax.random.PRNGKey(0),
                                           jnp.ones((1, 32, 32, 3)))
        jk._specs = approx.annotate_specs(specs, 'expand')
        jparams = variables['params']
        model = imagenet_resnet.get_model('resnet50')
    else:
        (jk, jparams), model = _models(which)
    tk = KFAC(model, device='cpu')
    _PAIRS[which] = (jk, jparams, tk)
    return _PAIRS[which]


def _fake_factors(tk, jax_names=False) -> dict:
    dims = D.factor_dims(tk)
    out = {}
    for name, (a, g) in dims.items():
        key = name.replace('.', '/') if jax_names else name
        diag = tk.specs[name].kind == 'embedding'
        out[key] = {'A': _Shape(a) if diag else _Shape(a, a),
                    'G': _Shape(g, g)}
    return out


def _port_key(key: tuple) -> tuple:
    return (key[0], key[1].replace('/', '.'), *key[2:])


@pytest.mark.parametrize('measured', [False, True])
@pytest.mark.parametrize('k', [2, 4])
@pytest.mark.parametrize('which', ['resnet32', 'resnet50', 'tied_lm'])
def test_inverse_chunk_plan_matches_jax(which, k, measured):
    jk, _, tk = _pair(which)
    dims = sorted({t.shape[0] for f in _fake_factors(tk).values()
                   for t in f.values() if len(t.shape) == 2})
    costs = ({d: 1.0 + (7 * d) % 13 for d in dims} if measured else None)
    for kf in (jk, tk):
        kf.inv_pipeline_chunks, kf.inv_pipeline_costs = k, costs
    got = tk.inverse_chunk_plan(_fake_factors(tk))
    want = jk.inverse_chunk_plan(_fake_factors(tk, jax_names=True))
    assert got == {_port_key(key): j for key, j in want.items()}
    items = tk.inverse_chunk_items(_fake_factors(tk))
    assert sorted(got) == sorted(key for key, _ in items)
    assert set(got.values()) == set(range(k))


GRIDS = [(1, 4), (4, 1), (2, 2)]


@pytest.mark.parametrize('k', [2, 4])
@pytest.mark.parametrize('grid', GRIDS, ids=lambda g: f'{g[0]}x{g[1]}')
@pytest.mark.parametrize('which', ['resnet32', 'tied_lm'])
def test_distributed_chunk_plan_matches_jax(which, grid, k):
    import types
    jk, jparams, tk = _pair(which)
    for kf in (jk, tk):
        kf.inv_pipeline_chunks, kf.inv_pipeline_costs = k, None
    assignment = D.assign_work(tk, *grid)
    got = D.plan_firing_chunks(tk, assignment)
    items = D.item_chunk_plan(assignment, got)
    assert sorted(items) == sorted(
        key for key, _ in tk.inverse_chunk_items(_fake_factors(tk)))
    want_assignment = JD.assign_work(jk, jparams, *grid)
    stub = types.SimpleNamespace(
        kfac=jk, assignment=want_assignment,
        _factor_dims={n: D.factor_dims(tk)[n.replace('/', '.')]
                      for n in jk.specs})
    want = JD.DistributedKFAC._plan_firing_chunks(stub)
    assert got['offsets'] == want['offsets']
    assert got['diag'] == {n.replace('/', '.'): j
                           for n, j in want['diag'].items()}


# ---------------------------------------------------------------------------
# Checks (the JAX suite's, each run on the port)
# ---------------------------------------------------------------------------

def test_constructor_validation():
    with pytest.raises(ValueError, match='must be >= 1'):
        KFAC(DeepMLP(), device='cpu', inv_pipeline_chunks=0)
    with pytest.raises(ValueError, match='divide inv_update_freq'):
        KFAC(DeepMLP(), device='cpu', inv_update_freq=10,
             inv_pipeline_chunks=3)
    with pytest.warns(UserWarning, match='reuse stale factors'):
        KFAC(DeepMLP(), device='cpu', factor_update_freq=2,
             inv_update_freq=10, inv_pipeline_chunks=2)


def test_measured_costs_must_cover_every_dense_dim():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=2,
                inv_pipeline_chunks=2)
    state = kfac.init_state()
    kfac.inv_pipeline_costs = {9: 100.0}    # dims 8 and 4 missing
    with pytest.raises(ValueError, match='every dense factor dim'):
        kfac.inverse_chunk_plan(state['factors'])
    with pytest.raises(ValueError, match='every inverse bucket dim'):
        D.plan_firing_chunks(kfac, D.assign_work(kfac, 2, 2))
    kfac.inv_pipeline_costs = {9: 1e-6, 8: 1.0, 4: 1.0}
    measured = kfac.inverse_chunk_plan(state['factors'])
    kfac.inv_pipeline_costs = None
    assert measured != kfac.inverse_chunk_plan(state['factors'])


def test_chunks_capped_at_work_items():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=99)
    state = kfac.init_state()
    kfac.inv_pipeline_chunks = 99
    with pytest.raises(ValueError, match='inverse work items'):
        kfac.inverse_chunk_plan(state['factors'])
    with pytest.raises(ValueError, match='inverse work items'):
        KFAC(DeepMLP(), device='cpu', inv_update_freq=99,
             inv_pipeline_chunks=99).init_state()
    with pytest.raises(ValueError, match='inverse work items'):
        D.plan_firing_chunks(kfac, D.assign_work(kfac, 4, 1))


def test_eigen_warm_start_is_allowed():
    KFAC(DeepMLP(), device='cpu', inv_update_freq=4,
         inverse_method='eigen', eigh_method='warm',
         inv_pipeline_chunks=2).init_state()


def test_step_flag_validation():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=2,
                inv_pipeline_chunks=2)
    state = kfac.init_state()
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda o: o.pow(2).mean(), torch.randn(4, 8))
    with pytest.raises(ValueError, match='mutually exclusive'):
        kfac.step(state, grads, captures, factor_update=True,
                  inv_update=True, inv_chunk=0)
    with pytest.raises(ValueError, match='out of range'):
        kfac.step(state, grads, captures, factor_update=True,
                  inv_update=False, inv_chunk=5)
    plain = KFAC(DeepMLP(), device='cpu', inv_update_freq=2)
    with pytest.raises(ValueError, match='inv_chunk requires'):
        plain.update_inverses(plain.init_state(), chunk=0)


def test_chunks_cover_every_item_exactly_once():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=4,
                inv_pipeline_chunks=4)
    factors = kfac.init_state()['factors']
    plan = kfac.inverse_chunk_plan(factors)
    assert sorted(plan) == sorted(
        key for key, _ in kfac.inverse_chunk_items(factors))
    assert set(plan.values()) == set(range(4))


# ---------------------------------------------------------------------------
# Chunk firing against the JAX KFAC
# ---------------------------------------------------------------------------

# Against JAX the eigen sides take the library eigh: the warm polish of
# these tiny, nearly degenerate factors moves by more than 1e-4 under
# another fp32 summation order (its own polish from identity), on either
# side. The port-only bit-identity checks below run the polish too.
METHODS = {'eigen_xla': dict(inverse_method='eigen', eigh_method='xla'),
           'cholesky': dict(inverse_method='cholesky'),
           'newton': dict(inverse_method='newton')}


@pytest.mark.parametrize('k', [2, 4])
@pytest.mark.parametrize('method', list(METHODS))
def test_chunk_firing_matches_jax(method, k):
    """Two windows of inverses every 4 steps in ``k`` chunks, factors every
    step, fresh batches: the two K-FACs fire the same items on the same
    steps and stay within the tolerances."""
    recs = run_pair(dict(inv_pipeline_chunks=k, **METHODS[method]),
                    lambda i: engine.kfac_step_flags(
                        engine.cadence_flags(i, 1, 4, k)), batches(9))
    fired = [engine.fired_stage(r['flags']) for r in recs]
    assert fired[0] == 'inverse'
    assert sum(f.startswith('chunk') for f in fired) == 2 * k
    for i, r in enumerate(recs):
        assert r['factors'] <= FACTOR_TOL, (i, r['factors'])
        assert r['precond'] <= PRECOND_TOL, (i, r['precond'])
    assert recs[-1]['tstate']['inv_chunk_phase'] == int(
        recs[-1]['jstate']['inv_chunk_phase'])


@pytest.mark.parametrize('k', [2, 4])
@pytest.mark.parametrize('method', ['eigen_warm', 'eigen_xla', 'cholesky',
                                    'newton', 'jacobi'])
def test_frozen_window_equals_monolithic_firing(method, k):
    knobs = {'eigen_warm': dict(inverse_method='eigen'),
             'jacobi': dict(inverse_method='eigen', eigh_method='jacobi')
             }.get(method) or METHODS[method]
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=k,
                inv_pipeline_chunks=k, **COMMON, **knobs)
    state = kfac.init_state()
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda o: o.pow(2).mean(), torch.from_numpy(batches(1)[0]))
    _, state = kfac.step(state, grads, captures, factor_update=True,
                         inv_update=True)
    mono = kfac.update_inverses(state, 0.01)
    st = state
    for j in range(k):
        _, st = kfac.step(st, grads, captures, factor_update=False,
                          inv_update=False, inv_chunk=j)
    assert st['inv_chunk_phase'] == 0
    for name, entry in mono.items():
        for key, t in entry.items():
            assert torch.equal(t, st['inverses'][name][key]), (name, key)


def test_chunk_leaves_other_slots_untouched():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=4,
                inv_pipeline_chunks=4, **COMMON)
    state = kfac.init_state()
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda o: o.pow(2).mean(), torch.from_numpy(batches(1)[0]))
    _, state = kfac.step(state, grads, captures, factor_update=True,
                         inv_update=True)
    plan = kfac.inverse_chunk_plan(state['factors'])
    _, fired = kfac.step(state, grads, captures, factor_update=True,
                         inv_update=False, inv_chunk=1)
    for name, entry in state['inverses'].items():
        for side in 'AG':
            same = all(torch.equal(fired['inverses'][name][key], t)
                       for key, t in entry.items() if side in key)
            assert same == (plan[('mat', name, side)] != 1), (name, side)


# ---------------------------------------------------------------------------
# The CLIs and the epoch loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('module', [cli, inet, lm])
def test_clis_take_the_schedule_flags(module):
    args = module.build_parser().parse_args(
        ['--inv-pipeline-chunks', '2', '--inv-staleness', '1',
         '--deferred-factor-reduction', '--factor-batch-fraction', '0.5'])
    off = {'hierarchical_reduce': False, 'inv_lowrank_rank': 0,
           'inv_lowrank_dim_threshold': 2048}
    assert engine.schedule_config(args) == {
        'inv_pipeline_chunks': 2, 'inv_staleness': 1,
        'deferred_factor_reduction': True, 'factor_batch_fraction': 0.5,
        **off}
    defaults = engine.schedule_config(module.build_parser().parse_args([]))
    assert defaults == {'inv_pipeline_chunks': 1, 'inv_staleness': 0,
                        'deferred_factor_reduction': False,
                        'factor_batch_fraction': 1.0, **off}
    with pytest.raises(SystemExit):
        module.build_parser().parse_args(['--inv-staleness', '2'])


def test_cli_fires_the_chunks():
    res = cli.train({'model': 'resnet20', 'batch_size': 8,
                     'val_batch_size': 4, 'synthetic_size': 16, 'epochs': 2,
                     'no_augment': True, 'kfac_update_freq': 2,
                     'kfac_cov_update_freq': 1, 'inv_pipeline_chunks': 2,
                     'max_steps': 4, 'quiet': True}, device='cpu')
    assert res['fired'] == ['inverse', 'chunk1', 'chunk0', 'chunk1']
    kfac = res['state'].kfac
    assert kfac.inv_pipeline_chunks == 2
    assert res['state'].kfac_state['inv_chunk_phase'] == 0
    assert all(np.isfinite(res['losses']))


def test_epoch_schedule_falls_back_to_monolithic():
    kfac = KFAC(DeepMLP(), device='cpu', inv_update_freq=4,
                inv_pipeline_chunks=2)
    assert engine.epoch_schedule(kfac, 4) == {
        'inv_pipeline_chunks': 2, 'inv_staleness': 0,
        'deferred_reduce': False}
    with pytest.warns(UserWarning, match='does not divide'):
        schedule = engine.epoch_schedule(kfac, 3)
    assert schedule['inv_pipeline_chunks'] == 1
    flags = [engine.cadence_flags(s, 1, 3, **schedule) for s in range(7)]
    assert [f['inv_update'] for f in flags] == [True, False, False, True,
                                                False, False, True]
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        engine.epoch_schedule(kfac, 8)
