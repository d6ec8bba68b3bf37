"""Deferred factor reduction and one-window-stale inverses of the torch
port, single-device against the JAX ``KFAC`` and distributed over 4-rank
gloo worlds against the port's single-device ``KFAC``, on the CPU.

  - **Against JAX** (the JAX suite's deep MLP, weights carried over by
    ``convert``, a fresh batch each step): ``deferred_factor_reduction``,
    ``inv_staleness=1`` (one chunk and two) and all three knobs together,
    every step's factors <= 1e-5 and preconditioned gradients <= 1e-4 of
    the largest reference entry; a JAX state converted by
    ``convert.jax_state_to_torch`` (accumulator and snapshot included)
    steps on the port as it steps in JAX.
  - **Semantics on the port** (the JAX suite's cases): the deferred
    factors equal the eager ones at the window heads (1e-5), a stale
    chunk firing decomposes the snapshot (bit for bit an eager firing on
    it), the flags need their knobs, the defaults add no state, and a
    checkpoint round-trips while a bundle without the new keys loads with
    JAX's defaults; the epoch loop's fallback for a schedule that does
    not fit.
  - **Distributed** (children of ``test_torch_distributed``'s launcher, a
    conv net with four same-width Linears so chunks split buckets): 1 x 4,
    4 x 1 and 2 x 2 grids with chunks, staleness, deferred reduction and
    ``factor_batch_fraction``, each step against the single-device
    ``KFAC`` with the same knobs on the full batch, firing the grid's chunk
    plan (``item_chunk_plan``; factors 1e-5, gradients
    1e-4, ``nu`` 1e-5), every rank's record equal to rank 0's bit for bit,
    and a frozen window of chunk firings equal to a monolithic firing bit
    for bit on every rank. The world has a timeout: a collective called
    out of order hangs gloo instead of failing.

The children import this module and never JAX: its JAX imports stay inside
the functions that compare against JAX.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

FACTOR_TOL, PRECOND_TOL, NU_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flags(step, i_freq=4, k=1, deferred=False, staleness=0) -> dict:
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, i_freq, k, deferred_reduce=deferred,
        inv_staleness=staleness))


# ---------------------------------------------------------------------------
# Single device, against the JAX KFAC
# ---------------------------------------------------------------------------

JAX_CASES = {
    'deferred': dict(deferred_factor_reduction=True),
    'stale_k1': dict(inv_staleness=1),
    'stale_k2': dict(inv_staleness=1, inv_pipeline_chunks=2),
    'all_three': dict(inv_staleness=1, inv_pipeline_chunks=2,
                      deferred_factor_reduction=True),
}


@pytest.mark.parametrize('method', ['eigen_xla', 'cholesky'])
@pytest.mark.parametrize('case', list(JAX_CASES))
def test_matches_jax_kfac(case, method):
    from test_torch_inv_pipeline import METHODS, batches, run_pair
    knobs = {**JAX_CASES[case], **METHODS[method]}
    k = knobs.get('inv_pipeline_chunks', 1)
    recs = run_pair(knobs, lambda i: _flags(
        i, 4, k, knobs.get('deferred_factor_reduction', False),
        knobs.get('inv_staleness', 0)), batches(9))
    for i, r in enumerate(recs):
        assert r['factors'] <= FACTOR_TOL, (i, r['factors'])
        assert r['precond'] <= PRECOND_TOL, (i, r['precond'])
    tstate, jstate = recs[-1]['tstate'], recs[-1]['jstate']
    assert set(tstate) == set(jstate)
    if 'accum_decay' in tstate:
        assert float(tstate['accum_decay']) == float(jstate['accum_decay'])


def test_converted_jax_state_steps_as_in_jax():
    """A JAX state in mid-window (a non-zero accumulator, a snapshot older
    than the factors) converted to the port steps on as JAX does."""
    import jax
    import jax.numpy as jnp

    from test_torch_inv_pipeline import (DeepMLP, batches, jax_deep_mlp,
                                         rel)
    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    knobs = dict(JAX_CASES['all_three'], factor_update_freq=1,
                 inv_update_freq=4, factor_decay=0.5, damping=0.01, lr=0.1,
                 kl_clip=None, inverse_method='cholesky')
    xs = batches(8)
    jk = JKFAC(jax_deep_mlp(), **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = variables['params']

    def jstep(state, i):
        _, _, g, c, _ = jk.capture.loss_and_grads(
            lambda o: jnp.mean(o ** 2), params, jnp.asarray(xs[i]))
        return jk.step(state, g, c, **_flags(i, 4, 2, True, 1))

    for i in range(6):
        _, jstate = jstep(jstate, i)
    model = DeepMLP()
    model.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(model, device='cpu', **knobs)
    tstate = {**tk.init_state(), **convert.jax_state_to_torch(
        jax.tree.map(np.asarray, jstate), tk.specs)}
    assert float(tstate['accum_decay']) == float(jstate['accum_decay']) < 1
    back = convert.torch_state_to_jax(tstate, tk.specs)
    for key in convert.FACTOR_LAYOUT_KEYS:
        jax.tree.map(np.testing.assert_array_equal, back[key],
                     jax.tree.map(np.asarray, jstate[key]))
    for i in (6, 7):
        jp, jstate = jstep(jstate, i)
        _, _, g, c = tk.capture.loss_and_grads(
            lambda o: torch.mean(o ** 2), torch.from_numpy(xs[i]))
        tp, tstate = tk.step(tstate, g, c, **_flags(i, 4, 2, True, 1))
        jpt = convert.flax_to_torch(jax.tree.map(np.asarray, jp))
        assert max(rel(tp[n], jpt[n]) for n in jpt) <= PRECOND_TOL
        for key in convert.FACTOR_LAYOUT_KEYS:
            want = convert.jax_factors_to_torch(
                jax.tree.map(np.asarray, jstate[key]), tk.specs)
            assert max(rel(tstate[key][n][s], want[n][s])
                       for n in want for s in 'AG') <= FACTOR_TOL


# ---------------------------------------------------------------------------
# Semantics on the port (the JAX suite's cases)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The JAX suite's ``tests/test_preconditioner.py`` MLP shape: 6 ->
    8 (tanh) -> 4."""

    def __init__(self):
        super().__init__()
        self.d0 = nn.Linear(6, 8)
        self.head = nn.Linear(8, 4)

    def forward(self, x):
        return self.head(torch.tanh(self.d0(x)))


def _kfac(**kw):
    torch.manual_seed(0)
    return KFAC(MLP(), device='cpu', factor_update_freq=1,
                inv_update_freq=4, kl_clip=None, factor_decay=0.5,
                damping=0.01, lr=0.1, **kw)


def _batch(i):
    return torch.randn(16, 6, generator=torch.Generator().manual_seed(100 + i))


def _run_port(n_steps=9, **kw):
    kfac = _kfac(**kw)
    state = kfac.init_state()
    for i in range(n_steps):
        _, _, g, c = kfac.capture.loss_and_grads(
            lambda o: o.pow(2).mean(), _batch(i))
        _, state = kfac.step(state, g, c, **_flags(
            i, 4, kw.get('inv_pipeline_chunks', 1),
            kw.get('deferred_factor_reduction', False),
            kw.get('inv_staleness', 0)))
    return kfac, state


def test_deferred_equals_eager_at_window_heads():
    _, eager = _run_port()
    _, deferred = _run_port(deferred_factor_reduction=True)
    for name, f in eager['factors'].items():
        for side, t in f.items():
            got = deferred['factors'][name][side]
            assert float((got - t).abs().max()) <= FACTOR_TOL * float(
                t.abs().max())
    assert float(deferred['accum_decay']) == 1.0
    assert all(float(t.abs().max()) == 0.0
               for f in deferred['factor_accum'].values()
               for t in f.values())


def test_stale_firing_decomposes_the_snapshot():
    kfac, state = _run_port(n_steps=5, inv_staleness=1)
    frozen = state['frozen_factors']
    for name, f in frozen.items():
        for side, t in f.items():
            assert torch.equal(t, state['factors'][name][side])
    _, _, g, c = kfac.capture.loss_and_grads(lambda o: o.pow(2).mean(),
                                             _batch(5))
    flags = _flags(5, 4, 1, False, 1)
    assert flags.get('inv_chunk') == 0
    _, fired = kfac.step(state, g, c, **flags)
    drift = max(float((fired['factors'][n][s] - frozen[n][s]).abs().max())
                for n in frozen for s in 'AG')
    assert drift > 1e-4
    expected = kfac.update_inverses({**state, 'factors': frozen}, 0.01,
                                    chunk=0)
    live = kfac.update_inverses({**state, 'factors': fired['factors']},
                                0.01, chunk=0)
    for name, entry in expected.items():
        for key, t in entry.items():
            assert torch.equal(fired['inverses'][name][key], t)
    assert any(not torch.equal(live[n][k], t)
               for n, e in expected.items() for k, t in e.items())


def test_overlap_flags_require_matching_knobs():
    kfac = _kfac()
    state = kfac.init_state()
    _, _, g, c = kfac.capture.loss_and_grads(lambda o: o.pow(2).mean(),
                                             _batch(0))
    with pytest.raises(ValueError, match='deferred_factor_reduction'):
        kfac.step(state, g, c, factor_update=True, inv_update=False,
                  factor_reduce=True)
    with pytest.raises(ValueError, match='inv_staleness'):
        kfac.step(state, g, c, factor_update=True, inv_update=False,
                  factor_snapshot=True)
    for knobs in ({'deferred_factor_reduction': True},
                  {'inv_staleness': 1}):
        other = _kfac(**knobs)
        with pytest.raises(ValueError, match='static cadence'):
            other.step(other.init_state(), g, c)


def test_staleness_constructor_validation():
    with pytest.raises(ValueError, match='0 or 1'):
        _kfac(inv_staleness=2)
    with pytest.raises(ValueError, match='>= 2'):
        _kfac(inv_staleness=1, inv_pipeline_chunks=4)
    with pytest.raises(ValueError, match='>= 2'):
        KFAC(MLP(), device='cpu', inv_staleness=1, inv_update_freq=1)
    _kfac(inv_staleness=1, inv_pipeline_chunks=2)


def test_default_state_has_no_overlap_keys():
    assert set(_kfac().init_state()) == {'step', 'factors', 'inverses',
                                          'inv_chunk_phase'}
    state = _kfac(deferred_factor_reduction=True,
                  inv_staleness=1).init_state()
    assert set(state) == {'step', 'factors', 'inverses', 'inv_chunk_phase',
                          'factor_accum', 'accum_decay', 'frozen_factors'}


def test_state_dict_round_trip_and_old_bundle_defaults():
    kfac = _kfac(deferred_factor_reduction=True, inv_staleness=1)
    state = kfac.init_state()
    _, _, g, c = kfac.capture.loss_and_grads(lambda o: o.pow(2).mean(),
                                             _batch(0))
    _, state = kfac.step(state, g, c, factor_update=True, inv_update=True,
                         factor_reduce=True)
    _, state = kfac.step(state, g, c, factor_update=True, inv_update=False)
    sd = kfac.state_dict(state, include_inverses=True)
    assert {'factor_accum', 'accum_decay', 'frozen_factors'} <= set(sd)
    restored = kfac.load_state_dict(sd)
    for key in ('factor_accum', 'frozen_factors'):
        for name, f in state[key].items():
            for side, t in f.items():
                assert torch.equal(restored[key][name][side], t)
    assert float(restored['accum_decay']) == float(state['accum_decay']) < 1
    old = {k: v for k, v in sd.items()
           if k not in ('factor_accum', 'accum_decay', 'frozen_factors')}
    restored = kfac.load_state_dict(old)
    assert float(restored['accum_decay']) == 1.0
    assert all(float(t.abs().max()) == 0.0
               for f in restored['factor_accum'].values()
               for t in f.values())
    for name, f in restored['factors'].items():
        for side, t in f.items():
            assert torch.equal(restored['frozen_factors'][name][side], t)


def test_memory_usage_matches_jax():
    """Byte counts of the fp32 state against the JAX ``memory_usage`` on
    the JAX suite's deep MLP (the state keys alike)."""
    import jax
    import jax.numpy as jnp

    from test_torch_inv_pipeline import DeepMLP, jax_deep_mlp
    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    for knobs in ({}, {'inverse_method': 'cholesky'}):
        jk = JKFAC(jax_deep_mlp(), **knobs)
        _, jstate = jk.init(jax.random.PRNGKey(0), jnp.ones((2, 8)))
        tk = KFAC(DeepMLP(), device='cpu', **knobs)
        assert tk.memory_usage(tk.init_state()) == jk.memory_usage(jstate)


def test_staleness_that_does_not_fit_fires_monolithically():
    kfac = KFAC(MLP(), device='cpu', factor_update_freq=1,
                inv_update_freq=4, inv_pipeline_chunks=2, inv_staleness=1,
                deferred_factor_reduction=True)
    with pytest.warns(UserWarning, match='inv_staleness'):
        schedule = engine.epoch_schedule(kfac, 3)
    assert schedule == {'inv_pipeline_chunks': 1, 'inv_staleness': 0,
                        'deferred_reduce': True}
    seen = [engine.cadence_flags(s, 1, 3, **schedule) for s in range(6)]
    assert all(f.get('inv_chunk') is None for f in seen)
    assert [f['inv_update'] for f in seen] == [True, False, False, True,
                                               False, False]
    assert [f['factor_reduce'] for f in seen] == [True, False, False, True,
                                                  False, False]


# ---------------------------------------------------------------------------
# Distributed: 4-rank gloo worlds against the single-device port
# ---------------------------------------------------------------------------

class ChunkNet(nn.Module):
    """3 x 3 conv to 8 channels on 8 x 8 x 3 inputs, 2 x 2 average pool,
    then Linears 128 -> 16 -> 16 -> 16 -> 16 -> 10: the 16- and 17-dim
    buckets hold four factors each, so chunk plans split them."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.fc1 = nn.Linear(128, 16)
        self.fc2 = nn.Linear(16, 16)
        self.fc3 = nn.Linear(16, 16)
        self.fc4 = nn.Linear(16, 16)
        self.head = nn.Linear(16, 10)

    def forward(self, x):
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2).flatten(1)
        for fc in (self.fc1, self.fc2, self.fc3, self.fc4):
            x = torch.tanh(fc(x))
        return self.head(x)


WORLD, BATCH, STEPS, I_FREQ, LR = 4, 16, 9, 4, 0.1
WORLD_COMMON = dict(factor_update_freq=1, inv_update_freq=I_FREQ,
                    damping=0.003, lr=LR, kl_clip=0.001)
# (name, comm_method, grad_worker_fraction, grid, KFAC knobs)
WORLD_CASES = [
    ('hybrid_chunks_stale_deferred', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='eigen', eigh_method='xla', inv_pipeline_chunks=2,
          inv_staleness=1, deferred_factor_reduction=True)),
    ('mem_opt_chunks_deferred_newton', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='newton', inv_pipeline_chunks=2,
          deferred_factor_reduction=True)),
    ('comm_opt_chunks4_deferred_packed', 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='cholesky', inv_pipeline_chunks=4,
          inv_staleness=0, deferred_factor_reduction=True,
          symmetry_aware_comm=True)),
    ('hybrid_fraction_half', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='eigen', eigh_method='xla',
          factor_batch_fraction=0.5)),
    ('mem_opt_fraction_quarter_deferred', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='cholesky', factor_batch_fraction=0.25,
          deferred_factor_reduction=True, inv_pipeline_chunks=2)),
]
WORLD_IDS = [c[0] for c in WORLD_CASES]


def _world_case(name):
    return next(c for c in WORLD_CASES if c[0] == name)


def _case_flags(knobs, step) -> dict:
    return _flags(step, I_FREQ, knobs.get('inv_pipeline_chunks', 1),
                  knobs.get('deferred_factor_reduction', False),
                  knobs.get('inv_staleness', 0))


def _world_run(model, kfac, step_fn, x, y, knobs) -> dict:
    """STEPS steps of K-FAC + SGD: every step's factors, preconditioned
    gradients and KL-clip scale."""
    rec = {}
    for step in range(STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        precond, nu, factors = step_fn(grads, captures,
                                       _case_flags(knobs, step))
        rec[f'nu/{step}'] = np.asarray(float(nu))
        for n, f in factors.items():
            for side, t in f.items():
                rec[f'factor/{step}/{n}/{side}'] = t.numpy().copy()
        for n, g in precond.items():
            rec[f'precond/{step}/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    return rec


def _world_model(params):
    model = ChunkNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _frozen_window_equal(dk, state) -> bool:
    """A window of chunk firings over the state's factors against a
    monolithic firing, bit for bit (both from the stored stacks)."""
    kfac = dk.kfac
    if not kfac.pipelined_firing:
        return True
    mono = dk.update_inverses(state['factors'], None, state['inv_stacks'])
    cur = {k: state[k] for k in ('inv_stacks', 'diag_inv')}
    for j in range(kfac.inv_pipeline_chunks):
        cur = dk.update_inverses(state['factors'], None, cur['inv_stacks'],
                                 chunk=j, prev_diag=cur['diag_inv'])
    return all(torch.equal(cur['inv_stacks'][d][k], t)
               for d, e in mono['inv_stacks'].items() for k, t in e.items())


def worker_main():
    """One rank (started by ``test_torch_distributed._start_world`` with
    ``module='test_torch_overlap'``)."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu', timeout=120)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    params = {k[len('p/'):]: data[k] for k in data.files
              if k.startswith('p/')}
    x, y = torch.from_numpy(data['x']), torch.from_numpy(data['y'])
    local = launch.process_local_slice(len(x))
    out = {}
    for name in cfg['cases']:
        _, comm, frac, _, knobs = _world_case(name)
        model = _world_model(params)
        kfac = KFAC(model, device='cpu', **WORLD_COMMON, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, flags, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             **flags)
            return precond, dk.last_nu, box['state']['factors']

        rec = _world_run(model, kfac, step_fn, x[local], y[local], knobs)
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        rec['frozen_window_equal'] = np.asarray(
            _frozen_window_equal(dk, box['state']))
        state = box['state']
        loaded = dk.load_state_dict(dk.state_dict(state))
        rec['reload_same'] = np.asarray(all(
            torch.equal(loaded[key][n][s], state[key][n][s])
            for key in ('factor_accum', 'frozen_factors') if key in state
            for n in state[key] for s in 'AG'))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def port_reference(name, params, x, y) -> dict:
    """The port's single-device ``KFAC`` with the case's knobs on the full
    batch. Under chunks it fires the grid's plan
    (``parallel.distributed.item_chunk_plan``): the grid's unit is a slot
    offset and the single device's a matrix, so their own plans put
    different matrices in a chunk, and mid-window the two would hold
    different inverses."""
    from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
    _, _, _, grid, knobs = _world_case(name)
    model = _world_model(params)
    kfac = KFAC(model, device='cpu', **WORLD_COMMON, **knobs)
    if kfac.pipelined_firing:
        assignment = D.assign_work(kfac, *grid)
        plan = D.item_chunk_plan(assignment,
                                 D.plan_firing_chunks(kfac, assignment))
        kfac.inverse_chunk_plan = lambda factors: plan
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, flags):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          **flags)
        return precond, kfac.last_nu, box['state']['factors']

    return _world_run(model, kfac, step_fn, torch.from_numpy(x),
                      torch.from_numpy(y), knobs)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    from test_torch_distributed import _finish_world, _start_world
    tmp = tmp_path_factory.mktemp('overlap_world')
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    params = {k: v.numpy().copy()
              for k, v in ChunkNet().state_dict().items()}
    x = rng.normal(size=(BATCH, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH)
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, WORLD, WORLD_IDS, data,
                         module='test_torch_overlap')
    try:
        refs = {name: port_reference(name, params, x, y)
                for name in WORLD_IDS}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    return ranks, refs


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def test_world_children_never_import_jax(world):
    ranks, _ = world
    assert all(int(r['jax_modules']) == 0 for r in ranks)


@pytest.mark.parametrize('name', WORLD_IDS)
def test_world_matches_single_device(world, name):
    ranks, refs = world
    rank0, ref = ranks[0], refs[name]
    assert tuple(rank0[f'{name}|grid']) == _world_case(name)[3]
    tol = {'factor': FACTOR_TOL, 'precond': PRECOND_TOL, 'nu': NU_TOL}
    for key, want in ref.items():
        err = _rel(rank0[f'{name}|{key}'], want)
        assert err <= tol[key.split('/')[0]], (key, err)


@pytest.mark.parametrize('name', WORLD_IDS)
def test_world_ranks_agree_exactly(world, name):
    ranks, _ = world
    keys = [k for k in ranks[0] if k.startswith(f'{name}|')]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize('name', WORLD_IDS)
def test_world_frozen_window_and_reload(world, name):
    ranks, _ = world
    for r in ranks:
        assert bool(r[f'{name}|frozen_window_equal'])
        assert bool(r[f'{name}|reload_same'])
