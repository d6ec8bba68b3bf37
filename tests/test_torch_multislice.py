"""The multi-slice topology and the hierarchical factor reduction of the
torch port, on the CPU.

  - The slice / rank arithmetic (``multislice.slice_rank_groups``,
    ``slice_of_rank``) against the JAX functions over a grid of worlds,
    errors included.
  - A 4-rank gloo world (children of ``test_torch_distributed``'s
    launcher) as 2 slices x 2 ranks, on the JAX suite's MLP (``_Net`` of
    ``tests/test_multislice.py``), 9 steps with windows of 4:
    ``--hierarchical-reduce`` against the flat reduce on the same layout
    (factors at every window head within 1e-5, preconditioned gradients
    within 1e-4, ``nu`` 1e-5, of the largest reference entry), both
    against the JAX ``DistributedKFAC`` on a 2-slice mesh of 4 forced host
    devices (the JAX oracle is ``test_hier_matches_flat_reduce_on_same_
    sliced_mesh``) and against the port's single-device ``KFAC`` (the
    hierarchical run against ``deferred_factor_reduction``, which it equals
    by EMA linearity), every step at those tolerances. Also the groups
    each rank joins, a low-rank case on two slices, ``num_slices=1`` bit
    for bit against a ``DistributedKFAC`` built without the argument, the
    refusal on a flat world, and a checkpoint of another slice count
    rebuilding its inverses.
  - The other two refusals (with ``deferred_factor_reduction``, and the
    single-device step) and the CLIs' checks, and a two-rank run of the LM
    CLI with ``--num-slices 2 --hierarchical-reduce`` against the same run
    with the flat reduce.

The children import this module and never JAX.
"""

import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch import multislice
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


# ---------------------------------------------------------------------------
# Slice arithmetic against JAX
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ('ok', fn(*args))
    except ValueError as e:
        return ('error', str(e))


@pytest.mark.parametrize('world', [1, 2, 4, 6, 8, 12])
def test_slice_arithmetic_matches_jax(world):
    from distributed_kfac_pytorch_tpu.multislice import mesh as jmesh
    for n in range(0, 5):
        assert _outcome(multislice.slice_rank_groups, world, n) == \
            _outcome(jmesh.slice_rank_groups, world, n), (world, n)
        for rank in (-1, 0, world - 1, world):
            args = (rank, world, n)
            assert _outcome(multislice.slice_of_rank, *args) == \
                _outcome(jmesh.slice_of_rank, *args), args
    assert multislice.slice_count() == 1


# ---------------------------------------------------------------------------
# The 2 x 2 world
# ---------------------------------------------------------------------------

class SliceNet(nn.Module):
    """The JAX suite's ``_Net``: Linears 8 -> 16 -> 16 -> 12 -> 16 -> 4
    with ReLU (repeated and odd dims leave padding slots in the buckets)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16)
        self.fc2 = nn.Linear(16, 16)
        self.fc3 = nn.Linear(16, 12)
        self.fc4 = nn.Linear(12, 16)
        self.head = nn.Linear(16, 4)

    def forward(self, x):
        for fc in (self.fc1, self.fc2, self.fc3, self.fc4):
            x = F.relu(fc(x))
        return self.head(x)


def jax_slice_net():
    import flax.linen as fnn

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for name, width in (('fc1', 16), ('fc2', 16), ('fc3', 12),
                                ('fc4', 16)):
                x = fnn.relu(fnn.Dense(width, name=name)(x))
            return fnn.Dense(4, name='head')(x)

    return Net()


WORLD, SLICES, BATCH, STEPS, I_FREQ, LR = 4, 2, 32, 9, 4, 0.05
COMMON = dict(factor_update_freq=1, inv_update_freq=I_FREQ, damping=0.003,
              lr=LR, kl_clip=0.001, inverse_method='eigen',
              eigh_method='xla')
# (name, comm_method, fraction, num_slices, knobs)
CASES = [
    ('flat_hybrid', 'hybrid-opt', 0.5, 2, {}),
    ('hier_hybrid', 'hybrid-opt', 0.5, 2, dict(hierarchical_reduce=True)),
    ('hier_comm_packed', 'comm-opt', 0.0, 2,
     dict(hierarchical_reduce=True, symmetry_aware_comm=True)),
    ('hier_lowrank', 'comm-opt', 0.0, 2,
     dict(hierarchical_reduce=True, inv_lowrank_rank=4,
          inv_lowrank_dim_threshold=16)),
    ('one_slice', 'hybrid-opt', 0.5, 1, {}),
]
CASE_IDS = [c[0] for c in CASES]
JAX_CASES = ('flat_hybrid', 'hier_hybrid')


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _flags(knobs, step):
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, I_FREQ,
        deferred_reduce=bool(knobs.get('hierarchical_reduce')
                             or knobs.get('deferred_factor_reduction'))))


def _run(model, kfac, step_fn, x, y, knobs) -> dict:
    rec = {}
    for step in range(STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.mse_loss(out, y), x)
        precond, nu, factors = step_fn(grads, captures, _flags(knobs, step))
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


def _model(params):
    model = SliceNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def worker_main():
    """One rank (started by ``test_torch_distributed._start_world`` with
    ``module='test_torch_multislice'``)."""
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

    def build(name, **over):
        _, comm, frac, slices, knobs = _case(name)
        model = _model(params)
        kfac = KFAC(model, device='cpu', **COMMON, **knobs)
        kw = dict(comm_method=comm, grad_worker_fraction=frac)
        kw.update(over)
        if 'num_slices' not in over and slices != 1:
            kw['num_slices'] = slices
        return model, kfac, DistributedKFAC(kfac, **kw)

    def world_run(name, **over):
        model, kfac, dk = build(name, **over)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, flags):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             **flags)
            return precond, dk.last_nu, box['state']['factors']

        rec = _run(model, kfac, step_fn, x[local], y[local], _case(name)[4])
        return dk, box['state'], rec

    for name in cfg['cases']:
        dk, state, rec = world_run(name)
        g = dk.groups
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols, dk.num_slices])
        rec['row_col_slice'] = np.asarray([dk.row, dk.col, g.slice])
        rec['inv_ranks'] = np.asarray(g.inv_ranks)
        rec['grad_ranks'] = np.asarray(g.grad_ranks)
        rec['slice_ranks'] = np.asarray(g.slice_ranks or (-1,))
        rec['cross_ranks'] = np.asarray(g.cross_ranks or (-1,))
        layout = dk.state_dict(state)['inv_layout']
        rec['layout'] = np.asarray([layout['row'], layout['n_rows'],
                                    layout.get('num_slices', 1),
                                    layout.get('slice', -1)])
        if name == 'one_slice':
            # Built without num_slices; the same with num_slices=1.
            _, _, explicit = world_run(name, num_slices=1)
            rec['same_as_default'] = np.asarray(all(
                np.array_equal(rec[k], explicit[k]) for k in explicit))
        if name == 'flat_hybrid':
            # A bundle of another slice count rebuilds its inverses.
            _, _, flat1 = build('one_slice')
            loaded = flat1.load_state_dict(dk.state_dict(state))
            fresh = flat1.update_inverses(state['factors'])
            rec['cross_slices_rebuilt'] = np.asarray(all(
                torch.equal(loaded['inv_stacks'][d][k], t)
                for d, e in fresh['inv_stacks'].items()
                for k, t in e.items()))
            reload = dk.load_state_dict(dk.state_dict(state))
            rec['reload_same'] = np.asarray(all(
                torch.equal(reload['inv_stacks'][d][k], t)
                for d, e in state['inv_stacks'].items()
                for k, t in e.items()))
            try:
                build('hier_hybrid', num_slices=1)
                rec['flat_refused'] = np.asarray('')
            except ValueError as e:
                rec['flat_refused'] = np.asarray(str(e))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def port_reference(name, params, x, y) -> dict:
    """The port's single-device ``KFAC`` on the full batch; a
    hierarchical case runs ``deferred_factor_reduction`` in its place."""
    knobs = dict(_case(name)[4])
    if knobs.pop('hierarchical_reduce', False):
        knobs['deferred_factor_reduction'] = True
    model = _model(params)
    kfac = KFAC(model, device='cpu', **COMMON, **knobs)
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, flags):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          **flags)
        return precond, kfac.last_nu, box['state']['factors']

    return _run(model, kfac, step_fn, torch.from_numpy(x),
                torch.from_numpy(y), _case(name)[4])


def jax_reference(name, flax_params, x, y) -> dict:
    """The JAX ``DistributedKFAC`` on a 2-slice mesh of 4 host devices with
    the same cadence flags; each step's preconditioned gradients are read
    from the optimizer's state."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu import launch as jlaunch
    from distributed_kfac_pytorch_tpu.multislice import mesh as jmesh
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu_torch import convert

    _, comm, frac, slices, knobs = _case(name)
    kfac = JKFAC(jax_slice_net(), **COMMON, **knobs)
    jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x))
    mesh = jmesh.make_multislice_mesh(
        jax.devices()[:WORLD], num_slices=slices,
        comm_method=JCommMethod[comm.upper().replace('-', '_')],
        grad_worker_fraction=frac)
    params = jlaunch.replicate_on_mesh(
        mesh, jax.tree.map(jnp.asarray, flax_params))
    dk = JD.DistributedKFAC(kfac, mesh, params)
    kstate = dk.init_state(params)
    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    step = dk.build_train_step(
        lambda out, batch: jnp.mean((out - batch[1]) ** 2), tx,
        donate=False)
    opt_state = tx.init(params)
    batch = (jnp.asarray(x), jnp.asarray(y))
    specs = KFAC(SliceNet(), device='cpu').specs
    rec, extra = {}, {}
    for i in range(STEPS):
        params, opt_state, kstate, extra, _ = step(
            params, opt_state, kstate, extra, batch,
            {'lr': LR, 'damping': COMMON['damping']}, **_flags(knobs, i))
        factors = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, kstate['factors']), specs)
        for n, f in factors.items():
            for side, t in f.items():
                rec[f'factor/{i}/{n}/{side}'] = t.numpy()
        for n, t in convert.flax_to_torch(
                jax.tree.map(np.asarray, opt_state)).items():
            rec[f'precond/{i}/{n}'] = t.numpy()
    return rec


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    import jax

    from distributed_kfac_pytorch_tpu_torch import convert
    from test_torch_distributed import _finish_world, _start_world
    tmp = tmp_path_factory.mktemp('multislice_world')
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 8)).astype(np.float32)
    y = rng.normal(size=(BATCH, 4)).astype(np.float32)
    flax_params = jax.tree.map(np.asarray, jax_slice_net().init(
        jax.random.PRNGKey(0), x[:1])['params'])
    params = {k: v.numpy() for k, v in
              convert.flax_to_torch(flax_params).items()}
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, WORLD, CASE_IDS, data,
                         module='test_torch_multislice')
    try:
        port = {name: port_reference(name, params, x, y)
                for name in CASE_IDS if name != 'one_slice'}
        ref = {name: jax_reference(name, flax_params, x, y)
               for name in JAX_CASES}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    return ranks, port, ref


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _check(got: dict, name: str, want: dict, what: str,
           window_heads_only: bool = False) -> None:
    tol = {'factor': FACTOR_TOL, 'precond': PRECOND_TOL, 'nu': NU_TOL}
    for key, w in want.items():
        kind, step = key.split('/')[:2]
        if window_heads_only and kind == 'factor' \
                and int(step) % I_FREQ != 0:
            continue
        err = _rel(got[f'{name}|{key}'], w)
        assert err <= tol[kind], (what, key, err)


def test_world_children_never_import_jax(world):
    ranks, _, _ = world
    assert all(int(r['jax_modules']) == 0 for r in ranks)


def test_world_groups_follow_the_slices(world):
    """Slice s holds ranks 2s, 2s+1. Under HYBRID_OPT 0.5 each slice is a
    2 x 1 grid: 4 global rows, one column spanning both slices; under
    COMM_OPT a 1 x 2 grid: 2 global rows, columns {0, 2} and {1, 3}."""
    ranks, _, _ = world
    for rank, r in enumerate(ranks):
        s, local = divmod(rank, 2)
        assert tuple(r['flat_hybrid|grid']) == (4, 1, 2)
        assert tuple(r['flat_hybrid|row_col_slice']) == (2 * s + local, 0, s)
        assert tuple(r['flat_hybrid|inv_ranks']) == (rank,)
        assert tuple(r['flat_hybrid|grad_ranks']) == (0, 1, 2, 3)
        assert tuple(r['flat_hybrid|slice_ranks']) == (2 * s, 2 * s + 1)
        assert tuple(r['flat_hybrid|cross_ranks']) == (local, 2 + local)
        assert tuple(r['flat_hybrid|layout']) == (2 * s + local, 4, 2, s)
        assert tuple(r['hier_comm_packed|grid']) == (2, 2, 2)
        assert tuple(r['hier_comm_packed|row_col_slice']) == (s, local, s)
        assert tuple(r['hier_comm_packed|inv_ranks']) == (2 * s, 2 * s + 1)
        assert tuple(r['hier_comm_packed|grad_ranks']) == (local, 2 + local)
        assert tuple(r['one_slice|grid']) == (2, 2, 1)
        assert tuple(r['one_slice|slice_ranks']) == (-1,)
        assert tuple(r['one_slice|layout']) == (r['one_slice|layout'][0], 2,
                                                1, -1)


@pytest.mark.parametrize('name', ['hier_hybrid', 'hier_comm_packed',
                                  'hier_lowrank'])
def test_world_hierarchical_matches_flat(world, name):
    """Hierarchical against the flat reduce of the same layout: the flat
    world's record where one exists, else the single-device eager run."""
    ranks, port, _ = world
    if name == 'hier_hybrid':
        flat = {k.split('|', 1)[1]: v for k, v in ranks[0].items()
                if k.startswith('flat_hybrid|') and '/' in k}
        _check(ranks[0], name, flat, 'flat reduce', window_heads_only=True)
    _check(ranks[0], name, port[name], 'single-device deferred reduce')


@pytest.mark.parametrize('name', ['flat_hybrid'])
def test_world_flat_slices_match_single_device(world, name):
    ranks, port, _ = world
    _check(ranks[0], name, port[name], 'single-device KFAC')


@pytest.mark.parametrize('name', JAX_CASES)
def test_world_matches_jax_sliced_distributed(world, name):
    ranks, _, ref = world
    _check(ranks[0], name, ref[name], 'JAX DistributedKFAC')


@pytest.mark.parametrize('name', CASE_IDS)
def test_world_ranks_agree_exactly(world, name):
    ranks, _, _ = world
    keys = [k for k in ranks[0] if k.startswith(f'{name}|')
            and '/' in k]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_world_one_slice_checkpoint_and_refusal(world):
    ranks, _, _ = world
    for r in ranks:
        assert bool(r['one_slice|same_as_default'])
        assert bool(r['flat_hybrid|cross_slices_rebuilt'])
        assert bool(r['flat_hybrid|reload_same'])
        assert 'requires num_slices > 1' in str(r['flat_hybrid|flat_refused'])


# ---------------------------------------------------------------------------
# Refusals and the CLIs
# ---------------------------------------------------------------------------

def test_hierarchical_refusals():
    with pytest.raises(ValueError, match='mutually exclusive'):
        KFAC(SliceNet(), device='cpu', hierarchical_reduce=True,
             deferred_factor_reduction=True)
    kfac = KFAC(SliceNet(), device='cpu', hierarchical_reduce=True)
    state = kfac.init_state()
    _, _, grads, caps = kfac.capture.loss_and_grads(
        lambda out: out.square().mean(), torch.zeros(2, 8))
    with pytest.raises(ValueError, match='num_slices > 1'):
        kfac.step(state, grads, caps, factor_update=True)
    assert engine.epoch_schedule(kfac, 4)['deferred_reduce']
    flags = engine.cadence_flags(4, 1, 4, **engine.epoch_schedule(kfac, 4))
    assert flags['factor_reduce'] and flags['inv_update']


def test_clis_check_the_slice_count():
    """A single process has one rank: ``--num-slices 2`` does not divide
    it (the JAX CLIs' mesh check), and ``--hierarchical-reduce`` alone
    refuses at the first step."""
    from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
    cfg = {'arch': 'transformer', 'emsize': 16, 'nheads': 2, 'nlayers': 1,
           'synthetic_vocab': 40, 'synthetic_size': 2000, 'bptt': 8,
           'batch_size': 4, 'max_steps': 2, 'epochs': 1, 'quiet': True}
    with pytest.raises(ValueError, match='does not divide world size 1'):
        lm.train({**cfg, 'num_slices': 2}, device='cpu')
    with pytest.raises(ValueError, match='num_slices > 1'):
        lm.train({**cfg, 'hierarchical_reduce': True}, device='cpu')
    args = lm.build_parser().parse_args(
        ['--num-slices', '2', '--hierarchical-reduce', '--inv-lowrank-rank',
         '32', '--inv-lowrank-dim-threshold', '512'])
    assert (args.num_slices, args.hierarchical_reduce, args.inv_lowrank_rank,
            args.inv_lowrank_dim_threshold) == (2, True, 32, 512)


LM_CLI = ("import json, torch\n"
          "torch.set_num_threads(1)\n"
          "from distributed_kfac_pytorch_tpu_torch import "
          "train_language_model as T\n"
          "r = T.train({'arch': 'transformer', 'emsize': 16, 'nheads': 2, "
          "'nlayers': 1, 'tied': True, 'synthetic_vocab': 40, "
          "'synthetic_size': 2000, 'bptt': 8, 'batch_size': 4, "
          "'max_steps': 6, 'epochs': 1, 'kfac_update_freq': 3, "
          "'inverse_method': 'eigen', 'eigh_method': 'xla', 'quiet': True, "
          "'num_slices': 2, 'hierarchical_reduce': HIER}, device='cpu')\n"
          "k = r['state'].kfac\n"
          "print('RESULT', json.dumps({'losses': r['losses'], "
          "'fired': r['fired'], 'slices': k.num_slices, "
          "'slice': k.groups.slice}))\n")


def test_lm_cli_two_ranks_hierarchical_against_flat():
    from test_torch_distributed import run_two_ranks
    hier = run_two_ranks(LM_CLI.replace('HIER', 'True'))
    flat = run_two_ranks(LM_CLI.replace('HIER', 'False'))
    assert [r['slice'] for r in hier] == [0, 1]
    assert all(r['slices'] == 2 for r in hier + flat)
    assert hier[0]['losses'] == hier[1]['losses']
    assert len(hier[0]['losses']) == 6
    assert all(math.isfinite(v) for v in hier[0]['losses'])
    np.testing.assert_allclose(hier[0]['losses'], flat[0]['losses'],
                               rtol=1e-5)
    assert hier[0]['fired'] == ['inverse+reduce', 'factor', 'factor',
                                'inverse+reduce', 'factor', 'factor']
