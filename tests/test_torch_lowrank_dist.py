"""The randomized low-rank inverse under the port's ``DistributedKFAC``, on
the CPU: a 4-rank gloo world (children of ``test_torch_distributed``'s
launcher) of an MLP whose 40- and 41-wide sides engage at threshold 32,
rank 8, on three grids, each step against the port's single-device
``KFAC`` with the same knobs on the full batch (firing the grid's chunk
plan), and against the JAX ``DistributedKFAC`` on a forced 4-device host
mesh:

  - ``hybrid_eigen``: HYBRID_OPT 2 x 2, ``'eigen'`` with the library eigh
    (low-rank / eigen layers: the truncated stock precondition);
  - ``comm_chunks_cholesky``: COMM_OPT 1 x 4, ``'cholesky'``,
    ``inv_pipeline_chunks=2`` (mixed low-rank / Cholesky layers, the
    truncated side baked; (d, r) row stacks through the chunk firings);
  - ``mem_stale_bf16``: MEM_OPT 4 x 1, ``inv_staleness=1`` with bf16
    inverse storage (strict fp32 precondition operands).

Tolerances, the same against the single-device port and against JAX:
factors 1e-5 of their largest entry, each layer's preconditioned
gradient by relative norm 5e-3 and ``nu`` 1e-3. The warm subspace step
and the truncation carry the fp32 summation-order noise of the factors
(the world's all_reduce, other stacking) into the preconditioned
gradients at up to 7e-4 here (within the 2e-2 warm-polish tolerance of
``tests/test_torch_kfac.py``). With bf16 inverses, the 2e-2 of the
bf16 run of ``tests/test_torch_mixed_precision.py`` for factors and for
each preconditioned gradient
against the step's largest entry (a stored inverse whose fp32 source
differs by the fp32 noise may round to the neighbouring bf16 value: up to
1.3e-2 measured after five steps), ``nu`` 1e-2. Every rank's
record equals rank 0's bit for bit.

Each world also round-trips its checkpoint (the (d, r) bases bit for
bit), loads a bundle of another grid (rebuilt cold through the seeded
sketch, equal to a fresh rebuild bit for bit), and ``convert`` carries a
low-rank conv state both ways (the A basis permuted on its rows only).

The children import this module and never JAX.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

#: (factors, preconditioned gradients, nu) for fp32 and bf16 inverses.
TOLS = {False: (1e-5, 5e-3, 1e-3), True: (2e-2, 2e-2, 1e-2)}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class LowrankNet(nn.Module):
    """Linears 8 -> 40 -> 40 -> 12 -> 4 with tanh: A dims 9, 41, 41, 13,
    G dims 40, 40, 12, 4."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 40)
        self.fc2 = nn.Linear(40, 40)
        self.fc3 = nn.Linear(40, 12)
        self.head = nn.Linear(12, 4)

    def forward(self, x):
        for fc in (self.fc1, self.fc2, self.fc3):
            x = torch.tanh(fc(x))
        return self.head(x)


def jax_lowrank_net():
    import flax.linen as fnn

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for name, width in (('fc1', 40), ('fc2', 40), ('fc3', 12)):
                x = fnn.tanh(fnn.Dense(width, name=name)(x))
            return fnn.Dense(4, name='head')(x)

    return Net()


WORLD, BATCH, STEPS, I_FREQ, LR = 4, 32, 9, 4, 0.1
COMMON = dict(factor_update_freq=1, inv_update_freq=I_FREQ, damping=0.003,
              lr=LR, kl_clip=0.001, inv_lowrank_rank=8,
              inv_lowrank_dim_threshold=32)
# (name, comm_method, grad_worker_fraction, grid, knobs, against JAX)
CASES = [
    ('hybrid_eigen', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='eigen', eigh_method='xla'), True),
    ('comm_chunks_cholesky', 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='cholesky', inv_pipeline_chunks=2), True),
    ('mem_stale_bf16', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='eigen', eigh_method='xla', inv_staleness=1,
          inv_dtype='bfloat16', precond_compute_dtype='float32'), True),
]
CASE_IDS = [c[0] for c in CASES]


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _torch_knobs(knobs):
    return {k: getattr(torch, v) if k in ('inv_dtype',
                                          'precond_compute_dtype') else v
            for k, v in knobs.items()}


def _flags(knobs, step):
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, I_FREQ, knobs.get('inv_pipeline_chunks', 1),
        inv_staleness=knobs.get('inv_staleness', 0)))


def _run(model, kfac, step_fn, x, y, knobs) -> dict:
    """STEPS steps of K-FAC + SGD: every step's factors, preconditioned
    gradients and KL-clip scale."""
    rec = {}
    for step in range(STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.mse_loss(out, y), x)
        precond, nu, factors = step_fn(grads, captures, _flags(knobs, step))
        rec[f'nu/{step}'] = np.asarray(float(nu))
        for n, f in factors.items():
            for side, t in f.items():
                rec[f'factor/{step}/{n}/{side}'] = t.float().numpy().copy()
        for n, g in precond.items():
            rec[f'precond/{step}/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    return rec


def _model(params):
    model = LowrankNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def worker_main():
    """One rank (started by ``test_torch_distributed._start_world`` with
    ``module='test_torch_lowrank_dist'``)."""
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
        _, comm, frac, _, knobs, _ = _case(name)
        model = _model(params)
        kfac = KFAC(model, device='cpu', **COMMON, **_torch_knobs(knobs))
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, flags, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             **flags)
            return precond, dk.last_nu, box['state']['factors']

        rec = _run(model, kfac, step_fn, x[local], y[local], knobs)
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        state = box['state']
        shapes = {d: tuple(e['Q'].shape) for d, e in
                  state['inv_stacks'].items() if 'Q' in e}
        rec['q_shapes'] = np.asarray(sorted(
            (int(d), *s) for d, s in shapes.items()))
        # A round trip keeps every stack bit for bit.
        loaded = dk.load_state_dict(dk.state_dict(state))
        rec['reload_same'] = np.asarray(all(
            torch.equal(loaded['inv_stacks'][d][k], t)
            for d, e in state['inv_stacks'].items() for k, t in e.items()))
        # Another grid's bundle rebuilds cold (the seeded sketch), as a
        # fresh rebuild of that grid does.
        other = DistributedKFAC(
            KFAC(_model(params), device='cpu', **COMMON,
                 **_torch_knobs(knobs)),
            comm_method='mem-opt' if comm != 'mem-opt' else 'comm-opt')
        cross = other.load_state_dict(dk.state_dict(state))
        fresh = other.update_inverses(state['factors'])
        rec['cross_cold'] = np.asarray(all(
            torch.equal(cross['inv_stacks'][d][k], t)
            for d, e in fresh['inv_stacks'].items() for k, t in e.items()))
        rec['lowrank_dims'] = np.asarray(sorted(
            int(d) for d in state['inv_stacks']
            if kfac.method_for_dim(int(d)) == 'lowrank'))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def port_reference(name, params, x, y) -> dict:
    """The port's single-device ``KFAC`` with the case's knobs on the full
    batch, firing the grid's chunk plan under chunks or staleness."""
    from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
    _, _, _, grid, knobs, _ = _case(name)
    model = _model(params)
    kfac = KFAC(model, device='cpu', **COMMON, **_torch_knobs(knobs))
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

    return _run(model, kfac, step_fn, torch.from_numpy(x),
                torch.from_numpy(y), knobs)


def jax_reference(name, flax_params, x, y) -> dict:
    """The JAX ``DistributedKFAC`` on a 4-device mesh of the case's
    strategy, with the same cadence flags; the optimizer keeps each step's
    preconditioned gradients in its state, so they are read exactly."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu_torch import convert

    _, comm, frac, _, knobs, _ = _case(name)
    jknobs = {k: getattr(jnp, v) if k in ('inv_dtype',
                                          'precond_compute_dtype') else v
              for k, v in knobs.items()}
    kfac = JKFAC(jax_lowrank_net(), **COMMON, **jknobs)
    jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x))
    mesh = JD.make_kfac_mesh(
        devices=jax.devices()[:WORLD],
        comm_method=JCommMethod[comm.upper().replace('-', '_')],
        grad_worker_fraction=frac)
    dk = JD.DistributedKFAC(kfac, mesh, flax_params)
    kstate = dk.init_state(flax_params)
    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    step = dk.build_train_step(
        lambda out, batch: jnp.mean((out - batch[1]) ** 2), tx,
        donate=False)
    params = jax.tree.map(jnp.asarray, flax_params)
    opt_state = tx.init(params)
    batch = (jnp.asarray(x), jnp.asarray(y))
    specs = KFAC(LowrankNet(), device='cpu').specs
    rec, extra = {}, {}
    for i in range(STEPS):
        params, opt_state, kstate, extra, _ = step(
            params, opt_state, kstate, extra, batch,
            {'lr': LR, 'damping': COMMON['damping']}, **_flags(knobs, i))
        factors = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, kstate['factors']), specs)
        for n, f in factors.items():
            for side, t in f.items():
                rec[f'factor/{i}/{n}/{side}'] = t.float().numpy()
        for n, t in convert.flax_to_torch(
                jax.tree.map(np.asarray, opt_state)).items():
            rec[f'precond/{i}/{n}'] = t.numpy()
    return rec


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    import jax

    from distributed_kfac_pytorch_tpu_torch import convert
    from test_torch_distributed import _finish_world, _start_world
    tmp = tmp_path_factory.mktemp('lowrank_world')
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 8)).astype(np.float32)
    y = rng.normal(size=(BATCH, 4)).astype(np.float32)
    flax_params = jax.tree.map(np.asarray, jax_lowrank_net().init(
        jax.random.PRNGKey(0), x[:1])['params'])
    params = {k: v.numpy() for k, v in
              convert.flax_to_torch(flax_params).items()}
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, WORLD, CASE_IDS, data,
                         module='test_torch_lowrank_dist')
    try:
        port = {name: port_reference(name, params, x, y)
                for name in CASE_IDS}
        ref = {c[0]: jax_reference(c[0], flax_params, x, y)
               for c in CASES if c[5]}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    return ranks, port, ref


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def test_world_children_never_import_jax(world):
    ranks, _, _ = world
    assert all(int(r['jax_modules']) == 0 for r in ranks)


@pytest.mark.parametrize('name', CASE_IDS)
def test_world_grid_and_lowrank_stacks(world, name):
    ranks, _, _ = world
    r0 = ranks[0]
    assert tuple(r0[f'{name}|grid']) == _case(name)[3]
    assert list(r0[f'{name}|lowrank_dims']) == [40, 41]
    shapes = {row[0]: tuple(row[1:]) for row in r0[f'{name}|q_shapes']}
    for dim, (_, d, r) in shapes.items():
        assert (d, r) == ((dim, 8) if dim in (40, 41) else (dim, dim))


def _check_steps(got: dict, want: dict, name: str, what: str) -> None:
    """Every step's factors, preconditioned gradients and ``nu`` of
    ``got`` (a rank's record, keyed ``name|...``) against ``want``, at the
    case's tolerances (module docstring)."""
    bf16 = 'inv_dtype' in _case(name)[4]
    f_tol, p_tol, nu_tol = TOLS[bf16]
    for step in range(STEPS):
        keys = [k for k in want if k.split('/')[1] == str(step)]
        big = max(float(np.abs(want[k]).max()) for k in keys
                  if k.startswith('precond/'))
        for key in keys:
            g, w = got[f'{name}|{key}'], want[key]
            if key.startswith('factor/'):
                err, tol = _rel(g, w), f_tol
            elif key.startswith('nu/'):
                err, tol = _rel(g, w), nu_tol
            elif bf16:
                err, tol = float(np.abs(g - w).max()) / big, p_tol
            else:
                err = (np.linalg.norm(g.astype(np.float64) - w)
                       / max(np.linalg.norm(w), 1e-30))
                tol = p_tol
            assert err <= tol, (what, key, err)


@pytest.mark.parametrize('name', CASE_IDS)
def test_world_matches_single_device(world, name):
    ranks, port, _ = world
    _check_steps(ranks[0], port[name], name, 'single-device KFAC')


@pytest.mark.parametrize('name', [c[0] for c in CASES if c[5]])
def test_world_matches_jax_distributed(world, name):
    ranks, _, ref = world
    _check_steps(ranks[0], ref[name], name, 'JAX DistributedKFAC')


@pytest.mark.parametrize('name', CASE_IDS)
def test_world_ranks_agree_exactly(world, name):
    ranks, _, _ = world
    keys = [k for k in ranks[0] if k.startswith(f'{name}|')]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize('name', CASE_IDS)
def test_world_checkpoint_keeps_bases_and_cross_grid_rebuilds_cold(
        world, name):
    ranks, _, _ = world
    for r in ranks:
        assert bool(r[f'{name}|reload_same'])
        assert bool(r[f'{name}|cross_cold'])


def test_convert_round_trips_a_lowrank_conv_state():
    """A JAX low-rank state of a conv net (its 73-wide conv A engaged) in
    the port's layout: the A basis permuted from ``(kh, kw, c)`` to ``(c,
    kh, kw)`` on its rows only, and back bit for bit; the port then steps
    from it."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu_torch import convert

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(fnn.Conv(6, (3, 3), padding='SAME', name='conv')(x))
            return fnn.Dense(3, name='head')(x.reshape(x.shape[0], -1))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 6, 3, padding=1)
            self.head = nn.Linear(6 * 4 * 4, 3)

        def forward(self, x):
            x = F.relu(self.conv(x))
            return self.head(x.permute(0, 2, 3, 1).flatten(1))

    knobs = dict(inv_lowrank_rank=8, inv_lowrank_dim_threshold=64,
                 factor_update_freq=1, inv_update_freq=1,
                 inverse_method='eigen', eigh_method='xla')
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 4, 4, 8)).astype(np.float32)
    jk = JKFAC(JNet(), **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, _, grads, caps, _ = jk.capture.loss_and_grads(
        lambda o: jnp.mean(o ** 2), variables['params'], jnp.asarray(x))
    _, jstate = jk.step(jstate, grads, caps, factor_update=True,
                        inv_update=True)
    jstate = jax.tree.map(np.asarray, jstate)
    model = Net()
    convert.load_flax_params(model, jax.tree.map(np.asarray,
                                                 variables['params']))
    tk = KFAC(model, device='cpu', **knobs)
    tstate = convert.jax_state_to_torch(jstate, tk.specs)
    qa = tstate['inverses']['conv']['QA']
    assert tuple(qa.shape) == (73, 8)
    perm = convert.conv_a_perm((3, 3), 8, True)
    np.testing.assert_array_equal(
        qa.numpy(), jstate['inverses']['conv']['QA'][perm, :])
    back = convert.torch_state_to_jax(tstate, tk.specs)
    for name, e in jstate['inverses'].items():
        for k, v in e.items():
            np.testing.assert_array_equal(back['inverses'][name][k], v)
    # The converted state is a valid port state: same layout as the
    # port's own, and one step from it runs.
    own = tk.init_state()
    assert {n: {k: tuple(t.shape) for k, t in e.items()}
            for n, e in tstate['inverses'].items()} == \
        {n: {k: tuple(t.shape) for k, t in e.items()}
         for n, e in own['inverses'].items()}
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    _, _, tgrads, tcaps = tk.capture.loss_and_grads(
        lambda o: (o ** 2).mean(), xt)
    precond, _ = tk.step({**own, **tstate}, tgrads, tcaps,
                         factor_update=True, inv_update=True)
    assert all(bool(torch.isfinite(t).all()) for t in precond.values())
