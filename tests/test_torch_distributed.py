"""``DistributedKFAC`` of the torch port over real ``torch.distributed``
process groups on the CPU (gloo), against the port's single-device
``KFAC`` on the full batch and against the JAX ``DistributedKFAC`` on the
same grid (the 8-device virtual CPU mesh).

Ranks are subprocesses with a torchrun-style environment (``RANK``,
``WORLD_SIZE``) that meet through a ``file://`` store under ``tmp_path``,
so parallel test workers never share a TCP port. One 4-rank world runs
every 4-rank case in turn (grids 1 x 4, 4 x 1, 2 x 2, 2 x 2) and one
8-rank world the 2 x 4 case; each rank trains the JAX suite's
``SmallCNN`` (no BatchNorm: data parallelism is then exactly the full
batch) for 3 steps, factors every step and inverses every 2nd, on its
slice of one fixed batch. The children never import JAX: the inputs go
to them, and their records come back, as ``.npz`` files; the references
run here meanwhile.

Tolerances: factors after step 1 within 1e-5 of the largest reference
entry, preconditioned gradients of step 1 within 1e-4 (per layer), the
KL-clip scale within 1e-5 relative, and the parameters after 3 steps at
the JAX suite's own ``rtol=1e-2, atol=1e-4``
(``tests/test_distributed.py``). Every rank's record must equal rank 0's
exactly: the delivery and the gather leave one value everywhere.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

BATCH, STEPS, INV_FREQ, LR = 16, 3, 2, 0.1
COMMON = dict(factor_update_freq=1, inv_update_freq=INV_FREQ,
              damping=0.003, lr=LR, kl_clip=0.001)
# (name, world, comm_method, grad_worker_fraction, grid, KFAC knobs)
CASES = [
    ('comm_opt_xla', 4, 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='eigen', eigh_method='xla')),
    ('mem_opt_cholesky', 4, 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='cholesky')),
    ('hybrid_newton_packed', 4, 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='newton', symmetry_aware_comm=True)),
    ('hybrid_jacobi', 4, 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='eigen', eigh_method='jacobi')),
    ('hybrid8_xla', 8, 'hybrid-opt', 0.5, (2, 4),
     dict(inverse_method='eigen', eigh_method='xla')),
]
CASE_IDS = [c[0] for c in CASES]
# Checkpoint round trips under the default eigh_method='auto' (the warm
# polish), on grids with more than one row, in the 4-rank world:
# (name, comm_method, grad_worker_fraction, grid).
AUTO_CASES = [('mem_opt_auto', 'mem-opt', 0.0, (4, 1)),
              ('hybrid_auto', 'hybrid-opt', 0.5, (2, 2))]
WORLD_TIMEOUT = 240


class SmallCNN(nn.Module):
    """Torch twin of the JAX suite's ``SmallCNN`` (8 x 8 x 3 inputs):
    3 x 3 conv to 8 channels, relu, 2 x 2 average pool, dense 16, relu,
    dense 10. It flattens in NHWC order so converted flax weights line
    up."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.fc1 = nn.Linear(128, 16)
        self.fc2 = nn.Linear(16, 10)

    def forward(self, x):
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


def jax_small_cnn():
    """The JAX suite's flax ``SmallCNN``."""
    from test_distributed import SmallCNN as JaxSmallCNN
    return JaxSmallCNN()


# ---------------------------------------------------------------------------
# One K-FAC run, on a rank of a world or on one device
# ---------------------------------------------------------------------------

def _run(model, kfac, step_fn, x, y):
    """Three K-FAC + SGD steps; returns the record: factors, gradients
    and KL-clip scale of step 1, parameters after the last step."""
    rec = {}
    for step in range(STEPS):
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        precond, nu, factors = step_fn(grads, captures,
                                       step % INV_FREQ == 0)
        if step == 0:
            rec['nu'] = np.asarray(float(nu))
            for n, f in factors.items():
                for side, t in f.items():
                    rec[f'factor/{n}/{side}'] = t.numpy().copy()
            for n, g in precond.items():
                rec[f'precond/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    for n, p in model.named_parameters():
        rec[f'param/{n}'] = p.detach().numpy().copy()
    return rec


def _model(params):
    model = SmallCNN()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _case(name):
    return next(c for c in CASES if c[0] == name)


def port_reference(name, params, x, y):
    """The port's single-device ``KFAC`` on the full batch."""
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    knobs = _case(name)[5]
    model = _model(params)
    kfac = KFAC(model, device='cpu', **COMMON, **knobs)
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, inv_update):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          factor_update=True,
                                          inv_update=inv_update)
        return precond, kfac.last_nu, box['state']['factors']

    return _run(model, kfac, step_fn, torch.from_numpy(x),
                torch.from_numpy(y))


def worker_main():
    """One rank: ``python -c 'import test_torch_distributed as t;
    t.worker_main()' CONFIG_JSON`` with ``RANK`` / ``WORLD_SIZE`` set."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu',
        timeout=WORLD_TIMEOUT / 2)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    params = {k[len('p/'):]: data[k] for k in data.files
              if k.startswith('p/')}
    x, y = torch.from_numpy(data['x']), torch.from_numpy(data['y'])
    local = launch.process_local_slice(len(x))
    out = {}
    for name in cfg['cases']:
        _, _, comm, frac, _, knobs = _case(name)
        model = _model(params)
        kfac = KFAC(model, device='cpu', **COMMON, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, inv_update, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             factor_update=True,
                                             inv_update=inv_update)
            return precond, dk.last_nu, box['state']['factors']

        rec = _run(model, kfac, step_fn, x[local], y[local])
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        if knobs.get('eigh_method') == 'xla':
            rec.update(_checkpoint_record(dk, box['state'], rank))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    for name, comm, frac, _ in AUTO_CASES if cfg['world'] == 4 else ():
        model = _model(params)
        kfac = KFAC(model, device='cpu', inverse_method='eigen', **COMMON)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, inv_update, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             factor_update=True,
                                             inv_update=inv_update)
            return precond, dk.last_nu, box['state']['factors']

        _run(model, kfac, step_fn, x[local], y[local])
        state = box['state']
        loaded = dk.load_state_dict(dk.state_dict(state))
        out[f'{name}|grid'] = np.asarray([dk.n_rows, dk.n_cols])
        out[f'{name}|reload_err'] = np.asarray(max(
            float((loaded['inv_stacks'][d][k] - t).abs().max())
            for d, e in state['inv_stacks'].items() for k, t in e.items()))
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def _checkpoint_record(dk, state, rank) -> dict:
    """Round trips of ``state_dict`` / ``load_state_dict``: as saved, and
    with rank 0's stacks marked as another row's (every rank must then
    recompute its inverses from the factors, with the library eigh). The
    errors cover the row stacks and the embeddings' diagonal inverses."""
    def err(loaded):
        pairs = [(loaded['inv_stacks'][d][k], t)
                 for d, e in state['inv_stacks'].items()
                 for k, t in e.items()]
        pairs += [(loaded['diag_inv'][n], t)
                  for n, t in state['diag_inv'].items()]
        return np.asarray(max(float((a - b).abs().max()) for a, b in pairs))
    sd = dk.state_dict(state)
    loaded = dk.load_state_dict(sd)
    same = [loaded['step'] == state['step']] + [
        torch.equal(loaded['factors'][n][s], state['factors'][n][s])
        for n in state['factors'] for s in 'AG']
    if rank == 0:
        sd = {**sd, 'inv_layout': {**sd['inv_layout'], 'row': -1}}
    return {'reload_err': err(loaded), 'reload_same': np.asarray(all(same)),
            'rebuilt_err': err(dk.load_state_dict(sd))}


def _start_world(tmp: pathlib.Path, world: int, cases: list[str],
                 data: pathlib.Path, module: str = 'test_torch_distributed'
                 ) -> list:
    """``world`` rank subprocesses, each running ``module.worker_main``."""
    out = tmp / f'world{world}'
    out.mkdir()
    cfg = json.dumps({'store': str(tmp / f'store{world}'),
                      'data': str(data), 'out': str(out), 'cases': cases,
                      'world': world})
    code = (f'import sys; sys.path.insert(0, {str(HERE)!r}); '
            f'import {module} as t; t.worker_main()')
    procs = []
    for rank in range(world):
        env = {**os.environ, 'RANK': str(rank), 'WORLD_SIZE': str(world),
               'OMP_NUM_THREADS': '1', 'PYTHONPATH': str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code, cfg], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish_world(procs, tmp, world):
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=WORLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f'world of {world} ranks hung')
        logs.append(log)
    if any(p.returncode for p in procs):
        raise AssertionError(f'world of {world} failed:\n'
                             + '\n'.join(log[-3000:] for log in logs))
    return [dict(np.load(tmp / f'world{world}' / f'rank{r}.npz'))
            for r in range(world)]


# ---------------------------------------------------------------------------
# The JAX DistributedKFAC on the same grid
# ---------------------------------------------------------------------------

def jax_reference(name, flax_params, x_nhwc, y):
    """Three steps of the JAX ``build_train_step`` on the grid's mesh; the
    optimizer keeps each step's preconditioned gradients in its state,
    so they are read exactly."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu_torch import convert

    _, world, comm, frac, _, knobs = _case(name)
    kfac = JKFAC(jax_small_cnn(), **COMMON, **knobs)
    # Registration is a side effect of tracing the init.
    jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x_nhwc))
    method = JCommMethod[comm.upper().replace('-', '_')]
    mesh = JD.make_kfac_mesh(devices=jax.devices()[:world],
                             comm_method=method, grad_worker_fraction=frac)
    dk = JD.DistributedKFAC(kfac, mesh, flax_params)
    kstate = dk.init_state(flax_params)

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch[1]).mean()

    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    step = dk.build_train_step(loss_fn, tx, donate=False)
    params = jax.tree.map(jnp.asarray, flax_params)
    opt_state = tx.init(params)
    batch = (jnp.asarray(x_nhwc), jnp.asarray(y))
    rec, extra = {}, {}
    for i in range(STEPS):
        params, opt_state, kstate, extra, _ = step(
            params, opt_state, kstate, extra, batch,
            {'lr': LR, 'damping': COMMON['damping']})
        if i == 0:
            from distributed_kfac_pytorch_tpu_torch.preconditioner import \
                KFAC
            specs = KFAC(SmallCNN(), device='cpu').specs
            factors = convert.jax_factors_to_torch(
                jax.tree.map(np.asarray, kstate['factors']), specs)
            for n, f in factors.items():
                for side, t in f.items():
                    rec[f'factor/{n}/{side}'] = t.numpy()
            for n, t in convert.flax_to_torch(
                    jax.tree.map(np.asarray, opt_state)).items():
                rec[f'precond/{n}'] = t.numpy()
    for n, t in convert.flax_to_torch(
            jax.tree.map(np.asarray, params)).items():
        rec[f'param/{n}'] = t.numpy()
    return rec


# ---------------------------------------------------------------------------
# The fixture: both worlds run while the references are computed here
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax

    from distributed_kfac_pytorch_tpu_torch import convert

    tmp = tmp_path_factory.mktemp('kfac_worlds')
    rng = np.random.default_rng(0)
    x_nhwc = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH)
    variables = jax_small_cnn().init(jax.random.PRNGKey(0),
                                     x_nhwc[:1])
    flax_params = jax.tree.map(np.asarray, variables['params'])
    params = {k: v.numpy() for k, v in
              convert.flax_to_torch(flax_params).items()}
    x = np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    worlds = {w: _start_world(tmp, w, [c[0] for c in CASES if c[1] == w],
                              data)
              for w in sorted({c[1] for c in CASES})}
    try:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        port = {c[0]: port_reference(c[0], params, x, y) for c in CASES}
        torch.set_num_threads(prev)
        ref = {c[0]: jax_reference(c[0], flax_params, x_nhwc, y)
               for c in CASES}
    finally:
        ranks = {w: _finish_world(p, tmp, w) for w, p in worlds.items()}
    dist = {}
    for name, world in [c[:2] for c in CASES] + [(c[0], 4)
                                                  for c in AUTO_CASES]:
        dist[name] = [{k.split('|', 1)[1]: v for k, v in r.items()
                       if k.startswith(name + '|')} for r in ranks[world]]
    leaked = sum(int(r['jax_modules']) for rs in ranks.values() for r in rs)
    return {'dist': dist, 'port': port, 'jax': ref, 'leaked': leaked}


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _check(got: dict, want: dict, what: str):
    for key in want:
        if key.startswith('factor/'):
            assert _rel(got[key], want[key]) <= 1e-5, (what, key)
        elif key.startswith('precond/'):
            assert _rel(got[key], want[key]) <= 1e-4, (what, key)
        elif key.startswith('param/'):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-2,
                                       atol=1e-4, err_msg=f'{what} {key}')


def test_children_never_import_jax(runs):
    assert runs['leaked'] == 0


@pytest.mark.parametrize('name', CASE_IDS)
def test_grid(runs, name):
    assert tuple(runs['dist'][name][0]['grid']) == _case(name)[4]


@pytest.mark.parametrize('name', CASE_IDS)
def test_ranks_agree_exactly(runs, name):
    first, *rest = runs['dist'][name]
    for r, rec in enumerate(rest, start=1):
        assert set(rec) == set(first)
        for key in first:
            np.testing.assert_array_equal(rec[key], first[key],
                                          err_msg=f'rank {r} {key}')


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_single_device_kfac(runs, name):
    got, want = runs['dist'][name][0], runs['port'][name]
    _check(got, want, 'single-device KFAC')
    assert abs(float(got['nu']) - float(want['nu'])) <= 1e-5 * abs(
        float(want['nu']))


@pytest.mark.parametrize('name', [c[0] for c in CASES
                                  if c[5].get('eigh_method') == 'xla'])
def test_checkpoint_round_trip(runs, name):
    """Saved row stacks load back exactly; stacks of another row are
    rebuilt on every rank, to the firing's values (same factors, same
    library eigh)."""
    for r, rec in enumerate(runs['dist'][name]):
        assert bool(rec['reload_same']), r
        assert float(rec['reload_err']) == 0.0, r
        assert float(rec['rebuilt_err']) == 0.0, r


@pytest.mark.parametrize('name', [c[0] for c in AUTO_CASES])
def test_checkpoint_reuses_saved_stacks_under_auto(runs, name):
    """Under the warm polish a reload on the same grid takes the saved
    row stacks as they are, on every rank, although rows that own no slot
    of a bucket saved an all-zero basis there (a recompute would run the
    library eigh and move the bases)."""
    grid = next(c[3] for c in AUTO_CASES if c[0] == name)
    for r, rec in enumerate(runs['dist'][name]):
        assert tuple(rec['grid']) == grid, r
        assert float(rec['reload_err']) == 0.0, r


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_jax_distributed(runs, name):
    _check(runs['dist'][name][0], runs['jax'][name], 'JAX DistributedKFAC')


# ---------------------------------------------------------------------------
# Launcher, CLI and build lock
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_two_ranks(code: str) -> list:
    """``python -c code`` in two processes with torchrun's environment (a
    free localhost port); returns each rank's ``RESULT`` JSON line."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, 'RANK': str(rank), 'LOCAL_RANK': str(rank),
               'WORLD_SIZE': '2', 'MASTER_ADDR': '127.0.0.1',
               'MASTER_PORT': str(port), 'OMP_NUM_THREADS': '1',
               'PYTHONPATH': str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=WORLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError('two-rank run hung')
        assert p.returncode == 0, log[-3000:]
        line = next(ln for ln in log.splitlines() if ln.startswith('RESULT'))
        results.append(json.loads(line.split(' ', 1)[1]))
    return results


def test_cli_two_ranks_torchrun_style():
    """``train_cifar10_resnet.train(..., device='cpu')`` in two processes
    with torchrun's environment: a gloo group, ``DistributedKFAC`` under
    HYBRID_OPT (fraction 0.5: grid 2 x 1), both ranks' losses equal and
    falling."""
    code = (
        'import json, torch\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import '
        'train_cifar10_resnet as T\n'
        "r = T.train({'model': 'resnet20', 'batch_size': 16, "
        "'val_batch_size': 4, 'synthetic_size': 16, 'epochs': 5, "
        "'no_augment': True, 'kfac_update_freq': 2, 'quiet': True, "
        "'comm_method': 'hybrid-opt', 'grad_worker_fraction': 0.5}, "
        "device='cpu')\n"
        "k = r['state'].kfac\n"
        "print('RESULT', json.dumps({'losses': r['losses'], 'kind': "
        "type(k).__name__, 'grid': [k.n_rows, k.n_cols]}))\n")
    results = run_two_ranks(code)
    assert results[0] == results[1]
    res = results[0]
    assert res['kind'] == 'DistributedKFAC' and res['grid'] == [2, 1]
    losses = res['losses']
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_initialize_distributed_single_and_checks(monkeypatch):
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    for var in ('RANK', 'WORLD_SIZE', 'SLURM_NTASKS',
                'OMPI_COMM_WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    meta = launch.initialize_distributed(device='cpu')
    assert not dist.is_initialized()
    assert (meta['process_index'], meta['process_count']) == (0, 1)
    assert launch.process_local_slice(12) == slice(0, 12)
    with pytest.raises(ValueError, match='nccl'):
        launch.initialize_distributed(device='cpu', backend='nccl')
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='RANK'):
        launch.initialize_distributed(device='cpu')
    assert launch._detected_world_size() == 2


def test_check_world_size_warns_on_mismatch():
    import warnings

    from distributed_kfac_pytorch_tpu_torch import launch
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        launch._check_world_size(4, 4)
    with pytest.warns(UserWarning, match='declares 4'):
        launch._check_world_size(4, 2)


def test_distributed_kfac_needs_a_process_group():
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    with pytest.raises(RuntimeError, match='initialize_distributed'):
        DistributedKFAC(KFAC(SmallCNN(), device='cpu'))


@pytest.mark.parametrize('workers,warmup,decay', [
    (1, 5.0, [35, 75, 90]), (4, 5.0, [35, 75, 90]), (8, 2.5, [3, 6]),
    (2, 0.0, [1, 2])])
def test_lr_schedule_matches_jax(workers, warmup, decay):
    from distributed_kfac_pytorch_tpu.training.utils import \
        create_lr_schedule as jax_schedule
    from distributed_kfac_pytorch_tpu_torch.training.utils import \
        create_lr_schedule
    got = create_lr_schedule(workers, warmup, decay)
    want = jax_schedule(workers, warmup, decay)
    for epoch in np.arange(0.0, 100.0, 0.25):
        assert got(epoch) == want(epoch), epoch


def test_build_lock_serializes_processes(tmp_path):
    """Two processes take ``kernels.build_lock`` on one build directory;
    their held intervals must not overlap."""
    code = (
        'import sys, time\n'
        'from distributed_kfac_pytorch_tpu_torch.ops import kernels\n'
        'with kernels.build_lock(sys.argv[1]):\n'
        '    t0 = time.time(); time.sleep(0.5); t1 = time.time()\n'
        "print('HELD', t0, t1)\n")
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, str(tmp_path / 'build')], cwd=ROOT,
        env={**os.environ, 'PYTHONPATH': str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)]
    spans = []
    for p in procs:
        log, _ = p.communicate(timeout=120)
        assert p.returncode == 0, log
        line = next(ln for ln in log.splitlines() if ln.startswith('HELD'))
        spans.append(tuple(float(v) for v in line.split()[1:]))
    (a0, a1), (b0, b1) = sorted(spans)
    assert a1 <= b0, spans
    assert (tmp_path / 'build' / '.lock').exists()


def test_world_one_is_bit_identical_to_single_device(tmp_path):
    """``train_cifar10_resnet.train`` in a one-rank gloo group
    (``DistributedKFAC``: the factor ``all_reduce``, the separate EMA, the
    bucketed firing and preconditioning) gives the single-device run's
    losses bit for bit on the CPU, where both EMAs are the same torch
    ops."""
    code = (
        'import json, sys, torch\n'
        'import torch.distributed as dist\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import launch, '
        'train_cifar10_resnet as T\n'
        "cfg = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4, "
        "'synthetic_size': 16, 'epochs': 2, 'no_augment': True, "
        "'kfac_update_freq': 2, 'quiet': True}\n"
        "single = T.train(cfg, device='cpu')['losses']\n"
        "launch.initialize_distributed(init_method='file://' + sys.argv[1], "
        "rank=0, world_size=1, device='cpu')\n"
        "res = T.train({**cfg, 'comm_method': 'comm-opt'}, device='cpu')\n"
        "kind = type(res['state'].kfac).__name__\n"
        'dist.destroy_process_group()\n'
        "print('RESULT', json.dumps([single, res['losses'], kind]))\n")
    proc = subprocess.run(
        [sys.executable, '-c', code, str(tmp_path / 'store')], cwd=ROOT,
        env={**os.environ, 'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'},
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith('RESULT'))
    single, world_one, kind = json.loads(line.split(' ', 1)[1])
    assert kind == 'DistributedKFAC'
    assert len(single) == 4 and all(np.isfinite(single))
    assert world_one == single
