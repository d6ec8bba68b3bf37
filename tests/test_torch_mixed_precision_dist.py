"""``DistributedKFAC`` of the torch port with the three reduced-precision
flags (``--bf16-factors --bf16-inverses --bf16-precond``: bf16 factor
storage and covariance multiplicands, bf16 inverse storage, bf16
precondition operands) over a 4-rank gloo world on the CPU, against the
port's single-device ``KFAC`` on the full batch and the JAX
``DistributedKFAC`` on the same grid.

The world and its launcher are ``tests/test_torch_distributed.py``'s: each
rank trains ``SmallCNN`` for 3 steps, factors every step and inverses
every 2nd, on its slice of one fixed batch, under COMM_OPT (1 x 4, eigen),
MEM_OPT (4 x 1, Cholesky) and HYBRID_OPT (2 x 2, Newton--Schulz, packed
factor average). The children never import JAX.

Tolerances, and why:

  - step-0 factors against the single-device step, elementwise: 1 bf16 ulp
    of the entry, or 1e-5 of the factor's largest entry where that is
    more (the world sums its fp32 contributions in another order, phase
    14's fp32 tolerance; an entry that cancels to near zero moves by
    more than an ulp of itself). Both blend in fp32 and round once;
  - against the JAX ``DistributedKFAC``: 3 ulps of the blend's larger
    term (its bf16-arithmetic blend, ``test_torch_mixed_precision``);
  - preconditioned gradients and the KL-clip scale of step 0: 2e-2 of
    the largest reference entry. bf16 inverses and bf16 operands round
    values that the two runs computed from factors 1 ulp apart at most:
    one bf16 ulp is 2^-8 = 3.9e-3 of a value, and a product of three
    rounded operands can move by about three of them;
  - the parameters after 3 steps at the JAX suite's ``rtol=1e-2,
    atol=1e-4`` (``tests/test_distributed.py``);
  - every rank's record equal to rank 0's bit for bit (the row gather and
    the column delivery leave one value everywhere).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_distributed import BATCH, COMMON, INV_FREQ, LR, STEPS, \
    SmallCNN, _finish_world, _model, _start_world, jax_small_cnn

# (name, comm_method, grad_worker_fraction, grid, KFAC knobs)
CASES = [
    ('comm_opt_eigen', 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='eigen', eigh_method='xla')),
    ('mem_opt_cholesky', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='cholesky')),
    ('hybrid_newton_packed', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='newton', symmetry_aware_comm=True)),
]
CASE_IDS = [c[0] for c in CASES]
WORLD = 4
PRECOND_TOL = 2e-2


def bf16_knobs(bf16) -> dict:
    """The KFAC knobs of ``--bf16-factors --bf16-inverses
    --bf16-precond`` with ``bf16`` the framework's bf16 dtype."""
    return {'factor_dtype': bf16, 'factor_compute_dtype': bf16,
            'inv_dtype': bf16, 'precond_compute_dtype': bf16}


def bits(t: torch.Tensor) -> np.ndarray:
    """The 16-bit patterns of a bf16 tensor."""
    assert t.dtype == torch.bfloat16, t.dtype
    return t.detach().cpu().contiguous().view(torch.uint16).numpy().copy()


def ulp_keys(b: np.ndarray) -> np.ndarray:
    """bf16 patterns on a monotonic integer line (+0 and -0 coincide): the
    distance of two keys is their distance in ulps."""
    b = b.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)


def from_bits(b: np.ndarray) -> np.ndarray:
    return torch.from_numpy(b.copy()).view(torch.bfloat16).float().numpy()


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at the magnitude of each entry of ``x``."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _run(model, kfac, step_fn, x, y):
    """Three K-FAC + SGD steps: each step's factors as bf16 patterns, step
    0's preconditioned gradients and KL-clip scale, the parameters after
    the last step, and whether every factor and inverse slot is bf16."""
    rec = {}
    for step in range(STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        precond, nu, state = step_fn(grads, captures,
                                     step % INV_FREQ == 0)
        for n, f in state['factors'].items():
            for side, t in f.items():
                rec[f'factor{step}/{n}/{side}'] = bits(t)
        if step == 0:
            rec['nu'] = np.asarray(float(nu))
            for n, g in precond.items():
                rec[f'precond/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    slots = [t for f in state['factors'].values() for t in f.values()]
    for part in ('inverses', 'inv_stacks', 'diag_inv'):
        tree = state.get(part, {})
        slots += [t for e in tree.values()
                  for t in (e.values() if isinstance(e, dict) else [e])]
    rec['all_bf16'] = np.asarray(all(t.dtype == torch.bfloat16
                                     for t in slots))
    for n, p in model.named_parameters():
        rec[f'param/{n}'] = p.detach().numpy().copy()
    return rec


def port_reference(name, params, x, y):
    """The port's single-device ``KFAC`` on the full batch."""
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    model = _model(params)
    kfac = KFAC(model, device='cpu', **COMMON, **_case(name)[4],
                **bf16_knobs(torch.bfloat16))
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, inv_update):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          factor_update=True,
                                          inv_update=inv_update)
        return precond, kfac.last_nu, box['state']

    return _run(model, kfac, step_fn, torch.from_numpy(x),
                torch.from_numpy(y))


def worker_main():
    """One rank (started by ``test_torch_distributed._start_world``)."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

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
        _, comm, frac, _, knobs = _case(name)
        model = _model(params)
        kfac = KFAC(model, device='cpu', **COMMON, **knobs,
                    **bf16_knobs(torch.bfloat16))
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, inv_update, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             factor_update=True,
                                             inv_update=inv_update)
            return precond, dk.last_nu, box['state']

        rec = _run(model, kfac, step_fn, x[local], y[local])
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        state = box['state']
        loaded = dk.load_state_dict(dk.state_dict(state))
        pairs = [(loaded['inv_stacks'][d][k], t)
                 for d, e in state['inv_stacks'].items()
                 for k, t in e.items()]
        rec['reload_same'] = np.asarray(all(
            a.dtype == torch.bfloat16 and torch.equal(a, b)
            for a, b in pairs))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def jax_reference(name, flax_params, x_nhwc, y):
    """Step 0 of the JAX ``build_train_step`` on the grid's mesh with the
    same knobs: its bf16 factors (as port-layout bf16 patterns) and
    preconditioned gradients (kept in the optimizer state)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu_torch import convert
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC

    _, comm, frac, _, knobs = _case(name)
    kfac = JKFAC(jax_small_cnn(), **COMMON, **knobs,
                 **bf16_knobs(jnp.bfloat16))
    # Registration is a side effect of tracing the init.
    jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x_nhwc))
    mesh = JD.make_kfac_mesh(
        devices=jax.devices()[:WORLD],
        comm_method=JCommMethod[comm.upper().replace('-', '_')],
        grad_worker_fraction=frac)
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
    _, opt_state, kstate, _, _ = step(
        params, tx.init(params), kstate, {},
        (jnp.asarray(x_nhwc), jnp.asarray(y)),
        {'lr': LR, 'damping': COMMON['damping']})
    specs = KFAC(SmallCNN(), device='cpu').specs
    rec = {f'factor0/{n}/{side}': bits(t)
           for n, f in convert.jax_factors_to_torch(
               jax.tree.map(np.asarray, kstate['factors']), specs).items()
           for side, t in f.items()}
    for n, t in convert.flax_to_torch(
            jax.tree.map(np.asarray, opt_state)).items():
        rec[f'precond/{n}'] = t.numpy()
    return rec


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax

    from distributed_kfac_pytorch_tpu_torch import convert

    tmp = tmp_path_factory.mktemp('kfac_bf16_world')
    rng = np.random.default_rng(0)
    x_nhwc = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH)
    variables = jax_small_cnn().init(jax.random.PRNGKey(0), x_nhwc[:1])
    flax_params = jax.tree.map(np.asarray, variables['params'])
    params = {k: v.numpy() for k, v in
              convert.flax_to_torch(flax_params).items()}
    x = np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, WORLD, CASE_IDS, data,
                         module='test_torch_mixed_precision_dist')
    try:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        port = {n: port_reference(n, params, x, y) for n in CASE_IDS}
        torch.set_num_threads(prev)
        ref = {n: jax_reference(n, flax_params, x_nhwc, y)
               for n in CASE_IDS}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    dist = {name: [{k.split('|', 1)[1]: v for k, v in r.items()
                    if k.startswith(name + '|')} for r in ranks]
            for name in CASE_IDS}
    leaked = sum(int(r['jax_modules']) for r in ranks)
    return {'dist': dist, 'port': port, 'jax': ref, 'leaked': leaked}


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def test_children_never_import_jax(runs):
    assert runs['leaked'] == 0


@pytest.mark.parametrize('name', CASE_IDS)
def test_grid_and_bf16_state(runs, name):
    for r, rec in enumerate(runs['dist'][name]):
        assert tuple(rec['grid']) == _case(name)[3], r
        assert bool(rec['all_bf16']), r
        assert bool(rec['reload_same']), r
    assert bool(runs['port'][name]['all_bf16'])


@pytest.mark.parametrize('name', CASE_IDS)
def test_ranks_agree_exactly(runs, name):
    first, *rest = runs['dist'][name]
    for r, rec in enumerate(rest, start=1):
        assert set(rec) == set(first)
        for key in first:
            np.testing.assert_array_equal(rec[key], first[key],
                                          err_msg=f'rank {r} {key}')


def _factor_gaps(got, want):
    """Per factor of step 0: (largest gap in ulps, whether every entry is
    within 1 ulp or within 1e-5 of the factor's largest entry)."""
    out = {}
    for key in (k for k in want if k.startswith('factor0/')):
        g, w = got[key], want[key]
        gap = np.abs(ulp_keys(g) - ulp_keys(w))
        diff = np.abs(from_bits(g).astype(np.float64) - from_bits(w))
        ok = (gap <= 1) | (diff <= 1e-5 * np.abs(from_bits(w)).max())
        out[key] = (int(gap.max()), bool(ok.all()))
    return out


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_single_device_kfac(runs, name):
    got, want = runs['dist'][name][0], runs['port'][name]
    for key, (_, ok) in _factor_gaps(got, want).items():
        assert ok, key
    for key in (k for k in want if k.startswith('precond/')):
        assert _rel(got[key], want[key]) <= PRECOND_TOL, key
    assert abs(float(got['nu']) - float(want['nu'])) <= PRECOND_TOL * abs(
        float(want['nu']))
    for key in (k for k in want if k.startswith('param/')):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_jax_distributed(runs, name):
    got, want = runs['dist'][name][0], runs['jax'][name]
    decay = 0.95
    for key in (k for k in want if k.startswith('factor0/')):
        g, w = from_bits(got[key]), from_bits(want[key])
        eye = np.eye(g.shape[0]) if g.ndim == 2 else np.ones_like(g)
        terms = np.maximum(decay * eye, np.abs(g - decay * eye))
        assert (np.abs(g - w) <= 3 * bf16_ulp(terms)).all(), key
    for key in (k for k in want if k.startswith('precond/')):
        assert _rel(got[key], want[key]) <= PRECOND_TOL, key


def test_world_one_is_bit_identical_with_the_flags(tmp_path):
    """``train_cifar10_resnet.train`` with the three flags in a one-rank
    gloo group (``DistributedKFAC``: its own EMA of the reduced fp32
    contributions, the fp32 row gather cast to bf16) gives the
    single-device run's losses and bf16 factors bit for bit on the CPU:
    both blend in fp32 and round once."""
    import os
    import subprocess

    from test_torch_distributed import ROOT, WORLD_TIMEOUT
    code = (
        'import hashlib, json, sys, torch\n'
        'import torch.distributed as dist\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import launch, '
        'train_cifar10_resnet as T\n'
        "cfg = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4, "
        "'synthetic_size': 16, 'epochs': 2, 'no_augment': True, "
        "'kfac_update_freq': 2, 'quiet': True, 'bf16_factors': True, "
        "'bf16_inverses': True, 'bf16_precond': True}\n"
        'def digest(res):\n'
        "    f = res['state'].kfac_state['factors']\n"
        '    h = hashlib.sha256()\n'
        '    for n in sorted(f):\n'
        "        for s in 'AG':\n"
        '            h.update(f[n][s].view(torch.uint16).numpy().tobytes())\n'
        "    return res['losses'], h.hexdigest(), str(f[n]['A'].dtype)\n"
        "single = digest(T.train(cfg, device='cpu'))\n"
        "launch.initialize_distributed(init_method='file://' + sys.argv[1], "
        "rank=0, world_size=1, device='cpu')\n"
        "res = T.train({**cfg, 'comm_method': 'comm-opt'}, device='cpu')\n"
        "kind = type(res['state'].kfac).__name__\n"
        'world = digest(res)\n'
        'dist.destroy_process_group()\n'
        "print('RESULT', json.dumps([single, world, kind]))\n")
    proc = subprocess.run(
        [sys.executable, '-c', code, str(tmp_path / 'store')], cwd=ROOT,
        env={**os.environ, 'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'},
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith('RESULT'))
    single, world, kind = json.loads(line.split(' ', 1)[1])
    assert kind == 'DistributedKFAC'
    assert single[2] == 'torch.bfloat16'
    assert len(single[0]) == 4 and all(np.isfinite(single[0]))
    assert world == single
