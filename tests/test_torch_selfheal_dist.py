"""``DistributedKFAC.precondition(gates=)`` of the torch port on 4 gloo
ranks on the CPU, against the port's single-device ``KFAC`` on the full
batch (``tests/test_torch_distributed.py``'s ``SmallCNN`` and world
launcher).

Each rank runs one K-FAC step (factors and a firing) of the grid, then
preconditions the step's world-mean gradients under each gate set: every
bucket on, one bucket off, two off and all off. The reference runs the
same on one device. Held: every rank's record equals rank 0's exactly;
the preconditioned gradients within 1e-4 per layer and ``nu`` within
1e-5 relative of the single device (the distributed step's own
tolerances); a gated-off layer's gradient is the raw world-mean gradient
times ``nu``, exactly, on the grid as on one device. Grids: 1 x 4
(comm-opt, eigen), 4 x 1 (mem-opt, Cholesky), 2 x 2 (hybrid-opt, eigen).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_distributed as base

CASES = [('comm_opt', 'comm-opt', 0.0, dict(inverse_method='eigen',
                                            eigh_method='xla')),
         ('mem_opt', 'mem-opt', 0.0, dict(inverse_method='cholesky')),
         ('hybrid', 'hybrid-opt', 0.5, dict(inverse_method='eigen',
                                            eigh_method='xla'))]
GATE_SETS = {'all_on': (), 'conv_off': ('8x28',),
             'two_off': ('8x28', '10x17'), 'all_off': 'all'}
WORLD = 4


def _gates(kfac, which) -> dict:
    keys = kfac.metric_bucket_keys()
    off = keys if which == 'all' else which
    return {k: torch.tensor(0.0 if k in off else 1.0) for k in keys}


def _records(kfac, precondition, grads, nu_of) -> dict:
    rec = {}
    for label, which in GATE_SETS.items():
        out = precondition(dict(grads), _gates(kfac, which))
        rec[f'{label}/nu'] = np.asarray(float(nu_of()))
        for n, t in out.items():
            rec[f'{label}/precond/{n}'] = t.numpy().copy()
    for n, g in grads.items():
        rec[f'grad/{n}'] = g.numpy().copy()
    return rec


def _step(kfac, step_fn, x, y):
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, y), x)
    return step_fn(grads, captures)


def reference(name, params, x, y) -> dict:
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    knobs = next(c for c in CASES if c[0] == name)[3]
    kfac = KFAC(base._model(params), device='cpu', **base.COMMON, **knobs)

    def step_fn(grads, captures):
        _, state = kfac.step(kfac.init_state(), grads, captures,
                             factor_update=True, inv_update=True)
        return grads, state

    grads, state = _step(kfac, step_fn, torch.from_numpy(x),
                         torch.from_numpy(y))
    return _records(kfac, lambda g, gates: kfac.precondition(
        state, g, kfac.damping, kfac.lr, gates=gates), grads,
        lambda: kfac.last_nu)


def worker_main():
    """One rank: ``python -c 'import test_torch_selfheal_dist as t;
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
        timeout=base.WORLD_TIMEOUT / 2)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    params = {k[len('p/'):]: data[k] for k in data.files
              if k.startswith('p/')}
    x, y = torch.from_numpy(data['x']), torch.from_numpy(data['y'])
    local = launch.process_local_slice(len(x))
    out = {}
    for name, comm, frac, knobs in CASES:
        kfac = KFAC(base._model(params), device='cpu', **base.COMMON,
                    **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)

        def step_fn(grads, captures, dk=dk):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            _, state = dk.step(dk.init_state(), grads, captures,
                               factor_update=True, inv_update=True)
            return grads, state

        grads, state = _step(kfac, step_fn, x[local], y[local])
        rec = _records(kfac, lambda g, gates, dk=dk, state=state:
                       dk.precondition(state, g, kfac.damping, kfac.lr,
                                       gates=gates), grads,
                       lambda dk=dk: dk.last_nu)
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('gated_world')
    rng = np.random.default_rng(1)
    x = rng.normal(size=(base.BATCH, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=base.BATCH)
    torch.manual_seed(0)
    params = {k: v.numpy() for k, v in base.SmallCNN().state_dict().items()}
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = base._start_world(tmp, WORLD, [c[0] for c in CASES], data,
                              module='test_torch_selfheal_dist')
    try:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        ref = {c[0]: reference(c[0], params, x, y) for c in CASES}
        torch.set_num_threads(prev)
    finally:
        ranks = base._finish_world(procs, tmp, WORLD)
    out = {}
    for name, *_ in CASES:
        out[name] = [{k.split('|', 1)[1]: v for k, v in r.items()
                      if k.startswith(name + '|')} for r in ranks]
    return out, ref


@pytest.mark.parametrize('name', [c[0] for c in CASES])
def test_ranks_agree_exactly(runs, name):
    dist, _ = runs
    for r in dist[name][1:]:
        assert r.keys() == dist[name][0].keys()
        for k, v in r.items():
            assert np.array_equal(v, dist[name][0][k]), k


@pytest.mark.parametrize('label', list(GATE_SETS))
@pytest.mark.parametrize('name', [c[0] for c in CASES])
def test_gated_precondition_matches_single_device(runs, name, label):
    dist, ref = runs
    got, want = dist[name][0], ref[name]
    assert list(got['grid']) == {'comm_opt': [1, 4], 'mem_opt': [4, 1],
                                 'hybrid': [2, 2]}[name]
    nu, nu_ref = float(got[f'{label}/nu']), float(want[f'{label}/nu'])
    assert abs(nu / nu_ref - 1.0) <= 1e-5
    off = GATE_SETS[label]
    for key, w in want.items():
        if not key.startswith(f'{label}/precond/'):
            continue
        g = got[key]
        assert base._rel(g, w) <= 1e-4, key
        param = key.split('/', 2)[2]
        bucket = {'conv1': '8x28', 'fc1': '16x129',
                  'fc2': '10x17'}.get(param.split('.')[0])
        if bucket is not None and (off == 'all' or bucket in off):
            # The raw world-mean gradient times nu, exactly.
            assert np.array_equal(
                g, (torch.tensor(nu, dtype=torch.float32)
                    * torch.from_numpy(got[f'grad/{param}'])).numpy()), key
