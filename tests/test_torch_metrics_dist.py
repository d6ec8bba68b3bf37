"""On-device K-FAC metrics of ``DistributedKFAC`` (``KFAC(collect_metrics=
True)`` over ``torch.distributed``) on 4 gloo ranks on the CPU, against the
JAX ``DistributedKFAC`` on the same grid (4 virtual CPU devices) and the
port's single-device ``KFAC`` on the full batch.

The JAX suite's ``SmallCNN`` trains 4 steps, factors every step and
inverses every 2nd, on a new seeded batch each step with its parameters
held (a zero update: the metrics of one trajectory on every side, the
KL clip still at ``lr`` 0.1). Two grids: HYBRID_OPT 2 x 2 and MEM_OPT
4 x 1, where one row holds no layer and every row stack carries padding
and other rows' slots, zeros after a firing, which the port's clip count
must leave out. Per step: damping, ``nu``, the norms and the bucket norms
within rel 1e-5 of JAX's and of the single device's, the counters exactly;
every rank's metrics equal rank 0's bit for bit. The same world with the
metrics off gives the same preconditioned gradients, factors and row
stacks bit for bit. Every rank builds a ``JsonlMetricsSink`` at one path:
only rank 0 writes, and its stream holds rank 0's records.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

BATCH, STEPS, INV_FREQ, LR = 16, 4, 2, 0.1
COMMON = dict(factor_update_freq=1, inv_update_freq=INV_FREQ,
              damping=0.003, lr=LR, kl_clip=0.001, inverse_method='eigen',
              eigh_method='xla')
# name -> (comm_method, grad_worker_fraction, grid)
CASES = {'hybrid': ('hybrid-opt', 0.5, (2, 2)),
         'mem_opt': ('mem-opt', 0.0, (4, 1))}
STAT_TOL = 1e-5


def _batch(step):
    rng = np.random.default_rng(300 + step)
    x = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    return x, rng.integers(0, 10, size=BATCH)


def _flat(subtree: dict) -> dict:
    """``{name: float}`` of a metrics subtree (``kfac/...`` names)."""
    from distributed_kfac_pytorch_tpu_torch.observability import metrics
    return {k: float(v)
            for k, v in metrics.flatten_metrics(subtree).items()}


def _digest(tree) -> str:
    import hashlib
    h = hashlib.sha256()

    def walk(t, path=''):
        if isinstance(t, torch.Tensor):
            h.update(path.encode())
            h.update(t.detach().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(t[k], f'{path}/{k}')
    walk(tree)
    return h.hexdigest()


def _steps(step_fn, kfac_capture, params_model, local=slice(None)):
    """``STEPS`` K-FAC steps of ``step_fn(grads, captures, inv_update)``
    on this rank's slice of each step's batch (the parameters held);
    returns per-step ``(preconditioned grads, state)``."""
    out = []
    for step in range(STEPS):
        x, y = _batch(step)
        x = torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))[local]
        y = torch.from_numpy(y)[local]
        _, _, grads, captures = kfac_capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        out.append(step_fn(grads, captures, step % INV_FREQ == 0))
    return out


def worker_main():
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.observability import sink
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine
    from test_torch_distributed import _model

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    launch.initialize_distributed(init_method=f'file://{cfg["store"]}',
                                  device='cpu', timeout=120)
    rank = dist.get_rank()
    data = np.load(cfg['data'])
    params = {k[len('p/'):]: data[k] for k in data.files
              if k.startswith('p/')}
    local = launch.process_local_slice(BATCH)
    out = {}
    for name in cfg['cases']:
        comm, frac, _ = CASES[name]
        for collect in (True, False):
            model = _model(params)
            kfac = KFAC(model, device='cpu', collect_metrics=collect,
                        **COMMON)
            dk = DistributedKFAC(kfac, comm_method=comm,
                                 grad_worker_fraction=frac)
            box = {'state': dk.init_state()}

            def step_fn(grads, captures, inv_update, dk=dk, box=box):
                grads = dict(zip(grads, engine.world_mean(
                    list(grads.values()))))
                precond, box['state'] = dk.step(
                    box['state'], grads, captures, factor_update=True,
                    inv_update=inv_update)
                return precond, box['state']

            recs = _steps(step_fn, kfac.capture, model, local)
            tag = f'{name}|{"on" if collect else "off"}'
            out[f'{tag}|grid'] = np.asarray([dk.n_rows, dk.n_cols])
            out[f'{tag}|digest'] = np.asarray(json.dumps([
                _digest({'precond': p, **{k: v for k, v in s.items()
                                          if k not in ('metrics', 'step')}})
                for p, s in recs]))
            if collect:
                out[f'{tag}|metrics'] = np.asarray(json.dumps(
                    [_flat(s['metrics']) for _, s in recs]))
    # Rank gating: every rank builds a sink at one path.
    path = pathlib.Path(cfg['out']) / 'shared.jsonl'
    s = sink.JsonlMetricsSink(str(path), process_index=rank,
                              meta={'rank': rank})
    s.step_record(0, {'loss': torch.tensor(float(rank))})
    s.close()
    dist.barrier()
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def port_reference(params):
    """The port's single-device ``KFAC`` on the full batch."""
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from test_torch_distributed import _model
    model = _model(params)
    kfac = KFAC(model, device='cpu', collect_metrics=True, **COMMON)
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, inv_update):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          factor_update=True,
                                          inv_update=inv_update)
        return precond, box['state']

    return [_flat(s['metrics']) for _, s in _steps(step_fn, kfac.capture,
                                                    model)]


def jax_reference(name, flax_params):
    """The JAX ``DistributedKFAC``'s metrics per step on the grid's mesh,
    the parameters held by a zero update."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu.observability import metrics
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from test_torch_distributed import jax_small_cnn

    comm, frac, _ = CASES[name]
    kfac = JKFAC(jax_small_cnn(), collect_metrics=True, **COMMON)
    x0, _ = _batch(0)
    jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x0))
    mesh = JD.make_kfac_mesh(
        devices=jax.devices()[:4],
        comm_method=JCommMethod[comm.upper().replace('-', '_')],
        grad_worker_fraction=frac)
    dk = JD.DistributedKFAC(kfac, mesh, flax_params)
    kstate = dk.init_state(flax_params)

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch[1]).mean()

    tx = optax.GradientTransformation(
        lambda p: (), lambda u, s, p=None: (
            jax.tree.map(jnp.zeros_like, u), s))
    step = dk.build_train_step(loss_fn, tx, donate=False)
    params = jax.tree.map(jnp.asarray, flax_params)
    opt_state, extra, out = tx.init(params), {}, []
    for i in range(STEPS):
        x, y = _batch(i)
        params, opt_state, kstate, extra, _ = step(
            params, opt_state, kstate, extra,
            (jnp.asarray(x), jnp.asarray(y)),
            {'lr': LR, 'damping': COMMON['damping']})
        out.append({k: float(v) for k, v in
                    metrics.flatten_metrics(kstate['metrics']).items()})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax

    from distributed_kfac_pytorch_tpu_torch import convert
    from test_torch_distributed import (_finish_world, _start_world,
                                        jax_small_cnn)

    tmp = tmp_path_factory.mktemp('metric_worlds')
    x0, _ = _batch(0)
    variables = jax_small_cnn().init(jax.random.PRNGKey(0), x0[:1])
    flax_params = jax.tree.map(np.asarray, variables['params'])
    params = {k: v.numpy() for k, v in
              convert.flax_to_torch(flax_params).items()}
    data = tmp / 'data.npz'
    np.savez(data, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, 4, list(CASES), data,
                         module='test_torch_metrics_dist')
    try:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        port = port_reference(params)
        torch.set_num_threads(prev)
        ref = {name: jax_reference(name, flax_params) for name in CASES}
    finally:
        ranks = _finish_world(procs, tmp, 4)
    return {'ranks': ranks, 'port': port, 'jax': ref,
            'shared': tmp / 'world4' / 'shared.jsonl'}


def _metrics(rec, tag) -> list:
    return json.loads(str(rec[f'{tag}|metrics']))


def _check(got: list, want: list, what: str):
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, step)
        for k, v in w.items():
            if k.split('/')[1] in ('factor_updates', 'inv_updates',
                                   'inv_chunk_firings', 'nonfinite_skips',
                                   'eig_clipped'):
                assert g[k] == v, (what, step, k)
            else:
                assert abs(g[k] - v) <= STAT_TOL * abs(v), (what, step, k,
                                                            g[k], v)


@pytest.mark.parametrize('name', list(CASES))
def test_grid(runs, name):
    for rank in runs['ranks']:
        assert tuple(rank[f'{name}|on|grid']) == CASES[name][2]


@pytest.mark.parametrize('name', list(CASES))
def test_metrics_match_jax_distributed(runs, name):
    _check(_metrics(runs['ranks'][0], f'{name}|on'), runs['jax'][name],
           'JAX DistributedKFAC')


@pytest.mark.parametrize('name', list(CASES))
def test_metrics_match_single_device_kfac(runs, name):
    got = _metrics(runs['ranks'][0], f'{name}|on')
    _check(got, runs['port'], 'single-device KFAC')
    assert [m['kfac/inv_updates'] for m in got] == [1, 1, 2, 2]


@pytest.mark.parametrize('name', list(CASES))
def test_metrics_are_replicated_on_every_rank(runs, name):
    first = _metrics(runs['ranks'][0], f'{name}|on')
    for rank in runs['ranks'][1:]:
        assert _metrics(rank, f'{name}|on') == first


@pytest.mark.parametrize('name', list(CASES))
def test_metrics_on_is_metrics_off_bit_for_bit(runs, name):
    for rank in runs['ranks']:
        assert str(rank[f'{name}|on|digest']) == \
            str(rank[f'{name}|off|digest'])


def test_only_rank_zero_writes_the_stream(runs):
    from distributed_kfac_pytorch_tpu_torch.observability import sink
    path = runs['shared']
    records = sink.read_jsonl(str(path))
    assert [r['kind'] for r in records] == ['meta', 'step']
    assert records[0]['meta'] == {'rank': 0}
    assert records[1]['metrics'] == {'loss': 0.0}
    assert sorted(p.name for p in path.parent.glob('shared*')) == [
        'shared.jsonl']
