"""The dynamic loss scale and the overflow skip of the torch port
(``training.engine`` under ``TrainState.loss_scale``; the CLIs' ``--fp16``)
on the CPU:

  - a 4-rank gloo world (children of ``test_torch_distributed``'s
    launcher) of ``DistributedKFAC`` steps on an fp16 conv net with
    BatchNorm and SGD momentum, the middle step's global batch poisoned on
    rank 0's slice only: every rank skips it, leaving the parameters, the
    momentum, every ``kfac_state`` tensor (factors, inverses, and in the
    second case the deferred accumulator and the stale snapshot) and the
    BatchNorm buffers bit for bit; ``kfac_state['step']`` advances, the
    scale halves as JAX's ``update_loss_scale`` gives, the next step
    trains; every rank's record equals rank 0's bit for bit (the JAX
    suite's ``TestDynamicLossScale``);
  - ``--grad-accum 2`` under fp16 against the JAX ``build_train_step(
    grad_accum_steps=2, loss_scale='dynamic')`` on a one-device mesh, two
    steps: losses, parameters and factors within 5e-3 of the largest JAX
    entry (each side's fp16 rounding), the scale state equal.

The CLIs under ``--fp16`` are in ``tests/test_torch_fp16_cli.py``. The
children import this module and never JAX: its JAX imports stay inside
the functions that compare against JAX.
"""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch import convert, fp16
from distributed_kfac_pytorch_tpu_torch.modules.precision import \
    set_compute_dtype
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

ACCUM_TOL = 5e-3
BATCH = 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class ConvBN(nn.Module):
    """conv -> BatchNorm -> relu -> conv -> mean -> Linear, named as the
    flax twin (``JConvBN``)."""

    def __init__(self, dtype=torch.float16):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1, bias=False)
        self.fc = nn.Linear(8, 5)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        y = self.conv2(F.relu(self.bn(self.conv(x))))
        return self.fc(y.mean(dim=(2, 3)))


def _data(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 5, size=n).astype(np.int64))


def _digest(tree) -> str:
    """sha256 over every tensor of a nested structure, in a fixed order."""
    h = hashlib.sha256()

    def walk(t, path=''):
        if isinstance(t, torch.Tensor):
            h.update(path.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(t[k], f'{path}/{k}')
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f'{path}/{i}')
    walk(tree)
    return h.hexdigest()


def _snapshot(state) -> dict:
    return {
        'params': _digest(dict(state.model.named_parameters())),
        'momentum': _digest([s.get('momentum_buffer')
                             for s in state.optimizer.state.values()]),
        'kfac': _digest({k: v for k, v in state.kfac_state.items()
                         if k != 'step'}),
        'buffers': _digest(dict(state.model.named_buffers())),
    }


# ---------------------------------------------------------------------------
# The 4-rank world
# ---------------------------------------------------------------------------

WORLD_CASES = {
    'eager': dict(),
    'deferred_stale': dict(deferred_factor_reduction=True,
                           inv_staleness=1),
}


def worker_main():
    """One rank: three ``engine.train_step`` calls under the dynamic loss
    scale, the middle one on the poisoned global batch."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.resilience import faults

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    launch.initialize_distributed(init_method=f'file://{cfg["store"]}',
                                  device='cpu', timeout=120)
    rank = dist.get_rank()
    x, y = _data()
    bad, = faults.poison_at(iter([(x, y)]),
                            faults.FaultPlan(nan_batch_at=0))
    out = {}
    for name in cfg['cases']:
        torch.manual_seed(0)
        model = ConvBN()
        kfac = KFAC(model, device='cpu', factor_update_freq=1,
                    inv_update_freq=2, damping=0.03, lr=0.1, kl_clip=None,
                    inverse_method='cholesky', **WORLD_CASES[name])
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        state = engine.make_train_state(model, opt, kfac, fp16=True)
        assert state.distributed
        sched = engine.epoch_schedule(state.kfac, 2)
        local = launch.process_local_slice(BATCH)
        for step, (xb, yb) in enumerate([(x, y), bad, (x, y)]):
            flags = engine.cadence_flags(step, 1, 2, **sched)
            scale = float(state.loss_scale['scale'])
            loss, _ = engine.train_step(
                state, torch.from_numpy(xb[local]),
                torch.from_numpy(yb[local]), {'lr': 0.1, 'damping': 0.03},
                flags)
            snap = _snapshot(state)
            out[f'{name}/{step}'] = np.array(json.dumps({
                **snap, 'loss': float(loss), 'scale': scale,
                'overflow': state.overflow,
                'kstep': int(state.kfac_state['step']),
                'next_scale': float(state.loss_scale['scale']),
                'growth': int(state.loss_scale['growth_count']),
                'poisoned_here': bool(not np.isfinite(xb[local]).all())}))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def test_world_skips_the_poisoned_step_on_every_rank(tmp_path):
    from distributed_kfac_pytorch_tpu import fp16 as jfp16
    from test_torch_distributed import _finish_world, _start_world
    data = tmp_path / 'unused.npz'
    np.savez(data)
    procs = _start_world(tmp_path, 4, list(WORLD_CASES), data,
                         module='test_torch_fp16_dist')
    ranks = _finish_world(procs, tmp_path, 4)
    jscale = jfp16.init_loss_scale()
    jscales = []
    for finite in (True, False, True):
        jscale = jfp16.update_loss_scale(jscale, finite)
        jscales.append((float(jscale['scale']),
                        int(jscale['growth_count'])))
    for name in WORLD_CASES:
        recs = [[json.loads(str(r[f'{name}/{s}'])) for s in range(3)]
                for r in ranks]
        poisoned = [rec[1]['poisoned_here'] for rec in recs]
        assert poisoned == [True, False, False, False]
        for rec in recs[1:]:
            for s in range(3):
                want = {k: v for k, v in recs[0][s].items()
                        if k != 'poisoned_here'}
                got = {k: v for k, v in rec[s].items()
                       if k != 'poisoned_here'}
                assert got == want or (s == 1 and {
                    k: v for k, v in got.items() if k != 'loss'} == {
                    k: v for k, v in want.items() if k != 'loss'}), (
                    name, s)
        r0 = recs[0]
        assert [r['overflow'] for r in r0] == [False, True, False]
        for key in ('params', 'momentum', 'kfac', 'buffers'):
            assert r0[1][key] == r0[0][key], (name, key)
            if key != 'kfac' or not name.startswith('deferred'):
                assert r0[2][key] != r0[1][key], (name, key)
        assert [r['kstep'] for r in r0] == [1, 2, 3]
        assert [(r['next_scale'], r['growth']) for r in r0] == jscales
        assert r0[1]['scale'] == 2.0 ** 15 and r0[2]['scale'] == 2.0 ** 14
        assert np.isfinite(r0[0]['loss']) and np.isfinite(r0[2]['loss'])


# ---------------------------------------------------------------------------
# Gradient accumulation under fp16, against JAX
# ---------------------------------------------------------------------------

def _jax_convbn():
    import flax.linen as fnn
    import jax.numpy as jnp

    class JConvBN(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = True):
            d = jnp.float16
            y = fnn.Conv(8, (3, 3), padding=1, use_bias=False, dtype=d,
                         name='conv')(x)
            y = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, dtype=d, name='bn')(y)
            y = fnn.Conv(8, (3, 3), padding=1, use_bias=False, dtype=d,
                         name='conv2')(fnn.relu(y))
            return fnn.Dense(5, dtype=d, name='fc')(y.mean(axis=(1, 2)))
    return JConvBN()


def test_grad_accum_under_fp16_matches_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import fp16 as jfp16
    from distributed_kfac_pytorch_tpu.parallel import distributed as D
    knobs = dict(factor_update_freq=1, inv_update_freq=2, damping=0.03,
                 lr=0.1, kl_clip=None, inverse_method='cholesky')
    xs = [_data(s, 8) for s in (1, 2)]
    jx = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x, _ in xs]
    jk = JKFAC(_jax_convbn(), **knobs)
    variables, _ = jax.jit(jk.init)(jax.random.PRNGKey(0), jx[0])
    params = variables['params']
    model = ConvBN()
    model.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, variables['batch_stats'])))
    dk = D.DistributedKFAC(jk, D.make_kfac_mesh(jax.devices()[:1]), params)
    kstate = dk.init_state(params)
    tx = optax.sgd(0.1)
    opt_state = tx.init(params)
    extra = {'batch_stats': variables['batch_stats'],
             'loss_scale': jfp16.init_loss_scale()}
    jstep = dk.build_train_step(
        lambda out, b: optax.softmax_cross_entropy_with_integer_labels(
            out, b[1]).mean(), tx, mutable_cols=('batch_stats',),
        donate=False, loss_scale='dynamic', grad_accum_steps=2)
    kfac = KFAC(model, device='cpu', **knobs)
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        kfac=kfac, kfac_state=kfac.init_state(), grad_accum=2,
        loss_scale=fp16.init_loss_scale(device='cpu'))
    hyper = {'lr': 0.1, 'damping': 0.03, 'factor_update_freq': 1,
             'inv_update_freq': 2}
    for step, ((x, y), jxs) in enumerate(zip(xs, jx)):
        flags = engine.cadence_flags(step, 1, 2)
        params, opt_state, kstate, extra, m = jstep(
            params, opt_state, kstate, extra, (jxs, jnp.asarray(y)),
            hyper, factor_update=flags['factor_update'],
            inv_update=flags['inv_update'])
        loss, _ = engine.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y), hyper, flags)
        assert abs(float(loss) - float(m['loss'])) <= ACCUM_TOL * abs(
            float(m['loss']))
        assert not state.overflow and float(m['overflow']) == 0.0
        for k in ('scale', 'growth_count'):
            assert float(state.loss_scale[k]) == float(extra['loss_scale'][k])
        want = convert.flax_to_torch(jax.tree.map(np.asarray, params))
        for n, p in model.named_parameters():
            ref = want[n].numpy()
            err = (p.detach().double() - torch.from_numpy(ref).double()
                   ).abs().max() / max(np.abs(ref).max(), 1e-30)
            assert err <= ACCUM_TOL, (step, n, float(err))
        jf = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, kstate['factors']), kfac.specs)
        for n, e in state.kfac_state['factors'].items():
            for s, t in e.items():
                ref = jf[n][s].numpy()
                err = np.abs(t.double().numpy() - ref).max() / max(
                    np.abs(ref).max(), 1e-30)
                assert err <= ACCUM_TOL, (step, n, s, err)


def test_lm_cli_fp16_under_seq_parallel_matches_one_process():
    """``--fp16 --seq-parallel 2`` on two ranks (the ring in fp32 scores):
    both ranks' losses and scale records equal, and the losses within
    2e-3 relative of the single-process ``--fp16`` run on the same windows
    (the ring's fp32 statistics in another order, under fp16 compute)."""
    from test_torch_distributed import run_two_ranks

    from distributed_kfac_pytorch_tpu_torch import train_language_model
    cfg = {'arch': 'transformer', 'emsize': 16, 'nheads': 2, 'nlayers': 1,
           'tied': True, 'synthetic_vocab': 40, 'synthetic_size': 2000,
           'bptt': 8, 'batch_size': 4, 'epochs': 1, 'max_steps': 3,
           'kfac_update_freq': 2, 'dropout': 0.0, 'inverse_method': 'eigen',
           'eigh_method': 'xla', 'quiet': True, 'fp16': True}
    code = (
        'import json, torch\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import '
        'train_language_model as T\n'
        f'r = T.train({{**{cfg!r}, "seq_parallel": 2}}, device="cpu")\n'
        "print('RESULT', json.dumps({'losses': r['losses'], "
        "'scaler': r['scaler'], 'sp': r['state'].kfac.seq_parallel}))\n")
    results = run_two_ranks(code)
    assert results[0] == results[1]
    assert results[0]['sp'] == 2
    single = train_language_model.train(cfg, device='cpu')
    np.testing.assert_allclose(results[0]['losses'], single['losses'],
                               rtol=2e-3)
    assert results[0]['scaler'] == single['scaler']

