"""Gradient accumulation in the torch port (``engine.accumulate_pass``,
``KFAC`` / ``DistributedKFAC.step(contribs=)``) against the JAX package's
accumulated step (``DistributedKFAC.build_train_step(grad_accum_steps=)``
and ``build_sgd_train_step(grad_accum_steps=)``).

A 1-1-1 CIFAR ResNet at 8 px, batch 16, with BatchNorm (its running
statistics threaded through the micro-batches) and with GroupNorm, two
K-FAC + SGD steps (lr 0.1, no momentum) of factors and inverses each,
exact eigh (``eigh_method='xla'`` on both sides: the warm polish's basis
on these near-identity factors is sensitive to fp32 summation order,
ROADMAP Queue 3). The JAX side runs on a mesh of 1 or 2 of the 8 virtual
CPU devices, with its fused Pallas factor contraction in interpret mode;
the port runs its kernels' plain versions. ``DistributedKFAC`` worlds of
1 and 2 gloo ranks are subprocesses that never import JAX.

Tolerances: losses 1e-5 relative; factors within 1e-5 of the largest
reference entry after step 0 and 1e-4 after step 1 (the inputs then carry
fp32 parameter noise); preconditioned gradients and parameters per tensor
within 1e-4 of the largest reference entry; BatchNorm running means
within 1e-5; running variances after ``k`` updates through
``v - m^k = n/(n-1) (v_jax - m^k)`` (``m`` = 0.9, ``n`` the values per
channel of a micro-batch: torch keeps the unbiased batch variance, flax
the biased one) within 1e-5. The GroupNorm accumulated step against the
port's own single pass: factors within 1e-5 and gradients within 1e-4 of
the largest entry, losses 1e-5 relative.
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import test_torch_distributed as tdist  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Test files run in parallel processes next to JAX's virtual
    devices; one torch thread each keeps the machine from
    oversubscription."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


BATCH, PX, STEPS, LR, DAMPING = 16, 8, 2, 0.1, 0.003
HYPER = dict(damping=DAMPING, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=1, inverse_method='eigen', eigh_method='xla')
BN_MOMENTUM = 0.9
# JAX references: (norm, grad_accum, devices).
JAX_CASES = [('batch', 2, 1), ('batch', 4, 1), ('group', 2, 1),
             ('group', 4, 1), ('batch', 2, 2)]
# Port worlds (subprocess ranks): world size -> cases run in turn.
WORLD_CASES = {1: ['batch2'], 2: ['batch2', 'group2', 'group2_deferred']}
DEFERRED_STEPS, DEFERRED_I_FREQ = 4, 2


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, PX, PX, 3)).astype('float32')
    y = rng.integers(0, 10, size=BATCH)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _model(norm, init):
    model = cifar_resnet.CifarResNet((1, 1, 1), norm=norm)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init(norm):
    """Initial flax variables of the 1-1-1 ResNet, as a torch state
    dict of numpy arrays (once per ``norm``)."""
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    x, _ = _data()
    variables = jax.jit(jres.CifarResNet(num_blocks=(1, 1, 1),
                                         norm=norm).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))
    sd = convert.flax_to_torch(jax.tree.map(np.asarray,
                                            variables['params']),
                               jax.tree.map(np.asarray,
                                            variables.get('batch_stats')))
    return {k: v.numpy() for k, v in sd.items()}, variables


def _specs(norm):
    return KFAC(cifar_resnet.CifarResNet((1, 1, 1), norm=norm),
                device='cpu').specs


def _jax_run(norm, n, devices, sgd=False):
    """Two accumulated steps of the JAX package; per step the loss, the
    factors, the preconditioned gradients (kept as the optimizer's
    state), the parameters and the BatchNorm statistics after it, in the
    port's names and layouts."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod
    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu.training import engine as jengine

    x, y = _data()
    _, variables = _jax_init(norm)
    model = jres.CifarResNet(num_blocks=(1, 1, 1), norm=norm)
    params = variables['params']
    mutable = ('batch_stats',) if 'batch_stats' in variables else ()
    extra = {c: variables[c] for c in mutable}

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch[1]).mean()

    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    opt_state = tx.init(params)
    if sgd:
        step = jengine.build_sgd_train_step(
            model, loss_fn, tx, mutable_cols=mutable, grad_accum_steps=n,
            donate=False)
        kstate, flags = {}, {}
    else:
        kfac = JKFAC(model, fused_factor_contraction=True,
                     fused_precondition=True, **HYPER)
        # Registration is a side effect of tracing the init.
        jax.eval_shape(kfac.init, jax.random.PRNGKey(0), jnp.asarray(x))
        mesh = JD.make_kfac_mesh(devices=jax.devices()[:devices],
                                 comm_method=CommMethod.COMM_OPT)
        dk = JD.DistributedKFAC(kfac, mesh, params)
        kstate = dk.init_state(params)
        step = dk.build_train_step(loss_fn, tx, mutable_cols=mutable,
                                   grad_accum_steps=n, donate=False)
        flags = {'factor_update': True, 'inv_update': True}
    batch = (jnp.asarray(x), jnp.asarray(y))
    specs = _specs(norm)
    recs = []
    for _ in range(STEPS):
        params, opt_state, kstate, extra, metrics = step(
            params, opt_state, kstate, extra, batch,
            {'lr': LR, 'damping': DAMPING}, **flags)
        rec = {'loss': float(metrics['loss'])}
        if not sgd:
            rec['factors'] = {
                n: {s: t.numpy() for s, t in f.items()}
                for n, f in convert.jax_factors_to_torch(
                    jax.tree.map(np.asarray, kstate['factors']),
                    specs).items()}
        rec['precond'] = {k: v.numpy() for k, v in convert.flax_to_torch(
            jax.tree.map(np.asarray, opt_state)).items()}
        rec['params'] = {k: v.numpy() for k, v in convert.flax_to_torch(
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, extra.get('batch_stats'))).items()}
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# The port: single device in process, DistributedKFAC worlds in children
# ---------------------------------------------------------------------------

def _record(state, loss) -> dict:
    rec = {'loss': float(loss),
           'precond': {n: p.grad.detach().numpy().copy()
                       for n, p in state.model.named_parameters()},
           'params': {k: v.detach().numpy().copy()
                      for k, v in state.model.state_dict().items()}}
    if state.kfac is not None:
        rec['factors'] = {n: {s: t.numpy().copy() for s, t in f.items()}
                          for n, f in state.kfac_state['factors'].items()}
    return rec


def _port_run(norm, n, init, x, y, *, kfac_cls=KFAC, sgd=False,
              distributed=False, steps=STEPS, flags_fn=None, **knobs):
    """``steps`` steps of ``engine.train_step`` at ``grad_accum=n`` on
    ``(x, y)`` (this rank's slice under ``distributed``); the records."""
    model = _model(norm, init)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    kfac = None
    if not sgd:
        kfac = KFAC(model, device='cpu', **{**HYPER, **knobs})
        if kfac_cls is not KFAC:
            kfac = kfac_cls(kfac, comm_method='comm-opt')
    state = engine.TrainState(
        model=model, optimizer=opt, kfac=kfac,
        kfac_state=kfac.init_state() if kfac is not None else None,
        distributed=distributed, grad_accum=n)
    recs = []
    for step in range(steps):
        flags = (flags_fn(step) if flags_fn else
                 {'factor_update': True, 'inv_update': True})
        loss, _ = engine.train_step(state, x, y,
                                    {'lr': LR, 'damping': DAMPING},
                                    flags if kfac is not None else {})
        recs.append(_record(state, loss))
    return recs, state


def _deferred_flags(step):
    return engine.cadence_flags(step, 1, DEFERRED_I_FREQ,
                                deferred_reduce=True)


def _eager_flags(step):
    return engine.cadence_flags(step, 1, DEFERRED_I_FREQ)


def _world_case(name):
    norm = name[:5] if name.startswith('group') else 'batch'
    deferred = name.endswith('_deferred')
    return norm, deferred


def worker_main():
    """One rank: ``python -c 'import test_torch_grad_accum as t;
    t.worker_main()' CONFIG_JSON`` with ``RANK`` / ``WORLD_SIZE`` set."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu',
        timeout=tdist.WORLD_TIMEOUT / 2)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    x, y = _nchw(data['x']), torch.from_numpy(data['y'])
    local = launch.process_local_slice(len(x))
    out = {}
    for name in cfg['cases']:
        norm, deferred = _world_case(name)
        init = {k[len(f'{norm}/'):]: data[k] for k in data.files
                if k.startswith(f'{norm}/')}
        kw = dict(kfac_cls=DistributedKFAC, distributed=True)
        if deferred:
            kw.update(steps=DEFERRED_STEPS, flags_fn=_deferred_flags,
                      inv_update_freq=DEFERRED_I_FREQ,
                      deferred_factor_reduction=True)
        elif name == 'group2' and cfg['world'] == 2:
            # The eager twin of the deferred case.
            recs, _ = _port_run(norm, 2, init, x[local], y[local],
                                steps=DEFERRED_STEPS, flags_fn=_eager_flags,
                                inv_update_freq=DEFERRED_I_FREQ, **kw)
            out[f'{name}_eager'] = recs
        recs, _ = _port_run(norm, 2, init, x[local], y[local], **kw)
        out[name] = recs
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = len(leaked)
    (pathlib.Path(cfg['out']) / f'rank{rank}.json').write_text(
        json.dumps(out, default=lambda a: np.asarray(a).tolist()))
    dist.destroy_process_group()


def _finish(procs, tmp, world):
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=tdist.WORLD_TIMEOUT)
        except Exception:
            for q in procs:
                q.kill()
            raise AssertionError(f'world of {world} ranks hung')
        logs.append(log)
    if any(p.returncode for p in procs):
        raise AssertionError(f'world of {world} failed:\n'
                             + '\n'.join(log[-3000:] for log in logs))
    return [json.loads((tmp / f'world{world}' / f'rank{r}.json').read_text())
            for r in range(world)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both worlds start first; the JAX references and the single-device
    port runs are computed here while they run."""
    tmp = tmp_path_factory.mktemp('grad_accum')
    x, y = _data()
    inits = {norm: _jax_init(norm)[0] for norm in ('batch', 'group')}
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y,
             **{f'{norm}/{k}': v for norm, sd in inits.items()
                for k, v in sd.items()})
    procs = {w: tdist._start_world(tmp, w, cases, data,
                                   module='test_torch_grad_accum')
             for w, cases in WORLD_CASES.items()}
    try:
        jax_recs = {case: _jax_run(*case) for case in JAX_CASES}
        jax_recs['sgd'] = _jax_run('batch', 2, 1, sgd=True)
    finally:
        worlds = {w: _finish(p, tmp, w) for w, p in procs.items()}
    return {'inits': inits, 'x': x, 'y': y, 'jax': jax_recs,
            'worlds': worlds}


def _hold(got: list, want: list, *, what: str, factors: bool = True):
    """Each step's record against the reference's, at the tolerances of
    the module docstring (BatchNorm statistics are held separately)."""
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g['loss'] - w['loss']) <= 1e-5 * abs(w['loss']), \
            (what, step, g['loss'], w['loss'])
        if factors:
            tol = 1e-5 if step == 0 else 1e-4
            for n, f in w['factors'].items():
                for s, t in f.items():
                    assert _rel(g['factors'][n][s], t) <= tol, \
                        (what, step, n, s, _rel(g['factors'][n][s], t))
        for k, t in w['precond'].items():
            assert _rel(g['precond'][k], t) <= 1e-4, \
                (what, step, k, _rel(g['precond'][k], t))
        for k, t in w['params'].items():
            if 'running' in k or 'num_batches' in k:
                continue
            assert _rel(g['params'][k], t) <= 1e-4, (what, step, k)


def _hold_batch_stats(got: list, want: list, n: int, updates_per_step: int):
    """Running means directly; running variances through the unbiased
    factor of each BatchNorm's micro-batch (``n`` images)."""
    for step, (g, w) in enumerate(zip(got, want)):
        k = updates_per_step * (step + 1)
        base = BN_MOMENTUM ** k
        for name, t in w['params'].items():
            if name.endswith('running_mean'):
                assert np.abs(g['params'][name] - t).max() <= 1e-5, name
            elif name.endswith('running_var'):
                side = (PX // 2 if 'layer2' in name else
                        PX // 4 if 'layer3' in name else PX)
                m = n * side * side
                expect = m / (m - 1) * (t - base) + base
                assert np.abs(g['params'][name] - expect).max() <= 1e-5, \
                    (name, np.abs(g['params'][name] - expect).max())
            elif name.endswith('num_batches_tracked'):
                pass
        tracked = [v for name, v in g['params'].items()
                   if name.endswith('num_batches_tracked')]
        assert all(int(v) == k for v in tracked), (tracked, k)


@pytest.mark.parametrize('norm,n', [('batch', 2), ('batch', 4),
                                    ('group', 2), ('group', 4)])
def test_kfac_accumulated_step_matches_jax(runs, norm, n):
    """The single-device ``KFAC``'s accumulated step against JAX's on a
    one-device mesh: losses, factors, preconditioned gradients and
    parameters."""
    recs, _ = _port_run(norm, n, runs['inits'][norm], _nchw(runs['x']),
                        torch.from_numpy(runs['y']))
    _hold(recs, runs['jax'][(norm, n, 1)], what=f'{norm} x{n}')


@pytest.mark.parametrize('n', [2, 4])
def test_batch_stats_threaded_through_micro_batches(runs, n):
    """BatchNorm runs its micro-batches one after another, as JAX's scan
    threads ``batch_stats``: ``n`` updates per step."""
    recs, _ = _port_run('batch', n, runs['inits']['batch'],
                        _nchw(runs['x']), torch.from_numpy(runs['y']))
    _hold_batch_stats(recs, runs['jax'][('batch', n, 1)], BATCH // n, n)


@pytest.mark.parametrize('world', [1, 2])
def test_distributed_accumulated_step_matches_jax(runs, world):
    """``DistributedKFAC`` on gloo worlds of 1 and 2 ranks (comm-opt) at
    ``grad_accum=2`` against the JAX ``DistributedKFAC`` on a mesh of as
    many devices: the world's ``1/W`` and ``1/W^2`` compose with the
    micro-batches' ``1/N`` and ``1/N^2``; the BatchNorm statistics are
    threaded on each rank, then averaged over the world."""
    rank0 = runs['worlds'][world][0]
    want = runs['jax'][('batch', 2, world)]
    _hold(rank0['batch2'], want, what=f'world {world}')
    _hold_batch_stats(rank0['batch2'], want, BATCH // world // 2, 2)


def test_distributed_ranks_agree_and_never_import_jax(runs):
    ranks = runs['worlds'][2]
    for rec in ranks[1:]:
        for case in WORLD_CASES[2]:
            for g, w in zip(rec[case], ranks[0][case]):
                assert g['loss'] == w['loss']
                assert g['precond'] == w['precond']
    assert all(r['jax_modules'] == 0 for w in runs['worlds'].values()
               for r in w)


def test_distributed_group_norm_equals_jax_single_device(runs):
    """On the GroupNorm model 2 ranks x 2 micro-batches run the micro-
    batches of one device's 4 (nothing couples the samples): the world
    equals the JAX one-device step at ``grad_accum=4``."""
    _hold(runs['worlds'][2][0]['group2'], runs['jax'][('group', 4, 1)],
          what='group world 2 vs x4')


@pytest.mark.parametrize('n', [2, 4])
def test_group_norm_accumulated_step_equals_single_pass(runs, n):
    """With no BatchNorm coupling a batch, ``grad_accum=n`` is the single
    pass up to the order of fp32 sums: factors within 1e-5 and
    preconditioned gradients within 1e-4 of the largest entry, losses
    1e-5 relative."""
    x, y = _nchw(runs['x']), torch.from_numpy(runs['y'])
    one, _ = _port_run('group', 1, runs['inits']['group'], x, y)
    acc, _ = _port_run('group', n, runs['inits']['group'], x, y)
    for step, (g, w) in enumerate(zip(acc, one)):
        assert abs(g['loss'] - w['loss']) <= 1e-5 * abs(w['loss'])
        for name, f in w['factors'].items():
            for s, t in f.items():
                assert _rel(g['factors'][name][s], t) <= 1e-5, \
                    (step, name, s)
        for k, t in w['precond'].items():
            assert _rel(g['precond'][k], t) <= 1e-4, (step, k)


def test_sgd_accumulated_step_matches_jax(runs):
    """The SGD baseline (``--kfac-update-freq 0``) against JAX's
    ``build_sgd_train_step(grad_accum_steps=2)``, BatchNorm threaded."""
    recs, _ = _port_run('batch', 2, runs['inits']['batch'],
                        _nchw(runs['x']), torch.from_numpy(runs['y']),
                        sgd=True)
    want = runs['jax']['sgd']
    _hold(recs, want, what='sgd', factors=False)
    _hold_batch_stats(recs, want, BATCH // 2, 2)


def _hold_deferred(deferred: list, eager: list):
    """Deferred reduction with accumulation against the eager step: the
    same trajectory (inverses fire only at window heads, where the
    reduced factors equal the eager ones), factors equal at every head."""
    for step, (d, e) in enumerate(zip(deferred, eager)):
        assert abs(d['loss'] - e['loss']) <= 1e-5 * abs(e['loss']), step
        for k, t in e['precond'].items():
            assert _rel(d['precond'][k], t) <= 1e-4, (step, k)
        if step % DEFERRED_I_FREQ == 0:
            for name, f in e['factors'].items():
                for s, t in f.items():
                    assert _rel(d['factors'][name][s], t) <= 1e-5, \
                        (step, name, s)


def test_deferred_reduction_with_accumulation(runs):
    """``deferred_factor_reduction`` under ``grad_accum=2`` (the JAX
    suite's ``test_deferred_reduce_exact_spmd_tied_and_grad_accum``):
    the micro-batch mean feeds the accumulator; on one device and on a
    2-rank world the window heads hold the eager accumulated factors."""
    x, y = _nchw(runs['x']), torch.from_numpy(runs['y'])
    common = dict(steps=DEFERRED_STEPS, inv_update_freq=DEFERRED_I_FREQ)
    eager, _ = _port_run('group', 2, runs['inits']['group'], x, y,
                         flags_fn=_eager_flags, **common)
    deferred, state = _port_run('group', 2, runs['inits']['group'], x, y,
                                flags_fn=_deferred_flags,
                                deferred_factor_reduction=True, **common)
    _hold_deferred(deferred, eager)
    rank0 = runs['worlds'][2][0]
    _hold_deferred(rank0['group2_deferred'], rank0['group2_eager'])


@pytest.mark.parametrize('sgd', [False, True], ids=['kfac', 'sgd'])
def test_batch_not_divisible_raises_jax_error(sgd):
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = None if sgd else KFAC(model, device='cpu')
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=LR),
        kfac=kfac, kfac_state=kfac.init_state() if kfac else None,
        grad_accum=4)
    x, y = torch.randn(10, 3, 8, 8), torch.zeros(10, dtype=torch.long)
    with pytest.raises(ValueError, match=r'per-device batch shard of 10 is '
                       r'not divisible by grad_accum_steps=4'):
        engine.train_step(state, x, y, {'lr': LR, 'damping': DAMPING},
                          {} if sgd else {'factor_update': True,
                                          'inv_update': True})
    with pytest.raises(ValueError, match='grad_accum_steps=0'):
        engine.make_train_state(model, state.optimizer, None, grad_accum=0)


def test_non_factor_steps_capture_and_contract_nothing(monkeypatch):
    """Off factor steps an accumulated step records no capture and runs
    no contraction (JAX: the contraction is absent from that program);
    on factor steps each micro-batch is contracted once."""
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = KFAC(model, device='cpu', **HYPER)
    calls = []
    orig = kfac.local_factor_contribs

    def spy(captures):
        calls.append({n: len(c['a']) for n, c in captures.items()})
        return orig(captures)

    monkeypatch.setattr(kfac, 'local_factor_contribs', spy)
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=LR),
        kfac=kfac, kfac_state=kfac.init_state(), grad_accum=4)
    x, y = torch.randn(8, 3, 8, 8), torch.randint(0, 10, (8,))
    loss, acc, grads, captures, contribs = engine.accumulate_pass(
        state, x, y, factor_update=False)
    assert calls == [] and captures == {} and contribs is None
    assert kfac.capture._a == {} and set(grads) == {
        n for n, _ in model.named_parameters()}
    engine.accumulate_pass(state, x, y, factor_update=True)
    assert len(calls) == 4 and all(set(c.values()) == {1} for c in calls)


def test_step_needs_captures_or_contribs():
    """The JAX ``spmd_step`` contract: captures or contributions, not
    neither."""
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = KFAC(model, device='cpu', **HYPER)
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match='pass captures or contribs'):
        kfac.step(kfac.init_state(), grads, factor_update=True,
                  inv_update=False)


def test_contribs_step_equals_captures_step():
    """``step(contribs=local_factor_contribs(captures))`` is the captures
    step: the contraction-only form then one EMA (K1's fused blend on
    the captures path), within fp32 rounding."""
    torch.manual_seed(0)
    model = cifar_resnet.CifarResNet((1, 1, 1), norm='group')
    kfac = KFAC(model, device='cpu', **HYPER)
    x, y = torch.randn(8, 3, 8, 8), torch.randint(0, 10, (8,))
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, y), x)
    state = kfac.init_state()
    p1, s1 = kfac.step(state, grads, captures, factor_update=True,
                       inv_update=True)
    p2, s2 = kfac.step(state, grads,
                       contribs=kfac.local_factor_contribs(captures),
                       factor_update=True, inv_update=True)
    for n, f in s1['factors'].items():
        for s, t in f.items():
            assert _rel(s2['factors'][n][s], t) <= 1e-6
    for n, t in p1.items():
        assert _rel(p2[n], t) <= 1e-5


def test_micro_batches_split_in_order():
    x = torch.arange(12).reshape(12, 1)
    y = torch.arange(12)
    parts = engine.micro_batches(x, y, 3)
    assert [p[1].tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                              [8, 9, 10, 11]]


@pytest.mark.parametrize('cli', ['cifar', 'imagenet'])
def test_cli_grad_accum_runs_a_step(cli):
    """``--grad-accum`` through each image CLI on the CPU: finite losses
    and the accumulated state on the ``TrainState``."""
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet, \
        train_imagenet_resnet
    if cli == 'cifar':
        res = train_cifar10_resnet.train(
            {'model': 'resnet20gn', 'batch_size': 8, 'val_batch_size': 4,
             'synthetic_size': 16, 'epochs': 1, 'no_augment': True,
             'kfac_update_freq': 1, 'grad_accum': 2, 'quiet': True},
            device='cpu')
    else:
        res = train_imagenet_resnet.train(
            {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
             'val_batch_size': 2, 'synthetic_size': 4, 'epochs': 1,
             'inverse_method': 'cholesky', 'kfac_update_freq': 1,
             'kfac_cov_update_freq': 1, 'grad_accum': 2, 'quiet': True,
             # Stages 3-4 (factor dims up to 4608) out of K-FAC for time.
             'skip_layers': ['layer3_block0', 'layer3_block1',
                             'layer4_block0', 'layer4_block1']},
            device='cpu')
    assert res['state'].grad_accum == 2
    assert res['losses'] and all(np.isfinite(res['losses']))
