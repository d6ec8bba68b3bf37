"""Self-healing on the CPU, against the JAX package:

  - ``SelfHealController`` driven by scripted metric sequences beside the
    JAX controller on the same values: the same rung decisions (damping
    multiplier, gates, rollbacks) and the same events, step by step;
  - ``KFAC.precondition(gates=)`` against the JAX ``KFAC.precondition``
    on the same state (the port's state carried across by
    ``convert.torch_state_to_jax``), fp32 within 1e-5; a gated-off
    bucket is the raw gradient exactly (times ``nu``), and a NaN planted
    in a gated-off bucket's inverses does not reach the output; gates all
    on change only the ``v.g`` summation;
  - ``poison_factors`` and ``poison_params`` agree with JAX's;
  - ``rollback_restore`` passes a checksum-valid but non-finite bundle;
  - the CIFAR CLI with ``KFAC_CHAOS=corrupt-factor`` quarantines the
    attributed bucket and re-admits it, with ``diverge`` escalates the
    damping and rolls back in the same process; unarmed, the step is the
    plain step bit for bit; armed with no fault, ``nu`` is within 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
from distributed_kfac_pytorch_tpu.resilience import faults as jfaults
from distributed_kfac_pytorch_tpu.resilience import selfheal as jselfheal
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cifar
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.observability import metrics, sink
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.resilience import faults, \
    integrity, selfheal
from distributed_kfac_pytorch_tpu_torch.training import checkpoint


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The controller, side by side with JAX's
# ---------------------------------------------------------------------------

class _State:
    def __init__(self, step, kfac_state):
        self.step = step
        self.kfac_state = kfac_state


BUCKETS = {'16x27': ['conv1'], '10x65': ['fc']}


def _factors(lib, bad: bool):
    """Two layers' factors in ``lib``'s arrays; ``conv1``'s A holds an
    infinity when ``bad``."""
    a = np.eye(27, dtype=np.float32)
    if bad:
        a[0, 0] = np.inf
    mk = ((lambda v: torch.from_numpy(v.copy())) if lib == 'torch'
          else jnp.asarray)
    return {'factors': {'conv1': {'A': mk(a),
                                  'G': mk(np.eye(16, dtype=np.float32))},
                        'fc': {'A': mk(np.eye(65, dtype=np.float32)),
                               'G': mk(np.ones(10, np.float32))}}}


def _script(kind: str) -> list[dict]:
    """Per-step metrics (and whether conv1's factors are poisoned)."""
    steps = []
    skips, inv = 0.0, 1.0
    for i in range(40):
        loss = 2.0 - 0.01 * i
        bad = False
        if kind == 'quarantine' and 6 <= i < 10:
            skips += 1.0
            bad = True
        if kind == 'diverge' and i in (8, 9):
            loss = 50.0
        if kind in ('rollback', 'no_quarantine') and i >= 6:
            loss = float('nan')
            bad = True
        if i % 5 == 0 and i:
            inv += 1.0
        steps.append({'metrics': {
            'loss': loss, 'kfac/nonfinite_skips': skips,
            'kfac/grad_norm': 1.0 if math.isfinite(loss) else float('nan'),
            'kfac/precond_norm': 0.5, 'kfac/inv_updates': inv,
            'kfac/inv_chunk_firings': 0.0}, 'bad': bad})
    return steps


def _drive(mod, lib, kind: str, cfg_kw: dict):
    cfg = mod.SelfHealConfig(check_every=2, **cfg_kw)
    buckets = None if kind == 'no_quarantine' else BUCKETS
    ctl = (mod.SelfHealController(cfg, bucket_layers=buckets)
           if lib == 'jax' else
           mod.SelfHealController(cfg, bucket_layers=buckets,
                                  device='cpu'))
    trail = []
    poisoned = False
    for i, rec in enumerate(_script(kind)):
        poisoned = poisoned or rec['bad']
        state = _State(i, _factors(lib, poisoned and rec['bad']))
        hyper = ctl.adjust_hyper({'damping': 0.003, 'lr': 0.1})
        gates = {k: float(v) for k, v in hyper.get('bucket_gate',
                                                   {}).items()}
        metrics_in = dict(rec['metrics'])
        if lib == 'torch':
            metrics_in = {k: torch.tensor(v) for k, v in metrics_in.items()}
        try:
            ctl.observe(state, metrics_in)
            outcome = None
        except mod.Rollback as rb:
            outcome = ('rollback', rb.global_step, rb.onset_step)
            ctl.after_rollback(rb.onset_step)
        except mod.SelfHealExhausted:
            outcome = ('exhausted', i)
            trail.append((i, hyper['damping'], gates, outcome,
                          ctl.drain_events()))
            break
        reset = None
        if 'conv1' in state.kfac_state['factors']:
            a = state.kfac_state['factors']['conv1']['A']
            reset = bool(np.isfinite(np.asarray(a)).all())
        trail.append((i, hyper['damping'], gates, outcome,
                      ctl.drain_events(), reset))
    return trail


@pytest.mark.parametrize('kind,cfg_kw', [
    ('quarantine', {}), ('diverge', {}),
    ('rollback', {'max_rollbacks': 1}),
    ('no_quarantine', {'quarantine': False, 'max_rollbacks': 0})],
    ids=['quarantine', 'diverge', 'rollback', 'no-quarantine'])
def test_controller_matches_jax(kind, cfg_kw):
    got = _drive(selfheal, 'torch', kind, cfg_kw)
    want = _drive(jselfheal, 'jax', kind, cfg_kw)
    assert got == want
    events = [e['event'] for row in got for e in row[4]]
    if kind == 'quarantine':
        assert {'selfheal_escalate', 'selfheal_quarantine',
                'selfheal_readmit'} <= set(events)
    if kind == 'diverge':
        assert 'selfheal_escalate' in events
        assert 'selfheal_deescalate' in events
    if kind == 'rollback':
        assert any(row[3] and row[3][0] == 'rollback' for row in got)
        assert got[-1][3][0] == 'exhausted'


def test_config_validation_matches_jax():
    for kw in ({'check_every': 0}, {'damping_factor': 1.0},
               {'diverge_adapt': 1.0}, {'rollback_after': 2},
               {'escalate_after': 0}):
        with pytest.raises(ValueError):
            selfheal.SelfHealConfig(**kw)
        with pytest.raises(ValueError):
            jselfheal.SelfHealConfig(**kw)
    assert selfheal.SelfHealConfig() == selfheal.SelfHealConfig(
        **vars(jselfheal.SelfHealConfig()))


def test_bucket_layer_map_and_reset():
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                deferred_factor_reduction=True, inv_staleness=1,
                factor_update_freq=1, inv_update_freq=2)
    buckets = selfheal.bucket_layer_map(kfac)
    assert sorted(buckets) == sorted(kfac.metric_bucket_keys())
    assert sum(map(len, buckets.values())) == len(kfac.specs)
    state = kfac.init_state()
    state['factors'] = {n: {k: t * 3.0 for k, t in e.items()}
                        for n, e in state['factors'].items()}
    out = selfheal.reset_layers(state, buckets['16x27'])
    assert torch.equal(out['factors']['conv1']['A'], torch.eye(27))
    assert torch.equal(out['frozen_factors']['conv1']['G'], torch.eye(16))
    assert not out['factor_accum']['conv1']['A'].any()
    assert out['factors']['linear'] is state['factors']['linear']


# ---------------------------------------------------------------------------
# KFAC.precondition(gates=) against JAX
# ---------------------------------------------------------------------------

B, PX = 4, 8
HYPER = dict(damping=0.003, lr=0.1, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=1, inverse_method='eigen', eigh_method='xla')


@pytest.fixture(scope='module')
def stepped():
    """One port K-FAC step of a tiny ResNet; its state, a fresh gradient
    and the JAX ``KFAC`` of the same model (registered from shapes)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, PX, PX, 3)).astype('float32')
    y = rng.integers(0, 10, size=B)
    torch.manual_seed(0)
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = KFAC(model, device='cpu', **HYPER)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    _, _, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, torch.from_numpy(y)), xt)
    _, state = kfac.step(kfac.init_state(), grads, captures,
                         factor_update=True, inv_update=True)
    grads = {n: torch.from_numpy(rng.normal(size=g.shape).astype('float32'))
             for n, g in grads.items()}
    jkfac = JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1)), **HYPER)
    jax.eval_shape(jkfac.init, jax.random.PRNGKey(0), jnp.asarray(x))
    return kfac, state, grads, jkfac


_JITTED = {}


def _jitted_precondition(jkfac):
    if id(jkfac) not in _JITTED:
        _JITTED[id(jkfac)] = jax.jit(
            lambda st, g, gates: jkfac.precondition(
                st, g, HYPER['damping'], HYPER['lr'], gates=gates))
    return _JITTED[id(jkfac)]


def _jax_precondition(jkfac, kfac, state, grads, gates):
    jstate = convert.torch_state_to_jax(state, kfac.specs)
    jgrads, _ = convert.torch_to_flax(grads)
    jgates = {k: jnp.float32(float(v)) for k, v in gates.items()}
    out = _jitted_precondition(jkfac)(jax.tree.map(jnp.asarray, jstate),
                                      jax.tree.map(jnp.asarray, jgrads),
                                      jgates)
    return {n: torch.from_numpy(np.asarray(v)) for n, v in
            convert.flax_to_torch(jax.tree.map(np.asarray, out)).items()}


def _rel(got, want) -> float:
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


@pytest.mark.parametrize('off', [(), ('16x27',), ('16x27', '64x576'),
                                 'all'], ids=['none', 'one', 'two', 'all'])
def test_gated_precondition_matches_jax(stepped, off):
    kfac, state, grads, jkfac = stepped
    keys = kfac.metric_bucket_keys()
    off = keys if off == 'all' else off
    gates = {k: torch.tensor(0.0 if k in off else 1.0) for k in keys}
    got = kfac.precondition(state, dict(grads), HYPER['damping'],
                            HYPER['lr'], gates=gates)
    nu = kfac.last_nu
    want = _jax_precondition(jkfac, kfac, state, grads, gates)
    buckets = selfheal.bucket_layer_map(kfac)
    gated = {n for k in off for n in buckets[k]}
    for name, t in got.items():
        assert _rel(t, want[name]) <= 1e-5, name
        layer = name.rsplit('.', 1)[0]
        if layer in gated:
            # The raw gradient, exactly, times nu.
            assert torch.equal(t, nu * grads[name]), name


def test_nan_in_gated_off_inverse_does_not_propagate(stepped):
    kfac, state, grads, _ = stepped
    inverses = {n: dict(e) for n, e in state['inverses'].items()}
    inverses['conv1']['QA'] = torch.full_like(inverses['conv1']['QA'],
                                              float('nan'))
    poisoned = {**state, 'inverses': inverses}
    keys = kfac.metric_bucket_keys()
    gates = {k: torch.tensor(0.0 if k == '16x27' else 1.0) for k in keys}
    out, stats = kfac.precondition(poisoned, dict(grads), HYPER['damping'],
                                   HYPER['lr'], with_stats=True,
                                   gates=gates)
    assert all(torch.isfinite(t).all() for t in out.values())
    assert all(torch.isfinite(v).all() for v in stats.values()
               if isinstance(v, torch.Tensor))
    ungated = kfac.precondition(poisoned, dict(grads), HYPER['damping'],
                                HYPER['lr'])
    assert not torch.isfinite(ungated['conv1.weight']).all()


def test_gates_all_on_change_only_the_vg_sum(stepped):
    kfac, state, grads, _ = stepped
    plain = kfac.precondition(state, dict(grads), HYPER['damping'],
                              HYPER['lr'])
    nu_plain = kfac.last_nu
    gates = {k: torch.tensor(1.0) for k in kfac.metric_bucket_keys()}
    gated = kfac.precondition(state, dict(grads), HYPER['damping'],
                              HYPER['lr'], gates=gates)
    assert abs(float(kfac.last_nu / nu_plain) - 1.0) <= 1e-6
    for name in plain:
        assert torch.allclose(gated[name] / kfac.last_nu,
                              plain[name] / nu_plain, rtol=0, atol=0) or \
            _rel(gated[name], plain[name]) <= 1e-6, name


# ---------------------------------------------------------------------------
# The chaos kinds and the rollback walk
# ---------------------------------------------------------------------------

def test_poison_factors_and_params_match_jax(stepped):
    kfac, state, grads, _ = stepped
    jstate = convert.torch_state_to_jax(state, kfac.specs)
    want = convert.jax_state_to_torch(
        jax.tree.map(np.asarray, jfaults.poison_factors(
            jax.tree.map(jnp.asarray, jstate))), kfac.specs)
    got = faults.poison_factors(state)
    for name, entry in got['factors'].items():
        for side, t in entry.items():
            assert torch.equal(t, want['factors'][name][side]), name
    assert math.isinf(float(got['factors']['conv1']['A'][0, 0]))
    assert torch.isfinite(state['factors']['conv1']['A']).all()
    params = {n: g.clone() for n, g in grads.items()}
    params['count'] = torch.tensor(3)
    jparams = jfaults.poison_params({n: jnp.asarray(v.numpy())
                                     for n, v in params.items()})
    out = faults.poison_params(params)
    assert faults.DIVERGE_SCALE == jfaults.DIVERGE_SCALE
    for n, v in out.items():
        assert np.array_equal(v.numpy(), np.asarray(jparams[n])), n


def _bundle(step: int, factor):
    return checkpoint.bundle_state(
        {'w': torch.ones(3)}, {'state': {}},
        {'factors': {'conv1': {'A': factor}}, 'step': step}, {},
        integrity='template', step=step, epoch=0, step_in_epoch=step,
        data_seed=0)


def test_rollback_passes_checksum_valid_nonfinite_bundle(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / 'steps'),
                                       max_to_keep=10)
    mgr.save(2, _bundle(2, torch.eye(3)))
    mgr.save(4, _bundle(4, torch.full((3, 3), float('inf'))))
    mgr.save(6, _bundle(6, torch.eye(3)))
    path = tmp_path / 'm.jsonl'
    s = sink.JsonlMetricsSink(str(path))
    # The poisoned bundle verifies: only the finiteness scan rejects it.
    assert integrity.verify_tree(mgr.restore(4))[0] is not False
    label, tree = selfheal.rollback_restore(mgr, from_step=7, onset_step=5,
                                            reason='test', sink=s)
    s.close()
    assert label == 2 and tree['scalars']['step'] == 2
    events = [r for r in sink.read_jsonl(str(path)) if r['kind'] == 'event']
    assert [e['event'] for e in events] == ['ckpt_quarantine',
                                            'selfheal_rollback']
    assert events[0]['data']['label'] == 4
    assert 'non-finite' in events[0]['data']['reason']
    assert events[1]['data'] == {'from_step': 7, 'to_step': 2, 'label': 2,
                                 'reason': 'test'}
    assert 4 not in mgr.all_steps()
    with pytest.raises(selfheal.SelfHealExhausted):
        selfheal.rollback_restore(mgr, from_step=3, onset_step=1)


# ---------------------------------------------------------------------------
# Through the CIFAR CLI
# ---------------------------------------------------------------------------

TINY = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 8,
        'synthetic_size': 32, 'epochs': 2, 'no_augment': True,
        'kfac_update_freq': 6, 'quiet': True, 'metrics_interval': 1,
        'use_inv_kfac': True}


def _events(path):
    return [r for r in sink.read_jsonl(str(path)) if r['kind'] == 'event'
            and r['event'].startswith('selfheal')]


def test_cli_corrupt_factor_quarantines_and_readmits(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv('KFAC_CHAOS', 'corrupt-factor@2')
    path = tmp_path / 'm.jsonl'
    res = cifar.train({**TINY, 'kfac_metrics': str(path), 'selfheal': True,
                       'selfheal_window': 1}, device='cpu')
    names = [e['event'] for e in _events(path)]
    assert 'selfheal_quarantine' in names and 'selfheal_readmit' in names
    q = next(e for e in _events(path) if e['event'] == 'selfheal_quarantine')
    assert q['data']['bucket'] == '16x27'
    assert all(math.isfinite(v) for v in res['losses'])
    assert res['rollbacks'] == []


def test_cli_diverge_rolls_back_in_process(tmp_path, monkeypatch):
    monkeypatch.setenv('KFAC_CHAOS', 'diverge@3')
    path = tmp_path / 'm.jsonl'
    res = cifar.train({**TINY, 'kfac_metrics': str(path),
                       'selfheal': True, 'selfheal_window': 1,
                       'selfheal_diverge_ratio': 1.5,
                       'checkpoint_dir': str(tmp_path / 'ck'),
                       'checkpoint_steps': 2}, device='cpu')
    names = [e['event'] for e in _events(path)]
    assert names[0] == 'selfheal_escalate'
    assert names.count('selfheal_rollback') == 1
    assert len(res['rollbacks']) == 1
    assert res['rollbacks'][0]['to_step'] <= 3
    assert all(math.isfinite(v) for v in res['losses'])
    assert res['steps'] == 8


def test_cli_unarmed_bit_for_bit_and_armed_nu(tmp_path):
    runs = {}
    for label, extra in (('plain', {}),
                         ('metrics', {'kfac_metrics': str(tmp_path / 'a')}),
                         ('armed', {'kfac_metrics': str(tmp_path / 'b'),
                                    'selfheal': True})):
        res = cifar.train({**TINY, 'epochs': 1, 'max_steps': 2, **extra},
                          device='cpu')
        runs[label] = (res['losses'], {
            n: p.detach().clone()
            for n, p in res['state'].model.named_parameters()})
    assert runs['plain'][0] == runs['metrics'][0]
    for n, p in runs['plain'][1].items():
        assert torch.equal(p, runs['metrics'][1][n]), n
    nus = {k: [r['metrics']['kfac/nu'] for r in sink.read_jsonl(str(p))
               if r['kind'] == 'step'] for k, p in (('metrics', tmp_path / 'a'),
                                                  ('armed', tmp_path / 'b'))}
    assert abs(nus['armed'][0] / nus['metrics'][0] - 1.0) <= 1e-6
    assert metrics.METRIC_KEYS
