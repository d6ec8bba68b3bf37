"""On-device K-FAC metrics of the torch port (``KFAC(collect_metrics=
True)``, ``observability.metrics``) against the JAX package, on the CPU.

  - the metric schema, ``shape_key`` and the bucket key sets of a CNN, a
    Transformer LM with its embedding and a grouped-conv net equal JAX's
    (the conv basis differs, ``(c, kh, kw)`` against ``(kh, kw, c)``, the
    dims do not);
  - ``count_clipped_eigvals`` / ``_stacks`` exactly on the JAX run's
    converted inverses, on an indefinite construction (exact zeros and
    negative eigenvalues, fp32 and bf16), and on a padded row stack: the
    port's stacks hold zeros in padding and in slots of other rows, which
    only the held-slot index leaves out;
  - ``precond_stats`` and ``factors_finite`` on seeded inputs;
  - ``KFAC.step`` metrics over 12 steps with firings against the JAX
    ``KFAC(collect_metrics=True)``, jitted per cadence variant, under
    exact eigh (``eigh_method='xla'``): a small CNN firing in two chunks
    with ``nonfinite_guard`` and a ``nan-batch``-poisoned step, and a
    small Transformer LM with its embedding, monolithic firings and the
    guard off (the metrics' own finiteness flag). The JAX step runs each step
    on the port's current parameters, so both see one trajectory: damping,
    ``nu`` and the norms within rel 1e-5, the counters exactly, the bucket
    key sets equal;
  - metrics on are the metrics-off step bit for bit (parameters, losses,
    every state entry but ``metrics``), and metrics off runs no metrics
    code at all (every metrics function replaced by one that raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
from distributed_kfac_pytorch_tpu.observability import metrics as jmetrics
from distributed_kfac_pytorch_tpu_torch import convert, fp16
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.observability import \
    metrics as pmetrics
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

STAT_TOL = 1e-5
STEPS, I_FREQ, LR, BATCH = 12, 5, 0.1, 24
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=I_FREQ)
VOCAB, D, HEADS, SEQ = 40, 16, 2, 8


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_cnn():
    from test_distributed import SmallCNN
    return SmallCNN()


def _torch_cnn():
    from test_torch_distributed import SmallCNN
    return SmallCNN()


def _torch_lm():
    return transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=1, num_heads=HEADS, max_len=SEQ,
        dropout=0.0, tie_weights=False)


def _jax_lm():
    return jtl.TransformerLM(vocab_size=VOCAB, d_model=D, num_layers=1,
                             num_heads=HEADS, max_len=SEQ, dropout=0.0,
                             tie_weights=False)


# ---------------------------------------------------------------------------
# Schema, keys and the counting functions
# ---------------------------------------------------------------------------

def test_schema_matches_jax():
    assert pmetrics.METRIC_KEYS == jmetrics.METRIC_KEYS
    assert pmetrics._INT_KEYS == jmetrics._INT_KEYS
    assert pmetrics.shape_key((16, 129)) == jmetrics.shape_key((16, 129))
    m = pmetrics.init_metrics(['8x28'], 'cpu')
    jm = jmetrics.init_metrics(['8x28'])
    assert set(m) == set(jm)
    for k in pmetrics.METRIC_KEYS:
        assert m[k].dtype == (torch.int32 if k in pmetrics._INT_KEYS
                              else torch.float32), k
        assert float(m[k]) == float(jm[k]), k
    flat = pmetrics.flatten_metrics(m)
    assert list(flat) == list(jmetrics.flatten_metrics(jm))


@pytest.mark.parametrize('net', ['cnn', 'lm', 'grouped'])
def test_bucket_keys_match_jax(net):
    if net == 'cnn':
        port, jmodel, x = _torch_cnn(), _jax_cnn(), jnp.zeros((2, 8, 8, 3))
        kw = {}
    elif net == 'lm':
        port, jmodel = _torch_lm(), _jax_lm()
        x, kw = jnp.zeros((2, SEQ), jnp.int32), {'train': False}
    else:
        from test_grouped_conv import DWNet as JDWNet
        from test_torch_grouped_conv import DWNet
        port, jmodel, x = DWNet(), JDWNet(), jnp.zeros((2, 8, 8, 3))
        kw = {}
    skip = {'skip_layers': []} if net == 'lm' else {}
    jk = JKFAC(jmodel, collect_metrics=True, **skip)
    variables, _ = jax.eval_shape(
        lambda k: jk.init(k, x, **kw), jax.random.PRNGKey(0))
    want = jk.metric_bucket_keys(variables['params'])
    kfac = KFAC(port, device='cpu', collect_metrics=True, **skip)
    assert kfac.metric_bucket_keys() == want
    assert list(kfac.init_state()['metrics']['bucket_norms']) == want


def _constructed_inverses(dtype):
    """Per-layer eigen entries with exact zeros, negatives and tiny
    positives in their spectra, the JAX dict and the torch one."""
    rng = np.random.default_rng(3)
    jinv, pinv = {}, {}
    for i, (da, dg) in enumerate(((28, 8), (129, 16), (17, 10))):
        entry = {}
        for side, n in (('A', da), ('G', dg)):
            d = rng.normal(size=n).astype(np.float32)
            d[rng.random(n) < 0.3] = 0.0
            d[0] = 1e-30
            entry[f'd{side}'] = d
            entry[f'Q{side}'] = np.eye(n, dtype=np.float32)
        jinv[f'l{i}'] = {k: jnp.asarray(v, dtype) for k, v in entry.items()}
        pinv[f'l{i}'] = {k: convert.array_to_tensor(np.asarray(
            jinv[f'l{i}'][k])) for k in entry}
    # A baked layer (no spectrum) beside them.
    jinv['baked'] = {'A_inv': jnp.eye(3), 'G_inv': jnp.eye(2)}
    pinv['baked'] = {'A_inv': torch.eye(3), 'G_inv': torch.eye(2)}
    return jinv, pinv


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['fp32', 'bf16'])
def test_count_clipped_eigvals_exact_on_an_indefinite_construction(dtype):
    jinv, pinv = _constructed_inverses(dtype)
    want = int(jmetrics.count_clipped_eigvals(jinv))
    assert want > 10
    got = pmetrics.count_clipped_eigvals(pinv, 'cpu')
    assert got.dtype == torch.int32 and int(got) == want
    assert int(pmetrics.count_clipped_eigvals({}, 'cpu')) == 0


def test_count_clipped_eigvals_stacks_skips_padding_and_other_rows():
    """A row stack of 5 slots: slots 0 and 3 hold this row's layers, slot
    4 another row's layer, slots 1-2 padding. JAX pads with d = 1; the
    port's stack after a firing holds zeros there, and counts the held
    slots only."""
    rng = np.random.default_rng(5)
    held = rng.normal(size=(2, 12)).astype(np.float32)
    held[0, :4] = 0.0
    jstack = np.ones((5, 12), np.float32)
    jstack[[0, 3]] = held
    jstack[4] = 1.0          # JAX: another row's slot is that row's
    pstack = np.zeros((5, 12), np.float32)
    pstack[[0, 3]] = held
    want = int(jmetrics.count_clipped_eigvals_stacks(
        {'12': {'d': jnp.asarray(jstack)}, '7': {'inv': jnp.eye(7)}}))
    stacks = {'12': {'d': torch.from_numpy(pstack)},
              '7': {'inv': torch.eye(7)}}
    got = pmetrics.count_clipped_eigvals_stacks(
        stacks, 'cpu', {'12': torch.tensor([0, 3])})
    assert int(got) == want == int((held <= 0).sum())
    # Without the index the zeros of padding and other rows count.
    assert int(pmetrics.count_clipped_eigvals_stacks(stacks, 'cpu')) \
        == want + 3 * 12


def test_precond_stats_matches_jax():
    rng = np.random.default_rng(7)
    shapes = {'a': (8, 28), 'b': (16, 129), 'c': (8, 28), 'd': (10, 17)}
    g = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    v = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    nu = np.float32(0.37)
    want = jmetrics.precond_stats({n: jnp.asarray(t) for n, t in g.items()},
                                  {n: jnp.asarray(t) for n, t in v.items()},
                                  jnp.asarray(nu))
    got = pmetrics.precond_stats(
        {n: torch.from_numpy(t) for n, t in g.items()},
        {n: torch.from_numpy(t) for n, t in v.items()}, torch.tensor(nu))
    for key in ('nu', 'grad_norm', 'precond_norm'):
        assert abs(float(got[key]) - float(want[key])) <= STAT_TOL * abs(
            float(want[key])), key
    assert list(got['bucket_norms']) == list(want['bucket_norms'])
    for k, t in want['bucket_norms'].items():
        assert abs(float(got['bucket_norms'][k]) - float(t)) <= \
            STAT_TOL * float(t), k


def test_factors_finite_sees_nan_and_inf():
    ok = {'l': {'A': torch.eye(3), 'G': torch.ones(2, 2,
                                                   dtype=torch.bfloat16)}}
    assert bool(pmetrics.factors_finite(ok))
    for bad in (float('nan'), float('inf'), -float('inf')):
        f = {'l': {'A': torch.eye(3), 'G': torch.eye(2)}}
        f['l']['A'][1, 2] = bad
        assert not bool(pmetrics.factors_finite(f))
        assert not bool(fp16.tree_all_finite(f))


# ---------------------------------------------------------------------------
# KFAC.step metrics against the JAX KFAC
# ---------------------------------------------------------------------------

CONFIGS = {
    'cnn_chunks_guard': ('cnn', dict(inverse_method='eigen',
                                     eigh_method='xla', inv_update_freq=6,
                                     inv_pipeline_chunks=2,
                                     nonfinite_guard=True), 7),
    'lm_eigen': ('lm', dict(inverse_method='eigen', eigh_method='xla'),
                 None),
}


def _flags(knobs, step):
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, knobs.get('inv_update_freq', I_FREQ),
        knobs.get('inv_pipeline_chunks', 1)))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _batch(net, step, poisoned):
    rng = np.random.default_rng(200 + step)
    if net == 'cnn':
        x = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=BATCH).astype(np.int32)
        if step == poisoned:
            x[0, 0, 0, 0] = np.nan
        return x, y
    ids = rng.integers(0, VOCAB, size=(BATCH // 4, SEQ)).astype(np.int32)
    return ids, rng.integers(0, VOCAB, size=ids.shape).astype(np.int32)


def _port_inputs(net, x, y):
    if net == 'cnn':
        return (torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), torch.from_numpy(y).long())
    return torch.from_numpy(x).long(), torch.from_numpy(y).long()


def _port_loss(net, y):
    if net == 'cnn':
        return lambda out: F.cross_entropy(out, y)
    return lambda out: engine.lm_loss(out, y)


def _jax_loss(net, y):
    def xent(logits):
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, y[..., None], -1).mean()
    return xent


def _torch_model(net, seed):
    torch.manual_seed(seed)
    return _torch_cnn() if net == 'cnn' else _torch_lm()


def _port_run(net, knobs, poisoned, collect=True, model_seed=0):
    """12 port steps; the poisoned step applies no update (its gradients
    are NaN). Returns the per-step records and the parameters each step
    started from."""
    model = _torch_model(net, model_seed)
    skip = {'skip_layers': []} if net == 'lm' else {}
    kfac = KFAC(model, device='cpu', collect_metrics=collect,
                **{**HYPER, **skip, **knobs})
    state = kfac.init_state()
    recs, params_at = [], []
    for step in range(STEPS):
        params_at.append({k: v.detach().clone()
                          for k, v in model.state_dict().items()})
        x, y = _port_inputs(net, *_batch(net, step, poisoned))
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            _port_loss(net, y), x)
        precond, state = kfac.step(state, grads, captures,
                                   **_flags(knobs, step))
        if step != poisoned:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= LR * precond[n]
        recs.append({'loss': loss.clone(),
                     'metrics': state.get('metrics')})
    return kfac, state, recs, params_at, model


def _jax_metrics(net, knobs, poisoned, params_at):
    """The JAX KFAC's metrics of each step, run on the port's parameters
    of that step (one trajectory), jitted per cadence variant."""
    jmodel = _jax_cnn() if net == 'cnn' else _jax_lm()
    skip = {'skip_layers': []} if net == 'lm' else {}
    jk = JKFAC(jmodel, collect_metrics=True, **{**HYPER, **skip, **knobs})
    kw = {} if net == 'cnn' else {'train': False}
    x0, _ = _batch(net, 0, None)
    _, kstate = jax.jit(lambda k, v: jk.init(k, v, **kw))(
        jax.random.PRNGKey(0), jnp.asarray(x0))

    def step_fn(params, kstate, x, y, flags):
        _, _, grads, captures, _ = jk.capture.loss_and_grads(
            _jax_loss(net, y), params, x, **kw)
        _, kstate = jk.step(kstate, grads, captures, **dict(flags))
        return kstate

    jstep = jax.jit(step_fn, static_argnums=4)
    embeddings = ('embed',) if net == 'lm' else ()
    out = []
    for step in range(STEPS):
        params, _ = convert.torch_to_flax(params_at[step], embeddings)
        x, y = (jnp.asarray(v) for v in _batch(net, step, poisoned))
        kstate = jstep(jax.tree.map(jnp.asarray, params), kstate, x, y,
                       tuple(sorted(_flags(knobs, step).items())))
        out.append(jax.tree.map(np.asarray, kstate['metrics']))
    return out, jax.tree.map(np.asarray, kstate['inverses'])


@pytest.fixture(scope='module', params=list(CONFIGS))
def runs(request):
    net, knobs, poisoned = CONFIGS[request.param]
    kfac, state, recs, params_at, _ = _port_run(net, knobs, poisoned)
    jrecs, jinv = _jax_metrics(net, knobs, poisoned, params_at)
    return {'name': request.param, 'knobs': knobs, 'poisoned': poisoned,
            'kfac': kfac, 'state': state, 'port': recs, 'jax': jrecs,
            'jinv': jinv}


def _close(got, want, what):
    got, want = float(got), float(want)
    if np.isnan(want):
        assert np.isnan(got), what
        return
    assert abs(got - want) <= STAT_TOL * abs(want), (what, got, want)


def test_step_metrics_match_jax(runs):
    for step, (rec, jm) in enumerate(zip(runs['port'], runs['jax'])):
        m = rec['metrics']
        # (A jitted JAX dict comes back with its keys sorted.)
        assert set(m) == set(jm) and set(m['bucket_norms']) == set(
            jm['bucket_norms']), step
        for key in ('damping', 'nu', 'grad_norm', 'precond_norm'):
            _close(m[key], jm[key], (step, key))
        for key, t in jm['bucket_norms'].items():
            _close(m['bucket_norms'][key], t, (step, key))
        for key in pmetrics._INT_KEYS:
            assert m[key].dtype == torch.int32
            assert int(m[key]) == int(jm[key]), (step, key)


def test_counters_follow_the_cadence(runs):
    knobs, poisoned = runs['knobs'], runs['poisoned']
    chunks = knobs.get('inv_pipeline_chunks', 1)
    fired = [_flags(knobs, s) for s in range(STEPS)]
    final = runs['port'][-1]['metrics']
    assert int(final['factor_updates']) == STEPS
    assert int(final['inv_updates']) == sum(
        bool(f.get('inv_update')) for f in fired)
    assert int(final['inv_chunk_firings']) == sum(
        f.get('inv_chunk') is not None for f in fired)
    if chunks > 1:
        assert int(final['inv_chunk_firings']) > 0
    skips = [int(r['metrics']['nonfinite_skips']) for r in runs['port']]
    assert skips == [int(poisoned is not None and s >= poisoned)
                     for s in range(STEPS)]
    assert int(final['eig_clipped']) == 0     # full-rank factors


def test_clip_count_exact_on_the_converted_jax_inverses(runs):
    """The counting functions on the JAX run's final inverses and on the
    same inverses converted to the port's layout (``convert`` permutes the
    conv A basis): as they are (full rank, no clipped eigenvalue) and with
    part of every spectrum floored to 0 or made negative."""
    specs = runs['kfac'].specs
    floored = {}
    for n, e in runs['jinv'].items():
        floored[n] = {}
        for k, v in e.items():
            v = np.array(v)
            if k in ('dA', 'dG'):
                v[::3] = 0.0
                v[1::7] *= -1.0
            floored[n][k] = v
    for jinv in (runs['jinv'], floored):
        want = int(jmetrics.count_clipped_eigvals(
            jax.tree.map(jnp.asarray, jinv)))
        got = pmetrics.count_clipped_eigvals(
            convert.jax_inverses_to_torch(jinv, specs), 'cpu')
        assert int(got) == want
    assert want > 0


def test_metrics_on_is_metrics_off_bit_for_bit():
    net, knobs, poisoned = CONFIGS['cnn_chunks_guard']
    _, on, rec_on, _, model_on = _port_run(net, knobs, poisoned, True)
    _, off, rec_off, _, model_off = _port_run(net, knobs, poisoned, False)
    assert 'metrics' not in off and 'metrics' in on
    assert set(on) - {'metrics'} == set(off)
    for a, b in zip(rec_on, rec_off):
        assert _same_bits(a['loss'], b['loss'])
    for (n, p), (_, q) in zip(model_on.named_parameters(),
                              model_off.named_parameters()):
        assert _same_bits(p.detach(), q.detach()), n
    for key in off:
        if key in ('step', 'inv_chunk_phase'):
            assert on[key] == off[key]
            continue
        for layer, e in off[key].items():
            for k, t in e.items():
                assert _same_bits(on[key][layer][k], t), (key, layer, k)


def test_metrics_off_runs_no_metrics_code(monkeypatch):
    """With ``collect_metrics`` off (and the guard off) the step computes
    no statistic, no clip count and no finiteness flag: the step of the
    port before the metrics existed."""
    def boom(*_a, **_k):
        raise AssertionError('metrics code ran with metrics off')
    for fn in ('precond_stats', 'update_metrics', 'count_clipped_eigvals',
               'count_clipped_eigvals_stacks', 'factors_finite',
               'init_metrics'):
        monkeypatch.setattr(pmetrics, fn, boom)
    monkeypatch.setattr(fp16, 'tree_all_finite', boom)
    _, state, _, _, _ = _port_run('cnn', {'inverse_method': 'eigen',
                                          'inv_pipeline_chunks': 5}, None,
                                  collect=False)
    assert set(state) == {'step', 'factors', 'inverses', 'inv_chunk_phase'}


def test_state_dict_leaves_metrics_out_and_resume_restarts_them():
    net, knobs, _ = CONFIGS['cnn_chunks_guard']
    kfac, state, _, _, _ = _port_run(net, knobs, None)
    sd = kfac.state_dict(state, include_inverses=True)
    assert 'metrics' not in sd
    assert kfac.memory_usage(state) == kfac.memory_usage(
        {k: v for k, v in state.items() if k != 'metrics'})
    loaded = kfac.load_state_dict(sd)
    assert int(loaded['metrics']['factor_updates']) == 0
    assert list(loaded['metrics']['bucket_norms']) == list(
        state['metrics']['bucket_norms'])
