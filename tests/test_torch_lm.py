"""The LSTM language-model slice of the torch port against the JAX package:
a small LSTM LM (embedding and hidden 12, 2 layers of the 8-gate K-FAC
cell, vocabulary 40, dropout 0) with the same converted weights and the
same BPTT windows (batch 3, BPTT 4) of the synthetic corpus, three steps
of the LM CLI's update -- K-FAC on the 16 gates (``embed`` and
``decoder`` skipped), the global-norm clip at 0.25 over every update,
SGD with momentum 0.9 at lr 1.0 -- with factors every step and inverses
at steps 0 and 2, under

  - ``inverse_method='eigen', eigh_method='jacobi'``: every factor through
    the Jacobi eigh (A 13, odd: the pad path; G 12);
  - ``inverse_method='auto', auto_eigen_max_dim=12`` with ``'jacobi'``:
    A (13) by damped Cholesky, G (12) by Jacobi, so every layer is mixed
    and preconditions through its baked inverses.

The JAX side is jitted (its Jacobi is the vmapped XLA iteration); the
port runs its kernels' plain versions (CPU tensors). Tolerances:
  - losses: rel 1e-4;
  - each step's factor contribution (``update_factors`` with decay 0, on
    its own scale): <= 1e-4 of its largest entry (sums of 4 per-call
    fp32 Grams in another order; measured <= 1e-6);
  - preconditioned gradients and updated parameters, per tensor: <= 1e-4
    of the tensor's largest entry (measured <= 3e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import lstm_lm as jlm
from distributed_kfac_pytorch_tpu.training import datasets as jdata
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_language_model as cli
from distributed_kfac_pytorch_tpu_torch.capture import KFACCapture
from distributed_kfac_pytorch_tpu_torch.models import lstm_lm
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import datasets, engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


VOCAB, WIDTH, BATCH, BPTT, STEPS, INV_FREQ = 40, 12, 3, 4, 3, 2
LR, MOMENTUM, CLIP = 1.0, 0.9, 0.25
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=INV_FREQ, skip_layers=['embed', 'decoder'])
METHODS = {'eigen_jacobi': dict(inverse_method='eigen',
                                eigh_method='jacobi'),
           'auto12_jacobi': dict(inverse_method='auto',
                                 auto_eigen_max_dim=12,
                                 eigh_method='jacobi')}
TOL = 1e-4


def _batches():
    train_ids, _, _ = datasets.get_lm_corpus(synthetic_size=400,
                                             vocab_size=VOCAB)
    return list(datasets.bptt_batches(train_ids, BATCH, BPTT,
                                      shuffle_offset=True, seed=0,
                                      epoch=0))[:STEPS]


def _jax_model():
    return jlm.LSTMLanguageModel(vocab_size=VOCAB, embedding_dim=WIDTH,
                                 hidden_dim=WIDTH, num_layers=2,
                                 dropout=0.0)


def _jax_run(batches, knobs):
    kfac = JKFAC(_jax_model(), **HYPER, **knobs)
    variables, kstate = kfac.init(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0][0]), train=False)
    params = variables['params']
    tx = optax.chain(optax.clip_by_global_norm(CLIP),
                     optax.trace(MOMENTUM), optax.scale(-LR))
    opt_state = tx.init(params)
    init = jax.tree.map(np.asarray, params)

    def step_fn(params, opt_state, kstate, x, y, inv_update):
        loss, _, grads, captures, _ = kfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out[0], y).mean(), params, x, train=False)
        contrib = kfac.update_factors(kstate, captures, factor_decay=0.0)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True,
                                    inv_update=inv_update)
        updates, opt_state = tx.update(precond, opt_state, params)
        params = optax.apply_updates(params, updates)
        return loss, precond, params, opt_state, kstate, contrib

    jstep = jax.jit(step_fn, static_argnames=('inv_update',))
    rec = []
    for step, (x, y) in enumerate(batches):
        loss, precond, params, opt_state, kstate, contrib = jstep(
            params, opt_state, kstate, jnp.asarray(x), jnp.asarray(y),
            inv_update=step % INV_FREQ == 0)
        rec.append({'loss': float(loss),
                    'contrib': jax.tree.map(np.asarray, contrib),
                    'precond': jax.tree.map(np.asarray, precond),
                    'params': jax.tree.map(np.asarray, params)})
    return init, rec


def _torch_model(init):
    model = lstm_lm.LSTMLanguageModel(VOCAB, WIDTH, WIDTH, num_layers=2,
                                      dropout=0.0)
    model.load_state_dict(convert.flax_to_torch(init))
    return model


def _torch_run(init, batches, knobs):
    model = _torch_model(init)
    kfac = KFAC(model, device='cpu', **HYPER, **knobs)
    state = kfac.init_state()
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    rec = []
    for step, (x, y) in enumerate(batches):
        ids, targets = torch.from_numpy(x).long(), torch.from_numpy(y).long()
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: engine.lm_loss(out, targets), ids)
        contrib = kfac.update_factors(state, captures, factor_decay=0.0)
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True,
                                   inv_update=step % INV_FREQ == 0)
        clipped = engine.clip_by_global_norm(precond, CLIP)
        for name, p in model.named_parameters():
            p.grad = clipped[name]
        opt.step()
        rec.append({'loss': float(loss), 'contrib': contrib,
                    'precond': {n: t.clone() for n, t in precond.items()},
                    'params': {n: p.detach().clone()
                               for n, p in model.named_parameters()}})
    return kfac, state, rec


@pytest.fixture(scope='module', params=list(METHODS))
def runs(request):
    knobs = METHODS[request.param]
    batches = _batches()
    init, jrec = _jax_run(batches, knobs)
    kernels.reset_launches()
    kfac, state, trec = _torch_run(init, batches, knobs)
    return {'kfac': kfac, 'state': state, 'init': init, 'jax': jrec,
            'torch': trec, 'batches': batches,
            'launches': dict(kernels.LAUNCHES)}


def _close_on_scale(got: np.ndarray, ref: np.ndarray, what: str):
    scale = np.abs(ref).max()
    assert scale > 0, f'{what}: all zero'
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale,
                               err_msg=what)


def test_losses(runs):
    np.testing.assert_allclose([r['loss'] for r in runs['torch']],
                               [r['loss'] for r in runs['jax']], rtol=1e-4)


@pytest.mark.parametrize('step', range(STEPS))
def test_factor_contributions(runs, step):
    ref = convert.jax_factors_to_torch(runs['jax'][step]['contrib'],
                                       runs['kfac'].specs)
    got = runs['torch'][step]['contrib']
    assert set(ref) == set(got) and len(got) == 16
    for name, f in ref.items():
        for side in ('A', 'G'):
            _close_on_scale(got[name][side].numpy(), f[side].numpy(),
                            f'{name}/{side} step {step}')


@pytest.mark.parametrize('what', ['precond', 'params'])
@pytest.mark.parametrize('step', range(STEPS))
def test_preconditioned_grads_and_params(runs, step, what):
    ref = convert.flax_to_torch(runs['jax'][step][what])
    got = runs['torch'][step][what]
    assert set(ref) == set(got)
    for name, t in ref.items():
        _close_on_scale(got[name].numpy(), t.numpy(), f'{name} step {step}')


def test_inverse_slots(runs):
    # 'eigen': eigenpairs on both sides; 'auto' at 12: A (13) baked by
    # Cholesky, G (12) eigen and baked at the firing's damping (mixed).
    mixed = runs['kfac'].inverse_method == 'auto'
    for name, entry in runs['state']['inverses'].items():
        assert set(entry) == ({'A_inv', 'QG', 'dG', 'G_inv'} if mixed
                              else {'QA', 'dA', 'QG', 'dG'}), name
        if not mixed:
            assert entry['QA'].shape == (13, 13)


def test_cpu_path_launches_no_kernel(runs):
    assert set(runs['launches'].values()) == {0}
    assert 'jacobi_eigh' in runs['launches']


def test_lm_train_step_is_the_manual_step(runs):
    # engine.lm_train_step (the CLI's step) reproduces the loop above.
    model = _torch_model(runs['init'])
    kfac = KFAC(model, device='cpu', **HYPER,
                **METHODS[next(k for k, v in METHODS.items()
                               if v['inverse_method']
                               == runs['kfac'].inverse_method)])
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=LR,
                                               momentum=MOMENTUM),
        kfac=kfac, kfac_state=kfac.init_state())
    hyper = {'lr': LR, 'damping': HYPER['damping']}
    for step, (x, y) in enumerate(runs['batches']):
        flags = engine.cadence_flags(step, 1, INV_FREQ)
        loss = engine.lm_train_step(
            state, torch.from_numpy(x).long(), torch.from_numpy(y).long(),
            hyper, flags, grad_clip=CLIP)
        ref = runs['torch'][step]
        assert float(loss) == ref['loss']
        for name, p in model.named_parameters():
            assert torch.equal(p.detach(), ref['params'][name]), name


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(3)
    grads = {'a': rng.normal(size=(3, 4)).astype(np.float32),
             'b': rng.normal(size=(5,)).astype(np.float32)}
    for max_norm in (0.25, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, None)
        got = engine.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('kwargs', [dict(synthetic_size=500, vocab_size=40),
                                    dict(synthetic_size=2000,
                                         vocab_size=10000)])
def test_corpus_and_windows_equal_jax(kwargs):
    got = datasets.get_lm_corpus(**kwargs)
    ref = jdata.get_lm_corpus(None, **kwargs)
    assert got[2] == ref[2]
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    for opts in (dict(), dict(shuffle_offset=True, seed=5, epoch=2),
                 dict(shuffle_offset=True, seed=5, epoch=3,
                      skip_batches=2)):
        w_got = list(datasets.bptt_batches(got[0], 4, 7, **opts))
        w_ref = list(jdata.bptt_batches(ref[0], 4, 7, **opts))
        assert len(w_got) == len(w_ref) > 0
        for (xg, yg), (xr, yr) in zip(w_got, w_ref):
            assert np.array_equal(xg, xr) and np.array_equal(yg, yr)


TINY = {'emsize': 12, 'nhid': 12, 'nlayers': 2, 'synthetic_vocab': 40,
        'synthetic_size': 2000, 'bptt': 4, 'batch_size': 3, 'epochs': 1,
        'max_steps': 2, 'kfac_update_freq': 1, 'inverse_method': 'eigen',
        'eigh_method': 'jacobi', 'time_steps': True, 'quiet': True}


def test_train_two_steps_on_cpu():
    kernels.reset_launches()
    res = cli.train(TINY, device='cpu')
    assert res['steps'] == 2 and res['device'] == 'cpu'
    assert res['fired'] == ['inverse', 'inverse']
    assert len(res['losses']) == 2 and len(res['step_ms']) == 2
    assert all(math.isfinite(v) for v in res['losses'])
    assert math.isfinite(res['val']['loss'])
    assert res['val']['ppl'] == pytest.approx(math.exp(res['val']['loss']))
    assert len(res['state'].kfac.specs) == 16
    assert set(kernels.LAUNCHES.values()) == {0}


def test_fixed_batch_and_dropout_generator():
    # With dropout, the same seed gives the same trajectory; --fixed-batch
    # trains on one window at every step.
    cfg = {**TINY, 'dropout': 0.5, 'max_steps': 3, 'fixed_batch': True,
           'kfac_update_freq': 2}
    a = cli.train(cfg, device='cpu')
    b = cli.train(cfg, device='cpu')
    assert a['losses'] == b['losses'] and len(a['losses']) == 3
    assert a['fired'] == ['inverse', 'factor', 'inverse']


def test_cli_parses_defaults_and_rejects_transformer():
    args = cli.build_parser().parse_args([])
    assert (args.emsize, args.nhid, args.nlayers, args.bptt,
            args.batch_size, args.dropout, args.grad_clip, args.base_lr,
            args.damping, args.kl_clip, args.stat_decay,
            args.kfac_update_freq, args.kfac_cov_update_freq,
            args.inverse_method, args.eigh_method, args.device) == (
        650, 650, 2, 35, 20, 0.5, 0.25, 1.0, 0.003, 0.001, 0.95, 10, 1,
        'auto', 'auto', 'cuda')
    # The Transformer and its long-context flags are ported: the chunked
    # fold runs on one process, the ring under a process group
    # (tests/test_torch_seq_parallel.py); the JAX CLI's checks raise.
    assert (args.arch, args.nheads, args.kfac_approx, args.seq_parallel,
            args.attn_block_size) == ('lstm', 10, 'expand', 1, None)
    res = cli.train({**TINY, 'arch': 'transformer', 'emsize': 8,
                     'nheads': 2, 'attn_block_size': 2}, device='cpu')
    assert all(math.isfinite(v) for v in res['losses'])
    assert res['state'].model.block0.attn.attn_block_size == 2
    with pytest.raises(ValueError, match='--seq-parallel requires --arch '
                                         'transformer'):
        cli.train({**TINY, 'seq_parallel': 2}, device='cpu')
    with pytest.raises(ValueError, match='does not divide the world'):
        cli.train({**TINY, 'arch': 'transformer', 'seq_parallel': 2},
                  device='cpu')


def test_unskipped_embedding_raises_by_name(tmp_path):
    # The single-device KFAC preconditions an unskipped embedding; so does
    # the distributed wrapper (its diagonal A replicated), and it takes a
    # non-expand kfac_approx.
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    res = cli.train({**TINY, 'skip_layers': ['decoder']}, device='cpu')
    assert res['state'].kfac.specs['embed'].kind == 'embedding'
    assert all(math.isfinite(v) for v in res['losses'])
    assert 'embed' in KFACCapture(
        lstm_lm.LSTMLanguageModel(10, 4, 4, num_layers=1)).specs
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/s',
                            rank=0, world_size=1)
    try:
        dk = DistributedKFAC(KFAC(lstm_lm.LSTMLanguageModel(
            10, 4, 4, num_layers=1), device='cpu'))
        assert dk.assignment.diag_layers == ('embed',)
        assert tuple(dk.init_state()['diag_inv']['embed'].shape) == (10,)
        dk = DistributedKFAC(KFAC(lstm_lm.LSTMLanguageModel(
            10, 4, 4, num_layers=1), skip_layers=['embed', 'decoder'],
            kfac_approx='reduce', device='cpu'))
        assert dk.kfac.kfac_approx == 'reduce'
    finally:
        dist.destroy_process_group()
