"""The Transformer LM slice of the torch port against the JAX package: the
decoder-only ``TransformerLM`` (2 blocks, d 32, 4 heads, vocabulary 64,
sequence 8, batch 2, dropout 0), its attention, the parameter conversion,
and three steps of K-FAC + SGD on one numpy batch, factors every step and
inverses at steps 0 and 2, for each of

  - ``expand`` untied (embedding + decoder preconditioned), Cholesky;
  - ``expand`` tied (the lookup's statistics only), eigen / ``'xla'``;
  - ``reduce`` tied (tied statistics on: the attend site feeds the
    embedding's factors), Cholesky;
  - ``reduce`` untied, eigen / ``'xla'``.

The JAX side runs eagerly as its own tests run it on the CPU (no Pallas
kernel on this path: its fused kernels are off by default); the port runs
its kernels' plain versions (CPU tensors), with the weights carried over by
``convert.load_flax_params``. Tolerances, each relative to the largest
reference entry: the model's logits and the attention <= 1e-5; factors <=
1e-5; preconditioned gradients and the KL-clip scale ``nu`` <= 1e-4; the
losses rel 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
from distributed_kfac_pytorch_tpu.parallel import sequence as jseq
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_language_model as cli
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.parallel import sequence
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


VOCAB, D, HEADS, LAYERS, SEQ, BATCH, MAX_LEN = 64, 32, 4, 2, 8, 2, 16
STEPS, INV_FREQ, LR = 3, 2, 0.1
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=INV_FREQ)
# name: (kfac_approx, tied, inverse knobs)
CONFIGS = {
    'expand_untied': ('expand', False, dict(inverse_method='cholesky')),
    'expand_tied': ('expand', True, dict(inverse_method='eigen',
                                         eigh_method='xla')),
    'reduce_tied': ('reduce', True, dict(inverse_method='cholesky')),
    'reduce_untied': ('reduce', False, dict(inverse_method='eigen',
                                            eigh_method='xla')),
}
TOL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(float(np.max(np.abs(ref))), 1e-30))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    return ids, targets


def _jax_model(tied):
    return jtl.TransformerLM(vocab_size=VOCAB, d_model=D,
                             num_layers=LAYERS, num_heads=HEADS,
                             max_len=MAX_LEN, dropout=0.0, tie_weights=tied)


def _torch_model(params, tied):
    model = transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
        max_len=MAX_LEN, dropout=0.0, tie_weights=tied)
    return convert.load_flax_params(model, params)


def _xent(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, targets[..., None], -1).mean()


# ---------------------------------------------------------------------------
# Model, attention, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('seed', [0, 1])
def test_forward_matches_jax(tied, seed):
    ids, _ = _batch(seed)
    variables = _jax_model(tied).init(jax.random.PRNGKey(seed),
                                      jnp.asarray(ids), train=False)
    ref = _jax_model(tied).apply(variables, jnp.asarray(ids), train=False)
    model = _torch_model(jax.tree.map(np.asarray, variables['params']),
                         tied).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert got.shape == (BATCH, SEQ, VOCAB)
    assert _rel(got.numpy(), ref) <= TOL
    assert hasattr(model, 'decoder') is not tied


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 8, 4, 8), (1, 5, 2, 3)])
def test_attention_matches_jax(causal, shape):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ref = jseq.local_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    got = sequence.local_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_attention_masks_with_a_finite_sentinel():
    # One query row, all keys masked (positions after it): JAX's -1e30
    # sentinel zeroes the row instead of producing NaN.
    q = torch.ones(1, 1, 1, 2)
    k = torch.ones(1, 1, 1, 2)
    pos = torch.tensor([0])
    m, o, l = sequence._block_attend(q, k, k, 1.0, pos, pos + 1, True)
    assert float(m) == float(torch.tensor(-1e30)) and float(l) == 0.0
    assert torch.equal(o, torch.zeros_like(o))


@pytest.mark.parametrize('tied', [True, False])
def test_conversion_round_trip(tied):
    torch.manual_seed(0)
    model = transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
        max_len=MAX_LEN, dropout=0.0, tie_weights=tied)
    sd = model.state_dict()
    params, stats = convert.torch_to_flax(sd, embeddings=('embed',))
    assert stats == {}
    assert set(params['block0']['ln1']) == {'scale', 'bias'}
    assert params['pos_embed'].shape == (MAX_LEN, D)
    back = convert.flax_to_torch(params)
    assert set(back) == set(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key
    # The JAX model runs on the converted parameters.
    ids, _ = _batch()
    ref = _jax_model(tied).apply({'params': params}, jnp.asarray(ids),
                                 train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long())
    assert _rel(got.numpy(), ref) <= TOL


def test_init_distributions_follow_flax():
    torch.manual_seed(0)
    model = transformer_lm.get_model(1000, 'tiny', dropout=0.0)
    w = model.block0.mlp_in.weight.detach()           # lecun normal
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.1 * (1 / 128) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 128) ** 0.5 / .8796 + 1e-6
    assert float(model.block0.mlp_in.bias.detach().abs().max()) == 0.0
    assert abs(float(model.embed.weight.std()) - 128 ** -0.5) < 0.01
    assert abs(float(model.pos_embed.std()) - 0.02) < 0.002
    assert model.ln_f.eps == 1e-6
    assert transformer_lm.SIZES['xl'] == dict(d_model=1024, num_layers=18,
                                              num_heads=16)
    with pytest.raises(ValueError, match='unknown size'):
        transformer_lm.get_model(10, 'huge')


# ---------------------------------------------------------------------------
# K-FAC over the model: three steps against the JAX KFAC
# ---------------------------------------------------------------------------

def _jax_run(name):
    approx, tied, knobs = CONFIGS[name]
    ids, targets = _batch()
    ids_j, targets_j = jnp.asarray(ids), jnp.asarray(targets)
    kfac = JKFAC(_jax_model(tied), kfac_approx=approx, skip_layers=[],
                 **HYPER, **knobs)
    variables, kstate = kfac.init(jax.random.PRNGKey(0), ids_j,
                                  train=False)
    params = variables['params']
    init = jax.tree.map(np.asarray, params)
    rec = []
    for step in range(STEPS):
        loss, _, grads, captures, _ = kfac.capture.loss_and_grads(
            lambda out: _xent(out, targets_j), params, ids_j, train=False)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True,
                                    inv_update=step % INV_FREQ == 0)
        _, stats = kfac.precondition(kstate, grads, kfac.damping, LR,
                                     with_stats=True)
        params = jax.tree.map(lambda p, g: p - LR * g, params, precond)
        rec.append({'loss': float(loss),
                    'factors': jax.tree.map(np.asarray, kstate['factors']),
                    'precond': jax.tree.map(np.asarray, precond),
                    'nu': float(stats['nu'])})
    return init, kfac.approx_summary(), rec


def _torch_run(name, init):
    approx, tied, knobs = CONFIGS[name]
    ids, targets = _batch()
    ids_t = torch.from_numpy(ids).long()
    targets_t = torch.from_numpy(targets).long()
    model = _torch_model(init, tied)
    kfac = KFAC(model, device='cpu', kfac_approx=approx, **HYPER, **knobs)
    state = kfac.init_state()
    rec = []
    for step in range(STEPS):
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: engine.lm_loss(out, targets_t), ids_t)
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True,
                                   inv_update=step % INV_FREQ == 0)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
        rec.append({'loss': float(loss), 'factors': state['factors'],
                    'precond': {n: t.clone() for n, t in precond.items()},
                    'nu': float(kfac.last_nu), 'captures': captures})
    return kfac, state, rec


@pytest.fixture(scope='module', params=list(CONFIGS))
def runs(request):
    init, summary, jrec = _jax_run(request.param)
    kernels.reset_launches()
    kfac, state, trec = _torch_run(request.param, init)
    return {'name': request.param, 'kfac': kfac, 'state': state,
            'jax': jrec, 'torch': trec, 'jax_summary': summary,
            'launches': dict(kernels.LAUNCHES)}


def test_losses(runs):
    np.testing.assert_allclose([r['loss'] for r in runs['torch']],
                               [r['loss'] for r in runs['jax']], rtol=1e-4)
    assert all(math.isfinite(r['loss']) for r in runs['torch'])


@pytest.mark.parametrize('step', range(STEPS))
def test_factors(runs, step):
    ref = convert.jax_factors_to_torch(runs['jax'][step]['factors'],
                                       runs['kfac'].specs)
    got = runs['torch'][step]['factors']
    assert set(ref) == set(got)
    for name, f in ref.items():
        for side in 'AG':
            assert _rel(got[name][side].numpy(), f[side].numpy()) <= TOL, (
                name, side, step)


@pytest.mark.parametrize('step', range(STEPS))
def test_preconditioned_grads_and_nu(runs, step):
    ref = convert.flax_to_torch(runs['jax'][step]['precond'])
    got = runs['torch'][step]['precond']
    assert set(ref) == set(got)
    for name, t in ref.items():
        assert _rel(got[name].numpy(), t.numpy()) <= 1e-4, (name, step)
    nu_ref = runs['jax'][step]['nu']
    assert abs(runs['torch'][step]['nu'] - nu_ref) <= 1e-4 * nu_ref


def test_resolved_approx_and_registration(runs):
    approx, tied, _ = CONFIGS[runs['name']]
    kfac = runs['kfac']
    want = {k.replace('/', '.'): v for k, v in runs['jax_summary'].items()}
    assert kfac.approx_summary() == want
    assert list(kfac.specs) == list(want)
    assert kfac.specs['embed'].kind == 'embedding'
    assert ('decoder' in kfac.specs) is not tied
    assert kfac.tied_embeddings == (approx == 'reduce')
    caps = runs['torch'][0]['captures']['embed']
    assert ('g_tied' in caps) == (tied and approx == 'reduce')


def test_embedding_state_layout(runs):
    state = runs['state']
    assert tuple(state['factors']['embed']['A'].shape) == (VOCAB,)
    assert tuple(state['factors']['embed']['G'].shape) == (D, D)
    inv = state['inverses']['embed']
    assert tuple(inv['A_inv'].shape) == (VOCAB,)
    baked = runs['kfac'].inverse_method == 'cholesky'
    assert set(inv) == ({'A_inv', 'G_inv'} if baked
                        else {'A_inv', 'QG', 'dG'})


def test_cpu_path_launches_no_kernel(runs):
    assert set(runs['launches'].values()) == {0}


def test_train_transformer_two_steps_on_cpu():
    cfg = {'arch': 'transformer', 'emsize': D, 'nlayers': LAYERS,
           'nheads': HEADS, 'synthetic_vocab': VOCAB,
           'synthetic_size': 2000, 'bptt': SEQ, 'batch_size': BATCH,
           'epochs': 1, 'max_steps': 2, 'kfac_update_freq': 1,
           'time_steps': True, 'quiet': True}
    res = cli.train(cfg, device='cpu')
    assert res['steps'] == 2 and res['fired'] == ['inverse', 'inverse']
    assert all(math.isfinite(v) for v in res['losses'])
    assert math.isfinite(res['val']['loss'])
    state = res['state']
    assert isinstance(state.model, transformer_lm.TransformerLM)
    # The transformer skips no layer: embedding and decoder registered.
    specs = state.kfac.specs
    assert specs['embed'].kind == 'embedding' and 'decoder' in specs
    assert len(specs) == 2 + 6 * LAYERS
    assert state.model.pos_embed.shape == (max(SEQ, 16), D)
    tied = cli.train({**cfg, 'tied': True, 'kfac_approx': 'reduce',
                      'max_steps': 1}, device='cpu')
    assert tied['state'].kfac.approx_summary()['embed'] == 'expand+tied'
    assert math.isfinite(tied['losses'][0])
