"""Embedding K-FAC in the torch port against the JAX package: the diagonal
A factor of a lookup, the tied attend site's vocabulary diagonal and its
extras, the elementwise inverse, the diagonal-A preconditioning (baked and
eigen G), the embedding's gradient matrix, and the capture of a lookup and
of a tied attend call on the Transformer LM (2 blocks, d 32, vocabulary 64,
sequence 8, batch 2) with weights carried over from JAX.

Inputs come from a numpy seed; the port runs on CPU tensors. Tolerances,
relative to the largest reference entry: factors, extras and inverses
1e-6 (the same fp32 sums), preconditioning and captured gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu import layers as JL
from distributed_kfac_pytorch_tpu.capture import LayerSpec as JSpec
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
from distributed_kfac_pytorch_tpu.ops import factors as JF
from distributed_kfac_pytorch_tpu.ops import linalg as JLA
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import EMBEDDING, \
    KFACCapture, LayerSpec
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.modules.embed import Embed
from distributed_kfac_pytorch_tpu_torch.ops import factors as F
from distributed_kfac_pytorch_tpu_torch.ops import linalg
from distributed_kfac_pytorch_tpu_torch.training import engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


VOCAB, D, SEQ, BATCH = 64, 32, 8, 2


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(float(np.max(np.abs(ref))), 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('shape', [(BATCH, SEQ), (5,), (3, 4, 2)])
def test_embedding_a_factor(shape):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, size=shape).astype(np.int32)   # repeats
    ref = JF.embedding_a_factor(jnp.asarray(ids), VOCAB)
    got = F.embedding_a_factor(_t(ids).long(), VOCAB)
    assert got.dtype == torch.float32 and got.shape == (VOCAB,)
    assert _rel(got.numpy(), ref) <= 1e-6
    assert abs(float(got.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize('shape', [(BATCH, SEQ, VOCAB), (6, VOCAB)])
def test_embedding_tied_a_diag(shape):
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = JF.embedding_tied_a_diag(jnp.asarray(g))
    assert _rel(F.embedding_tied_a_diag(_t(g)).numpy(), ref) <= 1e-6


def test_tied_factor_extras():
    rng = np.random.default_rng(2)
    entry_np = {
        'a': (rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32),),
        'g': (rng.normal(size=(BATCH, SEQ, D)).astype(np.float32),),
        'a_tied': (rng.normal(size=(BATCH, SEQ, D)).astype(np.float32),),
        'g_tied': (rng.normal(size=(BATCH, SEQ, VOCAB)).astype(
            np.float32),)}
    jspec = JSpec(path=('embed',), kind='embedding', has_bias=False,
                  vocab_size=VOCAB, tied_calls=1)
    spec = LayerSpec(path=('embed',), kind=EMBEDDING, has_bias=False,
                     vocab_size=VOCAB, tied_calls=1)
    ref = JL.compute_tied_factor_extras(
        jspec, {k: tuple(jnp.asarray(x) for x in v)
                for k, v in entry_np.items()})
    entry = {k: tuple(_t(x) for x in v) for k, v in entry_np.items()}
    entry['a'] = tuple(x.long() for x in entry['a'])
    got = L.compute_tied_factor_extras(spec, entry)
    assert set(got) == {'A_g2', 'G_a'} == set(ref)
    for key in got:
        assert _rel(got[key].numpy(), ref[key]) <= 1e-6, key
    for fn, jfn, calls in ((L.compute_a_factor, JL.compute_a_factor, 'a'),
                           (L.compute_g_factor, JL.compute_g_factor, 'g')):
        assert _rel(fn(spec, entry[calls]).numpy(), jfn(
            jspec, tuple(jnp.asarray(x) for x in entry_np[calls]))) <= 1e-6
    untied = {'a': entry['a'], 'g': entry['g']}
    assert L.compute_tied_factor_extras(spec, untied) is None
    assert L.GRAD_QUADRATIC_KEYS == JL.GRAD_QUADRATIC_KEYS


@pytest.mark.parametrize('damping', [None, 0.0, 0.003])
def test_elementwise_inverse(damping):
    v = np.random.default_rng(3).uniform(0.0, 2.0, size=50).astype(
        np.float32)
    v[[0, 7, 30]] = 0.0
    ref = JLA.get_elementwise_inverse(jnp.asarray(v), damping)
    got = linalg.get_elementwise_inverse(_t(v), damping)
    assert _rel(got.numpy(), ref) <= 1e-6
    if not damping:
        assert float(got[0]) == 0.0


def _spd(rng, n):
    m = rng.normal(size=(n, n)).astype(np.float32)
    return (m @ m.T / n + 0.1 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize('form', ['baked', 'eigen'])
def test_diag_a_preconditioning(form):
    rng = np.random.default_rng(4)
    grad = rng.normal(size=(VOCAB, D)).astype(np.float32)
    diag = rng.uniform(0.5, 2.0, size=VOCAB).astype(np.float32)
    g = _spd(rng, D)
    if form == 'baked':
        entry_np = {'G_inv': np.linalg.inv(g).astype(np.float32)}
    else:
        d, q = np.linalg.eigh(g)
        entry_np = {'QG': q.astype(np.float32),
                    'dG': d.astype(np.float32)}
    ref = JLA.precondition_dispatch(
        jnp.asarray(grad), {k: jnp.asarray(v) for k, v in entry_np.items()},
        0.003, diag_a=jnp.asarray(diag))
    got = linalg.precondition_dispatch(
        _t(grad), {k: _t(v) for k, v in entry_np.items()}, 0.003,
        diag_a=_t(diag))
    assert _rel(got.numpy(), ref) <= 1e-5
    if form == 'baked':
        direct = linalg.precondition_diag_a(_t(grad), _t(diag),
                                            _t(entry_np['G_inv']))
        assert torch.equal(direct, got)


def test_embedding_matrix_form():
    spec = LayerSpec(path=('embed',), kind=EMBEDDING, has_bias=False,
                     vocab_size=VOCAB)
    w = torch.randn(VOCAB, D)
    assert L.factor_shapes(spec, {'weight': w}) == (VOCAB, D)
    mat = L.grads_to_matrix(spec, {'weight': w})
    assert mat.shape == (VOCAB, D)
    back = L.matrix_to_grads(spec, 2 * mat, {'weight': w})
    assert torch.equal(back['weight'], 2 * w)


def test_embed_module_and_declines():
    torch.manual_seed(0)
    emb = Embed(1000, 16)
    assert abs(float(emb.weight.detach().std()) - 0.25) < 0.02
    x = torch.randn(3, 16)
    assert torch.equal(emb.attend(x), x @ emb.weight.T)
    model = torch.nn.ModuleDict({
        'plain': torch.nn.Embedding(10, 4),
        'padded': torch.nn.Embedding(10, 4, padding_idx=0),
        'sparse': torch.nn.Embedding(10, 4, sparse=True),
        'embed': Embed(10, 4)})
    cap = KFACCapture(model)
    assert set(cap.specs) == {'plain', 'embed'}
    assert 'padding_idx' in cap.skipped_modules['padded']
    assert 'sparse' in cap.skipped_modules['sparse']
    # The attend wrapper exists only while a tied capture is open.
    tied = KFACCapture(model, tied_embeddings=True)
    assert 'attend' in vars(model['embed'])
    tied.close()
    assert 'attend' not in vars(model['embed'])


@pytest.mark.parametrize('tied', [True, False])
def test_capture_of_lookup_and_tied_attend(tied):
    """The port's captures of the Transformer LM's embedding (ids and the
    lookup's output gradient; with tied embeddings on, the attend input
    and the logits' gradient) equal the JAX capture's."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    jmodel = jtl.TransformerLM(vocab_size=VOCAB, d_model=D, num_layers=1,
                               num_heads=4, max_len=16, dropout=0.0,
                               tie_weights=tied)
    jkfac = JKFAC(jmodel, skip_layers=[], tied_embeddings=True)
    variables, _ = jkfac.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                              train=False)

    def xent(logits):
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                    -1).mean()

    _, _, jgrads, jcaps, _ = jkfac.capture.loss_and_grads(
        xent, variables['params'], jnp.asarray(ids), train=False)
    model = transformer_lm.TransformerLM(VOCAB, d_model=D, num_layers=1,
                                         num_heads=4, max_len=16,
                                         dropout=0.0, tie_weights=tied)
    convert.load_flax_params(model,
                             jax.tree.map(np.asarray, variables['params']))
    cap = KFACCapture(model, tied_embeddings=True)
    t = torch.from_numpy(targets).long()
    _, _, grads, caps = cap.loss_and_grads(lambda out: engine.lm_loss(
        out, t), torch.from_numpy(ids).long())
    got, ref = caps['embed'], jcaps['embed']
    assert set(got) == set(ref) == (
        {'a', 'g', 'a_tied', 'g_tied'} if tied else {'a', 'g'})
    for key in got:
        assert len(got[key]) == len(ref[key]) == 1, key
        tol = 0 if key == 'a' else 1e-5
        assert _rel(got[key][0].numpy(), ref[key][0]) <= tol, key
    # The shared weight's gradient is the sum over both uses.
    jw = convert.flax_to_torch(jax.tree.map(np.asarray, jgrads))
    assert _rel(grads['embed.weight'].numpy(),
                jw['embed.weight'].numpy()) <= 1e-5
    observed = cap.observed_specs(cap.specs)
    assert observed['embed'].tied_calls == int(tied)
    assert observed['block0.attn.q_proj'].shared_positions == SEQ
