"""Every model family of the torch port at a compute ``dtype`` (fp16 and
bf16; ``modules.precision``) against the JAX model with the same
``dtype``, on the CPU, at small sizes with converted parameters.

For each family (CIFAR ResNet with BatchNorm, its GroupNorm variant,
ImageNet ResNet, MobileNetV1, ViT, the tied Transformer LM and the tied
LSTM LM) and each dtype, one K-FAC step of the JAX ``KFAC`` and of the
port's on the same batch (BatchNorms on their running statistics, no
dropout, the loss scaled by ``2**10`` under fp16 as ``--fp16`` scales it,
``cholesky`` inverses on both sides):

  - the forward pass: logits in the compute dtype, within 1e-2 (fp16) and
    3e-2 (bf16) of the largest JAX logit: the two frameworks round their
    half-precision products and sums in another order, layer after layer;
  - the capture dtypes, layer by layer, equal to JAX's: the stem's (and
    the patch embedding's) ``a`` is the fp32 input, every later ``a`` is
    in the compute dtype, every ``g`` fp32 (unscaled in fp32 under a loss
    scale; bf16 ``g`` as JAX's without one);
  - the parameters stay fp32, and so do their gradients;
  - the factors after the step within 1e-3 (fp16) / 1e-2 (bf16) of the
    largest entry of JAX's, and the preconditioned gradients within
    3e-2 / 8e-2 (MobileNet: 1.5e-1 / 4e-1): the captures and gradients
    carry each framework's half-precision rounding through the backward
    pass, and the damped inverses amplify it on the small factors of these
    nets. These limits bound the two frameworks' rounding, not the
    preconditioner (leaving the gradients unpreconditioned stays inside
    MobileNet's), so:
  - the port's preconditioned gradients within 1e-4 of the largest entry
    per tensor (the fp32 K-FAC tolerance of ``test_torch_kfac.py``) of
    the JAX ``KFAC``'s step on the port's own inputs: its factors,
    inverted by JAX, applied to its gradients. Measured at most 1.7e-5;
    an unpreconditioned gradient is 0.12 or more away, damping x10 0.39
    and damping /10 0.057.
  This file runs the ViT and the two LMs;
  ``test_torch_model_dtype_{resnet,imagenet,mobilenet}.py`` the rest.

The attention scores are fp32 at any input dtype, under the whole, the
chunked and the ring paths (a one-rank gloo group): fp16 queries and
keys whose dot products overflow fp16's range give the fp64 attention to
1e-5, and the same output as JAX's ``preferred_element_type`` product.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import cifar_resnet as jcifar
from distributed_kfac_pytorch_tpu.models import imagenet_resnet as jinet
from distributed_kfac_pytorch_tpu.models import lstm_lm as jlstm
from distributed_kfac_pytorch_tpu.models import mobilenet as jmob
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtlm
from distributed_kfac_pytorch_tpu.models import vit as jvit
from distributed_kfac_pytorch_tpu.parallel import sequence as jseq
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import (
    cifar_resnet,
    imagenet_resnet,
    lstm_lm,
    mobilenet,
    transformer_lm,
    vit,
)
from distributed_kfac_pytorch_tpu_torch.parallel import sequence
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC

DTYPES = {'fp16': (torch.float16, jnp.float16),
          'bf16': (torch.bfloat16, jnp.bfloat16)}
LOGIT_TOL = {'fp16': 1e-2, 'bf16': 3e-2}
FACTOR_TOL = {'fp16': 1e-3, 'bf16': 1e-2}
PRECOND_TOL = {'fp16': 3e-2, 'bf16': 8e-2}
# MobileNet's 13 depthwise blocks: half-precision depthwise backward
# passes that round in another order on each side (its fp32 gradients are
# held to float64 in test_torch_mobilenet; its preconditioner to
# SAME_INPUT_TOL below).
MOBILENET_PRECOND_TOL = {'fp16': 1.5e-1, 'bf16': 4e-1}
# The port's step against JAX's on the same factors and gradients: the
# fp32 K-FAC tolerance of test_torch_kfac.py (per tensor, of its largest
# entry); no half-precision rounding separates the two sides here.
SAME_INPUT_TOL = 1e-4
LOSS_SCALE = 2.0 ** 10
HYPER = dict(factor_update_freq=1, inv_update_freq=1, damping=0.03,
             lr=0.1, kl_clip=None, inverse_method='cholesky')
BATCH, CLASSES, VOCAB = 4, 5, 24


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Test files run in parallel processes next to JAX's virtual
    devices; one torch thread each keeps the machine from
    oversubscription."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).double().numpy())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _images(px):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, px, px, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=BATCH).astype(np.int32)
    return (jnp.asarray(x), torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2))), y)


def _tokens(t):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, size=(BATCH, t)).astype(np.int32)
    y = rng.integers(0, VOCAB, size=(BATCH, t)).astype(np.int32)
    return jnp.asarray(ids), torch.from_numpy(ids).long(), y


#: family -> (JAX model of a dtype, port model of a dtype, batch).
FAMILIES = {
    'cifar_resnet': (
        lambda d: jcifar.CifarResNet((1, 1, 1), CLASSES, dtype=d),
        lambda d: cifar_resnet.CifarResNet((1, 1, 1), CLASSES, dtype=d),
        lambda: _images(8)),
    'cifar_resnet_gn': (
        lambda d: jcifar.CifarResNet((1, 1, 1), CLASSES, dtype=d,
                                     norm='group'),
        lambda d: cifar_resnet.CifarResNet((1, 1, 1), CLASSES,
                                           norm='group', dtype=d),
        lambda: _images(8)),
    'imagenet_resnet': (
        lambda d: jinet.ImageNetResNet((1, 1, 1, 1), num_classes=CLASSES,
                                       width=4, dtype=d),
        lambda d: imagenet_resnet.ImageNetResNet(
            (1, 1, 1, 1), num_classes=CLASSES, width=4, dtype=d),
        lambda: _images(32)),
    'mobilenet': (
        lambda d: jmob.get_model(CLASSES, 0.125, dtype=d),
        lambda d: mobilenet.get_model(CLASSES, 0.125, dtype=d),
        lambda: _images(32)),
    'vit': (
        lambda d: jvit.VisionTransformer(CLASSES, patch_size=4, d_model=16,
                                         num_layers=1, num_heads=2,
                                         dtype=d),
        lambda d: vit.VisionTransformer(CLASSES, image_size=8,
                                        patch_size=4, d_model=16,
                                        num_layers=1, num_heads=2,
                                        dtype=d),
        lambda: _images(8)),
    'transformer_lm': (
        lambda d: jtlm.TransformerLM(VOCAB, d_model=16, num_layers=1,
                                     num_heads=2, max_len=8, dropout=0.0,
                                     tie_weights=True, dtype=d),
        lambda d: transformer_lm.TransformerLM(
            VOCAB, d_model=16, num_layers=1, num_heads=2, max_len=8,
            dropout=0.0, tie_weights=True, dtype=d),
        lambda: _tokens(6)),
    'lstm_lm': (
        lambda d: jlstm.LSTMLanguageModel(VOCAB, 8, 8, num_layers=1,
                                          dropout=0.0, tie_weights=True,
                                          dtype=d),
        lambda d: lstm_lm.LSTMLanguageModel(VOCAB, 8, 8, num_layers=1,
                                            dropout=0.0, tie_weights=True,
                                            dtype=d),
        lambda: _tokens(3)),
}
#: This file's cases; the CIFAR, ImageNet and MobileNet families run in
#: test_torch_model_dtype_{resnet,imagenet,mobilenet}.py (each file stays
#: well inside a minute).
CASES = [(f, d) for f in ('vit', 'transformer_lm', 'lstm_lm')
         for d in DTYPES]


def _logits(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@functools.lru_cache(maxsize=None)
def _jax_variables(family):
    """The JAX model's variables (jitted init, once per family: flax keeps
    parameters fp32 at every compute dtype, so both dtypes share them)."""
    jmodel = FAMILIES[family][0](jnp.float32)
    jx = FAMILIES[family][2]()[0]
    return jax.jit(lambda k, v: jmodel.init(k, v, train=False))(
        jax.random.PRNGKey(0), jx)


def _jax_run(family, dname):
    jmodel = FAMILIES[family][0](DTYPES[dname][1])
    jx, _, y = FAMILIES[family][2]()
    kfac = JKFAC(jmodel, **HYPER)
    # Layer registration is a side effect of tracing the init.
    jax.eval_shape(lambda k, v: kfac.init(k, v, train=False),
                   jax.random.PRNGKey(0), jx)
    variables = _jax_variables(family)
    params = variables['params']
    kstate = kfac.init_state(params)
    extra = ({'batch_stats': variables['batch_stats']}
             if 'batch_stats' in variables else {})
    scale = (jnp.asarray(LOSS_SCALE, jnp.float32) if dname == 'fp16'
             else None)

    def step(params, kstate, x, y):
        def loss_fn(out):
            logits = _logits(out)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), logits

        loss, logits, grads, captures, _ = kfac.capture.loss_and_grads(
            loss_fn, params, x, train=False, extra_vars=extra,
            loss_scale=scale, has_aux=True)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True, inv_update=True)
        # Empty arrays carry each capture's dtype out of the jitted step.
        dtypes = {name: {k: jnp.zeros((0,), v[0].dtype)
                         for k, v in c.items()}
                  for name, c in captures.items()}
        return loss, logits, precond, kstate['factors'], dtypes

    loss, logits, precond, factors, dtypes = jax.jit(step)(
        params, kstate, jx, jnp.asarray(y))
    return {'kfac': kfac, 'kstate': kstate,
            'params': jax.tree.map(np.asarray, params),
            'stats': jax.tree.map(np.asarray, extra.get('batch_stats')),
            'loss': float(loss), 'logits': np.asarray(logits, np.float32),
            'logits_dtype': logits.dtype,
            'factors': jax.tree.map(np.asarray, factors),
            'precond': jax.tree.map(np.asarray, precond),
            'dtypes': {name.replace('/', '.'): {k: np.dtype(v.dtype)
                                                for k, v in e.items()}
                       for name, e in dtypes.items()}}


@functools.lru_cache(maxsize=None)
def _runs(family, dname):
    jrec = _jax_run(family, dname)
    tdtype = DTYPES[dname][0]
    model = FAMILIES[family][1](tdtype)
    model.load_state_dict(convert.flax_to_torch(jrec['params'],
                                                jrec['stats']))
    model.eval()
    _, tx, y = FAMILIES[family][2]()
    kfac = KFAC(model, device='cpu', **HYPER)
    yt = torch.from_numpy(y).long()
    loss, out, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(
            _logits(out).reshape(-1, _logits(out).shape[-1]),
            yt.reshape(-1)), tx,
        loss_scale=torch.tensor(LOSS_SCALE) if dname == 'fp16' else None)
    dtypes = {name: {k: v[0].dtype for k, v in c.items()}
              for name, c in captures.items()}
    precond, state = kfac.step(kfac.init_state(), grads, captures,
                               factor_update=True, inv_update=True)
    return jrec, {'model': model, 'kfac': kfac, 'loss': float(loss),
                  'logits': _logits(out), 'grads': grads,
                  'dtypes': dtypes, 'factors': state['factors'],
                  'precond': precond}


def _jax_precondition(jrec, trec):
    """JAX's K-FAC step on the port's own inputs: the port's factors (fp32,
    from its half-precision captures) inverted and applied to the port's
    gradients by the JAX ``KFAC``, as the port's step does with them."""
    kfac, model = jrec['kfac'], trec['model']
    factors = convert.torch_factors_to_jax(trec['factors'],
                                           trec['kfac'].specs)
    state = {**jrec['kstate'], 'factors': jax.tree.map(jnp.asarray,
                                                       factors)}
    embeddings = tuple(n for n, m in model.named_modules()
                       if isinstance(m, torch.nn.Embedding))
    grads, _ = convert.torch_to_flax(trec['grads'], embeddings=embeddings)
    precond, _ = jax.jit(lambda st, g: kfac.step(
        st, g, {}, factor_update=False, inv_update=True))(
        state, jax.tree.map(jnp.asarray, grads))
    return convert.flax_to_torch(jax.tree.map(np.asarray, precond))


def check_forward(family, dname):
    jrec, trec = _runs(family, dname)
    assert trec['logits'].dtype == DTYPES[dname][0]
    assert jrec['logits_dtype'] == DTYPES[dname][1]
    assert _rel(trec['logits'], jrec['logits']) <= LOGIT_TOL[dname]
    assert abs(trec['loss'] - jrec['loss']) <= LOGIT_TOL[dname] * abs(
        jrec['loss'])


def check_capture_dtypes(family, dname):
    jrec, trec = _runs(family, dname)
    tdtype = DTYPES[dname][0]
    assert set(trec['dtypes']) == set(jrec['dtypes'])
    stems = 0
    for name, keys in trec['dtypes'].items():
        want = jrec['dtypes'][name]
        assert set(keys) == set(want), name
        for key, got in keys.items():
            if not got.is_floating_point:
                continue
            assert str(got).replace('torch.', '') == str(want[key]), (
                name, key, got, want[key])
            if key in ('g', 'g_tied'):
                assert got == (torch.float32 if dname == 'fp16'
                               else tdtype), (name, key)
        stems += keys['a'] == torch.float32
    # Only the layer that reads the image takes an fp32 ``a``.
    image_net = family not in ('transformer_lm', 'lstm_lm')
    assert stems == (1 if image_net else 0)
    assert all(p.dtype == torch.float32
               for p in trec['model'].parameters())
    assert all(g.dtype == torch.float32 for g in trec['grads'].values())


def check_kfac_step(family, dname):
    jrec, trec = _runs(family, dname)
    kfac = trec['kfac']
    want = convert.jax_factors_to_torch(jrec['factors'], kfac.specs)
    for name, f in want.items():
        for side in 'AG':
            got = trec['factors'][name][side]
            assert got.dtype == torch.float32
            assert _rel(got, f[side].numpy()) <= FACTOR_TOL[dname], (
                name, side)
    tol = (MOBILENET_PRECOND_TOL if family == 'mobilenet'
           else PRECOND_TOL)[dname]
    want = convert.flax_to_torch(jrec['precond'])
    for name, t in want.items():
        assert torch.isfinite(trec['precond'][name]).all()
        assert _rel(trec['precond'][name], t.numpy()) <= tol, name
    same = _jax_precondition(jrec, trec)
    assert same.keys() == trec['precond'].keys()
    for name, t in same.items():
        assert _rel(trec['precond'][name], t.numpy()) <= SAME_INPUT_TOL, (
            name)


@pytest.mark.parametrize('family,dname', CASES)
def test_forward_and_loss_match_jax(family, dname):
    check_forward(family, dname)


@pytest.mark.parametrize('family,dname', CASES)
def test_capture_dtypes_match_jax(family, dname):
    check_capture_dtypes(family, dname)


@pytest.mark.parametrize('family,dname', CASES)
def test_kfac_step_matches_jax(family, dname):
    check_kfac_step(family, dname)


# ---------------------------------------------------------------------------
# Attention scores in fp32
# ---------------------------------------------------------------------------

def _attention_inputs(dtype):
    """fp16-range-overflowing queries and keys: |q . k| ~ 1e5."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
               for _ in range(3))
    q, k = q * 200.0, k * 200.0
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    return tq, tk, tv


def _fp64_attention(q, k, v, causal):
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) / q.shape[-1] ** 0.5
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          float('-inf'))
    return torch.einsum('bhqk,bkhd->bqhd', s.softmax(-1), v)


@pytest.mark.parametrize('dname', list(DTYPES))
@pytest.mark.parametrize('causal', [True, False])
def test_attention_scores_are_fp32(dname, causal, tmp_path):
    tdtype, jdtype = DTYPES[dname]
    q, k, v = _attention_inputs(tdtype)
    assert not torch.isfinite(torch.einsum(
        'bqhd,bkhd->bhqk', q.half(), k.half())).all()
    want = _fp64_attention(q, k, v, causal)
    jq, jk_, jv = (jnp.asarray(t.float().numpy()).astype(jdtype)
                   for t in (q, k, v))
    jout = np.asarray(jseq.local_causal_attention(jq, jk_, jv,
                                                  causal=causal))
    outs = {'whole': sequence.local_causal_attention(q, k, v,
                                                     causal=causal),
            'chunked': sequence.chunked_causal_attention(
                q, k, v, block_size=3, causal=causal)}
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/pg',
                            rank=0, world_size=1)
    try:
        outs['ring'] = sequence.ring_self_attention(
            q, k, v, group=dist.group.WORLD, causal=causal)
    finally:
        dist.destroy_process_group()
    for path, out in outs.items():
        assert out.dtype == torch.float32, path
        assert torch.isfinite(out).all(), path
        assert _rel(out, want.numpy()) <= 1e-5, path
        assert _rel(out, jout) <= 1e-5, path
