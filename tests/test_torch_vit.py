"""The Vision Transformer in the torch port (``models/vit.py``) against the
JAX package's (``distributed_kfac_pytorch_tpu/models/vit.py``), mirroring
the JAX suite's ``tests/test_vit.py``:

  - ViT-S/16 at 224 px and 1000 classes has 22.05 M parameters;
  - at ``cifar`` size, 38 registered layers (the patch-embed conv, 6
    Linears per block, the head), only LayerNorms and the root (its
    ``cls_token`` and ``pos_embed``) declined;
  - attention is bidirectional (the logits on the cls token depend on
    the patches);
  - both pools, ``cls`` and ``mean``, against JAX on converted weights;
  - the chunked fold (``attn_block_size``, ragged with the cls token)
    against monolithic attention;
  - at ``cifar`` size, batch 4, 32 px, weights converted from the JAX
    model: two K-FAC + SGD steps (factors and inverses every step, exact
    eigh) under ``expand`` and under ``reduce``, where the patch-embed
    conv takes the reduce factors, against the JAX ``KFAC``;
  - the ImageNet CLI at ``--model vit_cifar --image-size 32``, two steps
    on the CPU.

Tolerances, relative to the largest reference entry of each tensor:
logits 1e-5, chunked fold 2e-5 (the fold reorders the softmax sums, the
JAX suite's tolerance), losses 1e-5, factors 1e-5, preconditioned
gradients 1e-4 (they carry the KL-clip scale).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import vit as jvit
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as cli
from distributed_kfac_pytorch_tpu_torch.models import vit
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Test files run in parallel processes next to JAX's virtual
    devices; one torch thread each keeps the machine from
    oversubscription."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


BATCH, PX, CLASSES, LR, STEPS = 4, 32, 10, 0.1, 2
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=1, inverse_method='auto', eigh_method='xla')
SMALL = dict(num_classes=5, patch_size=8, d_model=32, num_layers=2,
             num_heads=2)


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _batch(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, PX, PX, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=n).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_params(model, x):
    init = jax.jit(lambda key, v: model.init(key, v, train=False))
    return jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(0), jnp.asarray(x)))['params']


def test_vit_s16_param_count():
    with torch.device('meta'):
        model = vit.get_model(1000, 'small')
    count = sum(p.numel() for p in model.parameters())
    assert abs(count / 1e6 - 22.05) < 0.05, count
    assert tuple(model.pos_embed.shape) == (197, 384)
    assert vit.SIZES['base'] == dict(patch_size=16, d_model=768,
                                     num_layers=12, num_heads=12)
    with pytest.raises(ValueError, match='unknown size'):
        vit.get_model(10, 'huge')


def test_vit_registration():
    kfac = KFAC(vit.get_model(CLASSES, 'cifar', image_size=PX),
                device='cpu')
    kinds = [s.kind for s in kfac.specs.values()]
    assert kinds.count('conv2d') == 1 and kinds.count('linear') == 37
    assert len(kinds) == 38
    assert list(kfac.specs)[0] == 'patch_embed'
    assert all('ln' in name or name == ''
               for name in kfac.capture.skipped_modules)


def test_vit_attention_is_bidirectional():
    torch.manual_seed(0)
    model = vit.VisionTransformer(**SMALL, image_size=PX).eval()
    x1, _ = _batch(1, 2)
    x2, _ = _batch(2, 2)
    with torch.no_grad():
        o1, o2 = model(_nchw(x1)), model(_nchw(x2))
    assert not torch.allclose(o1, o2)
    assert all(not blk.attn.causal for blk in
               (model.block0, model.block1))


@pytest.mark.parametrize('pool', ['cls', 'mean'])
def test_vit_pools_match_jax(pool):
    x, _ = _batch(1, 2)
    jmodel = jvit.VisionTransformer(**SMALL, pool=pool)
    params = _jax_params(jmodel, x)
    ref = jax.jit(lambda p, v: jmodel.apply({'params': p}, v,
                                            train=False))(
        params, jnp.asarray(x))
    model = vit.VisionTransformer(**SMALL, pool=pool, image_size=PX)
    model.load_state_dict(convert.flax_to_torch(params))
    assert hasattr(model, 'cls_token') is (pool == 'cls')
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    assert got.shape == (2, 5) and bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= 1e-5
    back, stats = convert.torch_to_flax(model.state_dict())
    assert stats == {}
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize('pool', ['cls', 'mean'])
def test_vit_chunked_attention_matches_monolithic(pool):
    """17 tokens with the cls token (ragged: the fold's masked padding),
    16 with mean pooling."""
    torch.manual_seed(0)
    mono = vit.VisionTransformer(**SMALL, pool=pool, image_size=PX)
    chunked = vit.VisionTransformer(**SMALL, pool=pool, image_size=PX,
                                    attn_block_size=4)
    chunked.load_state_dict(mono.state_dict())
    x, _ = _batch(1, 2)
    with torch.no_grad():
        want = mono.eval()(_nchw(x))
        got = chunked.eval()(_nchw(x))
    assert _rel(got, want.numpy()) <= 2e-5


def test_vit_rejects_other_inputs_and_options():
    model = vit.VisionTransformer(**SMALL, image_size=PX)
    with pytest.raises(ValueError, match='32 px'):
        model(torch.zeros(1, 3, 64, 64))
    with pytest.raises(ValueError, match='pool'):
        vit.VisionTransformer(**SMALL, pool='max')
    with pytest.raises(ValueError, match='divisible'):
        vit.VisionTransformer(**SMALL, image_size=30)
    with pytest.raises(NotImplementedError, match='dtype'):
        vit.VisionTransformer(**SMALL, dtype=torch.float64)


# ---------------------------------------------------------------------------
# K-FAC steps against the JAX KFAC, expand and reduce
# ---------------------------------------------------------------------------

def _jax_run(approx):
    x0, _ = _batch()
    jmodel = jvit.get_model(CLASSES, 'cifar')
    kfac = JKFAC(jmodel, kfac_approx=approx, **HYPER)
    # Jitted: registration runs once, while the init is traced.
    variables, kstate = jax.jit(
        lambda k, v: kfac.init(k, v, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x0))
    params = variables['params']
    init = jax.tree.map(np.asarray, params)

    def step_fn(params, kstate, x, y):
        loss, _, grads, captures, _ = kfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(), params, x, train=False)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True, inv_update=True)
        params = jax.tree.map(lambda p, g: p - LR * g, params, precond)
        return loss, precond, params, kstate

    jstep = jax.jit(step_fn)
    recs = []
    for step in range(STEPS):
        x, y = _batch(step)
        loss, precond, params, kstate = jstep(
            params, kstate, jnp.asarray(x), jnp.asarray(y))
        recs.append({'loss': float(loss),
                     'factors': jax.tree.map(np.asarray, kstate['factors']),
                     'precond': jax.tree.map(np.asarray, precond)})
    return init, kfac.approx_summary(), recs


@pytest.fixture(scope='module', params=['expand', 'reduce'])
def runs(request):
    approx = request.param
    init, summary, jrecs = _jax_run(approx)
    model = vit.get_model(CLASSES, 'cifar', image_size=PX)
    model.load_state_dict(convert.flax_to_torch(init))
    kfac = KFAC(model, device='cpu', kfac_approx=approx, **HYPER)
    state = kfac.init_state()
    kernels.reset_launches()
    trecs = []
    for step in range(STEPS):
        x, y = _batch(step)
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, torch.from_numpy(y).long()),
            _nchw(x))
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True, inv_update=True)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
        trecs.append({'loss': float(loss),
                      'factors': state['factors'],
                      'precond': {n: t.clone() for n, t in precond.items()}})
    return {'approx': approx, 'kfac': kfac, 'jax': jrecs, 'torch': trecs,
            'jax_summary': summary, 'launches': dict(kernels.LAUNCHES)}


def test_kfac_losses_match_jax(runs):
    for jr, tr in zip(runs['jax'], runs['torch']):
        assert abs(tr['loss'] - jr['loss']) <= 1e-5 * abs(jr['loss'])
        assert math.isfinite(tr['loss'])


@pytest.mark.parametrize('step', range(STEPS))
def test_kfac_factors_match_jax(runs, step):
    want = convert.jax_factors_to_torch(runs['jax'][step]['factors'],
                                        runs['kfac'].specs)
    got = runs['torch'][step]['factors']
    assert set(want) == set(got)
    for name, f in want.items():
        for side in 'AG':
            assert _rel(got[name][side], f[side].numpy()) <= 1e-5, (
                name, side)


@pytest.mark.parametrize('step', range(STEPS))
def test_kfac_preconditioned_grads_match_jax(runs, step):
    want = convert.flax_to_torch(runs['jax'][step]['precond'])
    got = runs['torch'][step]['precond']
    assert set(want) == set(got)
    for name, t in want.items():
        assert _rel(got[name], t.numpy()) <= 1e-4, name


def test_resolved_approx_matches_jax(runs):
    kfac = runs['kfac']
    want = {k.replace('/', '.'): v for k, v in runs['jax_summary'].items()}
    assert kfac.approx_summary() == want
    summary = kfac.approx_summary()
    if runs['approx'] == 'reduce':
        # The patch conv and every block Linear reduce; the head's input
        # is 2-D.
        assert summary['patch_embed'] == 'reduce'
        assert summary['block0.mlp_in'] == 'reduce'
        assert summary['head'] == 'expand'
    else:
        assert set(summary.values()) == {'expand'}
    assert set(runs['launches'].values()) == {0}


def test_cli_trains_vit_cifar_on_cpu():
    res = cli.train({'model': 'vit_cifar', 'image_size': PX,
                     'batch_size': 4, 'val_batch_size': 4,
                     'synthetic_size': 8, 'epochs': 1, 'max_steps': 2,
                     'kfac_update_freq': 2, 'kfac_cov_update_freq': 1,
                     'quiet': True}, device='cpu')
    assert res['steps'] == 2 and res['fired'] == ['inverse', 'factor']
    assert all(math.isfinite(v) for v in res['losses'])
    state = res['state']
    assert isinstance(state.model, vit.VisionTransformer)
    assert state.model.patch_embed.kernel_size == (4, 4)
    assert len(state.kfac.specs) == 38
