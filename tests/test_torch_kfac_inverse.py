"""The damped-inverse slice of the torch port against the JAX package:
the narrow bottleneck ImageNet ResNet (stages 1,1,1,1, width 8, 10
classes), the same converted weights and numpy batches (8 images at
32 px), three steps of K-FAC + SGD (momentum 0.9, weight decay 5e-5) with
factors every step and inverses every 2nd, under

  - ``inverse_method='newton'`` (every factor through the Newton--Schulz
    iteration: the port's K4 plain version, the JAX vmapped XLA loop);
  - ``'cholesky'`` (every factor through the damped Cholesky inverse);
  - ``'auto'`` with ``auto_eigen_max_dim=40``: eigen sides up to dim 40,
    Cholesky above, so most layers are mixed (their eigen side baked at
    the firing's damping) and several buckets are Cholesky stacks.

The eigen sides use the exact eigh (``eigh_method='xla'``) so that the
baked eigen-side inverses are compared at the fixed tolerances. The JAX
side runs its stock XLA path (jitted), the port its kernels' plain
versions (CPU tensors). Tolerances:

  - losses: rel 1e-4;
  - each step's factor contribution on its own scale: <= 1e-4 of its
    largest entry at step 1 (the head's A reads the pooled activations,
    whose flax fp32 forward is itself ~1e-5 to 2.5e-5 from float64 at
    these sizes, ``test_torch_imagenet.py``; measured ~1.1e-5), <= 1e-3
    later, when the parameters carry the two sides' update differences,
    which train-mode BatchNorm over 8 values per channel in the last
    stage amplifies (measured 1.6e-4);
  - ``A_inv`` / ``G_inv``: rtol 1e-4 with atol 1e-5 of the matrix's
    largest entry (its near-zero entries carry the factors' differences
    above; measured 2.4e-6);
  - preconditioned grads and updated params: rtol 5e-3 / atol 5e-5, the
    JAX package's own fused-vs-stock tolerance for preconditioned
    updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import imagenet_resnet as jres
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


BATCH, STEPS, INV_FREQ, LR, WD = 8, 3, 2, 0.1, 5e-5
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=INV_FREQ, eigh_method='xla')
METHODS = {'newton': dict(inverse_method='newton'),
           'cholesky': dict(inverse_method='cholesky'),
           'auto40': dict(inverse_method='auto', auto_eigen_max_dim=40)}


def _model_kwargs():
    return dict(bottleneck=True, num_classes=10, width=8)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(BATCH, 32, 32, 3)).astype('float32'),
             rng.integers(0, 10, size=BATCH)) for _ in range(STEPS)]


def _jax_run(batches, knobs):
    model = jres.ImageNetResNet(stage_sizes=(1, 1, 1, 1), **_model_kwargs())
    kfac = JKFAC(model, **HYPER, **knobs)
    variables, kstate = kfac.init(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0][0]))
    params = variables['params']
    extra = {'batch_stats': variables['batch_stats']}
    tx = optax.chain(optax.add_decayed_weights(WD), optax.trace(0.9),
                     optax.scale(-LR))
    opt_state = tx.init(params)
    init = jax.tree.map(np.asarray, variables)

    def step_fn(params, opt_state, kstate, extra, x, y, inv_update):
        loss, _, grads, captures, upd = kfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(),
            params, x, extra_vars=extra, mutable_cols=('batch_stats',))
        contrib = kfac.update_factors(kstate, captures, factor_decay=0.0)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True,
                                    inv_update=inv_update)
        updates, opt_state = tx.update(precond, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (loss, precond, params, opt_state, kstate, {**extra, **upd},
                contrib)

    jstep = jax.jit(step_fn, static_argnames=('inv_update',))
    rec = []
    for step, (x, y) in enumerate(batches):
        loss, precond, params, opt_state, kstate, extra, contrib = jstep(
            params, opt_state, kstate, extra, jnp.asarray(x),
            jnp.asarray(y), inv_update=step % INV_FREQ == 0)
        rec.append({'loss': float(loss),
                    'contrib': jax.tree.map(np.asarray, contrib),
                    'inverses': jax.tree.map(np.asarray,
                                             kstate['inverses']),
                    'precond': jax.tree.map(np.asarray, precond),
                    'params': jax.tree.map(np.asarray, params)})
    return init, rec


def _torch_run(init, batches, knobs):
    model = imagenet_resnet.ImageNetResNet((1, 1, 1, 1), **_model_kwargs())
    model.load_state_dict(convert.flax_to_torch(init['params'],
                                                init['batch_stats']))
    kfac = KFAC(model, device='cpu', **HYPER, **knobs)
    state = kfac.init_state()
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          weight_decay=WD)
    rec = []
    for step, (x, y) in enumerate(batches):
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        yt = torch.from_numpy(y)
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, yt), xt)
        contrib = kfac.update_factors(state, captures, factor_decay=0.0)
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True,
                                   inv_update=step % INV_FREQ == 0)
        for name, p in model.named_parameters():
            p.grad = precond[name]
        opt.step()
        rec.append({'loss': float(loss), 'contrib': contrib,
                    'inverses': state['inverses'],
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
    return {'kfac': kfac, 'state': state, 'jax': jrec, 'torch': trec,
            'launches': dict(kernels.LAUNCHES)}


def _baked_to_torch(inverses: dict, specs: dict) -> dict:
    """JAX ``A_inv`` / ``G_inv`` slots keyed by the port's layer names, a
    conv ``A_inv`` permuted into the ``(c, kh, kw)`` basis."""
    out = {}
    for jname, entry in inverses.items():
        name = jname.replace('/', '.')
        spec = specs[name]
        sides = {}
        for key in ('A_inv', 'G_inv'):
            if key not in entry:
                continue
            m = np.asarray(entry[key])
            if key == 'A_inv' and spec.kind == 'conv2d':
                kh, kw = spec.kernel_size
                cin = (m.shape[0] - int(spec.has_bias)) // (kh * kw)
                p = convert.conv_a_perm(spec.kernel_size, cin, spec.has_bias)
                m = m[p][:, p]
            sides[key] = m
        out[name] = sides
    return out


def test_losses(runs):
    np.testing.assert_allclose([r['loss'] for r in runs['torch']],
                               [r['loss'] for r in runs['jax']], rtol=1e-4)


@pytest.mark.parametrize('step', range(STEPS))
def test_factor_contributions(runs, step):
    ref = convert.jax_factors_to_torch(runs['jax'][step]['contrib'],
                                       runs['kfac'].specs)
    got = runs['torch'][step]['contrib']
    assert set(ref) == set(got)
    tol = 1e-4 if step == 0 else 1e-3
    for name, f in ref.items():
        for side in ('A', 'G'):
            r = f[side].numpy()
            scale = np.abs(r).max()
            assert scale > 0, f'{name}/{side} step {step}: zero contribution'
            np.testing.assert_allclose(
                got[name][side].numpy(), r, rtol=0, atol=tol * scale,
                err_msg=f'{name}/{side} step {step}')


@pytest.mark.parametrize('step', [0, 2])
def test_baked_inverses(runs, step):
    """The firings' ``A_inv`` / ``G_inv``: the same slots as the JAX
    state, the same values."""
    ref = _baked_to_torch(runs['jax'][step]['inverses'], runs['kfac'].specs)
    got = runs['torch'][step]['inverses']
    assert {n: set(e) for n, e in got.items()} == {
        n.replace('/', '.'): set(e)
        for n, e in runs['jax'][step]['inverses'].items()}
    baked = 0
    for name, sides in ref.items():
        for key, m in sides.items():
            baked += 1
            np.testing.assert_allclose(got[name][key].numpy(), m, rtol=1e-4,
                                       atol=1e-5 * np.abs(m).max(),
                                       err_msg=f'{name}/{key} step {step}')
    assert baked > 0


@pytest.mark.parametrize('what', ['precond', 'params'])
@pytest.mark.parametrize('step', range(STEPS))
def test_preconditioned_grads_and_params(runs, step, what):
    ref = convert.flax_to_torch(runs['jax'][step][what])
    got = runs['torch'][step][what]
    assert set(ref) == set(got)
    for name, t in ref.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=5e-3,
                                   atol=5e-5, err_msg=f'{name} step {step}')


def test_layout_of_the_dispatch(runs):
    kfac, state = runs['kfac'], runs['state']
    assert len(kfac.specs) == 18          # 17 convs + the head
    layers = state['inverses'].values()
    mixed = sum('A_inv' in e and 'QA' in e or 'G_inv' in e and 'QG' in e
                for e in layers)
    eigen = sum(set(e) == {'QA', 'dA', 'QG', 'dG'} for e in layers)
    if kfac.inverse_method == 'auto':
        assert mixed > 0 and eigen > 0
    else:
        assert mixed == eigen == 0
        assert all(set(e) == {'A_inv', 'G_inv'} for e in layers)


def test_state_dict_round_trip_with_baked_slots(runs):
    kfac, state = runs['kfac'], runs['state']
    again = kfac.load_state_dict(kfac.state_dict(state,
                                                 include_inverses=True))
    for name, entry in state['inverses'].items():
        assert set(again['inverses'][name]) == set(entry)
        for k, t in entry.items():
            assert torch.equal(again['inverses'][name][k], t)
    # Without stored inverses every slot is rebuilt from the factors: the
    # baked ones as a firing at the constructor's damping computes them.
    rebuilt = kfac.load_state_dict(kfac.state_dict(state))
    assert {n: set(e) for n, e in rebuilt['inverses'].items()} == {
        n: set(e) for n, e in state['inverses'].items()}
    ref = kfac.update_inverses(state, warm=False)
    for name, entry in ref.items():
        for key in ('A_inv', 'G_inv'):
            if key in entry:
                np.testing.assert_allclose(
                    rebuilt['inverses'][name][key].numpy(),
                    entry[key].numpy(), rtol=1e-4, atol=1e-6)


def test_cpu_path_launches_no_kernel(runs):
    assert set(runs['launches'].values()) == {0}
