"""Block rematerialization of the ImageNet ResNet in the torch port
(``ImageNetResNet(remat=True)``, ``--remat``) against the JAX package's
``remat=True`` model and against the port's own plain step.

A narrow bottleneck ResNet (stages 1-1-1-1, width 8, 10 classes) at 32
px, batch 8 from a numpy seed. The port's remat model under ``KFAC``:
one K-FAC step against the JAX ``KFAC`` over the JAX remat model (exact
eigh on both sides), held at the tolerances of ``test_torch_kfac.py``'s
exact-eigh case: loss 1e-5 relative, factors within 1e-5 of the largest
entry, preconditioned gradients within 1e-4 of the largest entry per
tensor, running means 1e-5 and running variances ``n/(n-1)`` times
JAX's (torch keeps the unbiased batch variance) within 1e-5 relative.
Against the port's plain step on the CPU, a remat step is equal bit for
bit: the recomputation repeats the forward pass's arithmetic.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch import capture as capture_mod
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in
    parallel next to JAX's virtual devices)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


B, PX, STAGES, WIDTH, CLASSES = 8, 32, (1, 1, 1, 1), 8, 10
HYPER = dict(damping=0.003, lr=0.1, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=1, inverse_method='eigen', eigh_method='xla')


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, PX, PX, 3)).astype('float32'),
            rng.integers(0, CLASSES, size=B))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_model(remat, state_dict=None):
    torch.manual_seed(0)
    model = imagenet_resnet.ImageNetResNet(STAGES, num_classes=CLASSES,
                                           width=WIDTH, remat=remat)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _step(model, x, y, **knobs):
    """One K-FAC step through ``engine.train_step`` (SGD, lr 0.1): the
    loss, the captures' call counts, the factors, the preconditioned
    gradients and every buffer after it."""
    kfac = KFAC(model, device='cpu', **{**HYPER, **knobs})
    calls = {}
    orig = kfac.capture.collect

    def counted():
        out = orig()
        calls.update({n: len(c['a']) for n, c in out.items()})
        return out

    kfac.capture.collect = counted
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        kfac=kfac, kfac_state=kfac.init_state())
    loss, _ = engine.train_step(state, x, y, {'lr': 0.1, 'damping': 0.003},
                                {'factor_update': True, 'inv_update': True})
    return {'loss': loss, 'calls': calls,
            'factors': state.kfac_state['factors'],
            'precond': {n: p.grad.clone()
                        for n, p in model.named_parameters()},
            'buffers': {n: b.clone() for n, b in model.named_buffers()}}


def test_remat_step_equals_the_plain_step_bit_for_bit():
    """Each layer captured once per pass, the BatchNorm statistics and
    counters updated once, and every number of the step equal."""
    x, y = _data()
    plain = _step(_port_model(False), _nchw(x), torch.from_numpy(y))
    remat = _step(_port_model(True), _nchw(x), torch.from_numpy(y))
    assert set(remat['calls'].values()) == {1}
    assert remat['calls'] == plain['calls']
    assert torch.equal(remat['loss'], plain['loss'])
    for n, f in plain['factors'].items():
        for s, t in f.items():
            assert torch.equal(remat['factors'][n][s], t), (n, s)
    for n, t in plain['precond'].items():
        assert torch.equal(remat['precond'][n], t), n
    for n, t in plain['buffers'].items():
        assert torch.equal(remat['buffers'][n], t), n
    assert all(int(t) == 1 for n, t in remat['buffers'].items()
               if n.endswith('num_batches_tracked'))


def test_remat_with_gradient_accumulation():
    """``--remat`` with ``--grad-accum 2``: one capture per layer per
    micro-batch, two BatchNorm updates per step, the plain accumulated
    step's numbers bit for bit."""
    x, y = _nchw(_data()[0]), torch.from_numpy(_data()[1])
    out = []
    for remat in (False, True):
        model = _port_model(remat)
        kfac = KFAC(model, device='cpu', **HYPER)
        state = engine.TrainState(
            model=model,
            optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
            kfac=kfac, kfac_state=kfac.init_state(), grad_accum=2)
        loss, _, grads, _, contribs = engine.accumulate_pass(
            state, x, y, factor_update=True)
        out.append((loss, grads, contribs,
                    {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, c0, b0), (l1, g1, c1, b1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(g1[n], t) for n, t in g0.items())
    assert all(torch.equal(c1[n][k], t) for n, e in c0.items()
               for k, t in e.items())
    assert all(torch.equal(b1[n], t) for n, t in b0.items())
    assert all(int(t) == 2 for n, t in b1.items()
               if n.endswith('num_batches_tracked'))


def test_recomputation_without_the_guard_breaks_capture(monkeypatch):
    """What the guard prevents: with the recomputation recording, every
    rematerialized layer gains a second call whose output gradient never
    arrives."""
    monkeypatch.setattr(imagenet_resnet, 'recomputation',
                        contextlib.nullcontext)
    x, y = _data()
    model = _port_model(True)
    kfac = KFAC(model, device='cpu', **HYPER)
    with pytest.raises(ValueError, match='an output gradient was never '
                       'produced'):
        kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, torch.from_numpy(y)), _nchw(x))


def test_recomputation_leaves_the_batchnorm_statistics():
    """The block's buffers as the forward pass left them after its
    recomputation (flax discards a remat's mutations), and the guard is
    off again afterwards."""
    x, _ = _data()
    model = _port_model(True)
    out = model(_nchw(x))
    after_forward = {n: b.clone() for n, b in model.named_buffers()}
    out.sum().backward()
    for n, b in model.named_buffers():
        assert torch.equal(b, after_forward[n]), n
    assert getattr(capture_mod._RECOMPUTE, 'depth', 0) == 0


def test_remat_off_outside_training_or_without_grad():
    """Evaluation and ``no_grad`` forwards run the blocks directly and
    give the plain model's outputs."""
    x, _ = _data()
    plain, remat = _port_model(False), _port_model(True)
    for mode in ('eval', 'no_grad'):
        for m in (plain, remat):
            m.train(mode != 'eval')
        with torch.no_grad():
            a, b = plain(_nchw(x)), remat(_nchw(x))
        assert torch.equal(a, b), mode


def test_remat_model_matches_jax_remat_model():
    """One K-FAC step of the port's remat model against the JAX ``KFAC``
    over the JAX ``remat=True`` model, from the same weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu.models import imagenet_resnet as jres
    x, y = _data()
    jmodel = jres.ImageNetResNet(stage_sizes=STAGES, num_classes=CLASSES,
                                 width=WIDTH, remat=True)
    jkfac = JKFAC(jmodel, **HYPER)
    variables, kstate = jkfac.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables['params']
    extra = {'batch_stats': variables['batch_stats']}

    @jax.jit
    def jstep(params, kstate, extra, x, y):
        loss, _, grads, captures, upd = jkfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(),
            params, x, extra_vars=extra, mutable_cols=('batch_stats',))
        precond, kstate = jkfac.step(kstate, grads, captures,
                                     factor_update=True, inv_update=True)
        return loss, precond, kstate, upd

    loss, precond, kstate, upd = jstep(params, kstate, extra,
                                       jnp.asarray(x), jnp.asarray(y))

    init = convert.flax_to_torch(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray,
                                              variables['batch_stats']))
    model = _port_model(True, init)
    got = _step(model, _nchw(x), torch.from_numpy(y))
    assert set(got['calls'].values()) == {1}
    assert abs(float(got['loss']) - float(loss)) <= 1e-5 * abs(float(loss))
    want_f = convert.jax_factors_to_torch(
        jax.tree.map(np.asarray, kstate['factors']), model_specs(model))
    for n, f in want_f.items():
        for s, t in f.items():
            g = got['factors'][n][s].numpy()
            assert np.abs(g - t.numpy()).max() <= 1e-5 * np.abs(
                t.numpy()).max(), (n, s)
    want_p = convert.flax_to_torch(jax.tree.map(np.asarray, precond))
    for n, t in want_p.items():
        t = t.numpy()
        assert np.abs(got['precond'][n].numpy() - t).max() <= 1e-4 * max(
            np.abs(t).max(), 1e-30), n
    stats = convert.flax_to_torch(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, upd['batch_stats']))
    sizes = _values_per_channel(model, _nchw(x))
    for name, n in sizes.items():
        np.testing.assert_allclose(got['buffers'][f'{name}.running_mean'],
                                   stats[f'{name}.running_mean'],
                                   rtol=1e-5, atol=1e-6)
        # v = 0.9 * 1 + 0.1 * var: the unbiased factor on the batch term.
        want_var = 0.9 + (stats[f'{name}.running_var'].numpy() - 0.9) \
            * n / (n - 1)
        np.testing.assert_allclose(got['buffers'][f'{name}.running_var'],
                                   want_var, rtol=1e-5, atol=1e-6)


def model_specs(model):
    return KFAC(_port_model(False), device='cpu').specs


def _values_per_channel(model, x) -> dict:
    sizes, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    was = model.training
    model.eval()
    with torch.no_grad():
        model(x)
    model.train(was)
    for h in hooks:
        h.remove()
    return sizes


def test_imagenet_cli_remat_equals_plain_run():
    """``--remat`` through the ImageNet CLI on the CPU: the same losses,
    bit for bit, as the run without it (two steps, a firing each; stages
    3 and 4 left out of K-FAC by ``--skip-layers``, whose 2304- and
    4608-wide factors would take the CPU most of the time)."""
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    config = {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
              'val_batch_size': 2, 'synthetic_size': 8, 'epochs': 1,
              'inverse_method': 'cholesky', 'kfac_update_freq': 1,
              'kfac_cov_update_freq': 1, 'quiet': True,
              'skip_layers': ['layer3_block0', 'layer3_block1',
                              'layer4_block0', 'layer4_block1']}
    plain = train_imagenet_resnet.train(config, device='cpu')
    remat = train_imagenet_resnet.train({**config, 'remat': True},
                                        device='cpu')
    assert remat['state'].model.remat and not plain['state'].model.remat
    assert remat['losses'] == plain['losses'] and len(plain['losses']) == 2
