"""MobileNetV1 in the torch port (``models/mobilenet.py``) against the JAX
package's (``distributed_kfac_pytorch_tpu/models/mobilenet.py``).

  - the parameter count of the 1.0x model at 1000 classes (4.23 M, the
    JAX suite's ``tests/test_models.py`` golden) and the registration:
    13 depthwise convs as ``conv2d_grouped``, the stem and 13 pointwise
    convs as ``conv2d``, the head as ``linear``, only BatchNorms declined;
  - the parameter conversion round trip (grouped kernels ``(kh, kw, 1,
    c)`` <-> weights ``(c, 1, kh, kw)``);
  - at width 0.25 and 64 px, batch 4, weights converted from the JAX
    model: the forward pass in training mode (batch statistics) and in
    evaluation mode (running statistics); the training-mode gradients
    against a float64 twin; and two K-FAC + SGD steps (factors every
    step, inverses at step 0, exact eigh on both sides: the warm polish is
    sensitive to fp32 summation order on these rank-deficient factors,
    ROADMAP Queue 3).

The K-FAC steps run the BatchNorms on their running statistics (as an
evaluation-mode forward pass). In training mode flax's one-pass batch
variance (``E[x^2] - E[x]^2``) cancels digits over the 16 values per
channel of the last blocks: the JAX fp32 gradients are ~1e-3 of each
tensor's largest entry from float64 there, the port's ~2e-5 (the gradient
test below holds the port to float64 and JAX loosely), so a step in
training mode could not tell a fault from that noise.

Tolerances, relative to the largest reference entry: logits 1e-5 (train
mode 1e-4: the batch statistics sum in another order over a deep net),
losses 1e-5, factors 1e-5, preconditioned gradients 1e-4 per tensor;
training-mode gradients of the weight layers 1e-4 from float64 (the
port) and 2e-2 (JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import mobilenet as jmob
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED
from distributed_kfac_pytorch_tpu_torch.models import mobilenet
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


WIDTH, PX, BATCH, CLASSES, LR, STEPS = 0.25, 64, 4, 10, 0.1, 2
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=10, inverse_method='eigen', eigh_method='xla')


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BATCH, PX, PX, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=BATCH).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope='module')
def jax_variables():
    x, _ = _batch()
    model = jmob.get_model(CLASSES, WIDTH)
    init = jax.jit(lambda key, v: model.init(key, v, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))


def _port_model(variables) -> mobilenet.MobileNetV1:
    model = mobilenet.get_model(CLASSES, WIDTH)
    model.load_state_dict(convert.flax_to_torch(variables['params'],
                                                variables['batch_stats']))
    return model


def test_parameter_count_and_registration():
    model = mobilenet.get_model()
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6
               - 4.23) < 0.03
    kfac = KFAC(model, device='cpu')
    kinds = {n: s.kind for n, s in kfac.specs.items()}
    grouped = [n for n, k in kinds.items() if k == CONV2D_GROUPED]
    assert grouped == [f'block{i}.dw' for i in range(13)]
    assert all(kfac.specs[n].feature_group_count
               == getattr(model, n.split('.')[0]).dw.in_channels
               for n in grouped)
    assert sum(k == 'conv2d' for k in kinds.values()) == 14
    assert kinds['fc'] == 'linear' and len(kinds) == 28
    assert all('bn' in name for name in kfac.capture.skipped_modules)
    with pytest.raises(NotImplementedError, match='dtype'):
        mobilenet.MobileNetV1(dtype=torch.float64)


def test_conversion_round_trips(jax_variables):
    model = _port_model(jax_variables)
    sd = model.state_dict()
    assert tuple(sd['block0.dw.weight'].shape) == (8, 1, 3, 3)
    params, stats = convert.torch_to_flax(sd)
    for tree, ref in ((params, jax_variables['params']),
                      (stats, jax_variables['batch_stats'])):
        jax.tree.map(np.testing.assert_array_equal, tree, ref)


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_jax(jax_variables, train):
    x, _ = _batch(1)
    model = jmob.get_model(CLASSES, WIDTH)
    if train:
        ref, upd = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=['batch_stats']))(
                jax_variables, jnp.asarray(x))
    else:
        ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(
            jax_variables, jnp.asarray(x))
    port = _port_model(jax_variables).train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (BATCH, CLASSES)
    assert _rel(got, np.asarray(ref)) <= (1e-4 if train else 1e-5)
    if train:
        mean = upd['batch_stats']['block12']['bn_pw']['mean']
        assert _rel(port.block12.bn_pw.running_mean,
                    np.asarray(mean)) <= 1e-4


def test_train_mode_gradients_against_float64(jax_variables):
    x, y = _batch()
    model = jmob.get_model(CLASSES, WIDTH)

    def loss_fn(params):
        out, _ = model.apply({**jax_variables, 'params': params},
                             jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean()

    jgrads = convert.flax_to_torch(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_fn))(jax_variables['params'])))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        port = _port_model(jax_variables).to(dtype)
        F.cross_entropy(port(_nchw(x).to(dtype)),
                        torch.from_numpy(y).long()).backward()
        grads[dtype] = {n: p.grad for n, p in port.named_parameters()}
    weights = [n for n in grads[torch.float32] if 'bn' not in n]
    assert len(weights) == 29
    for name in weights:
        want = grads[torch.float64][name].numpy()
        assert _rel(grads[torch.float32][name].double(), want) <= 1e-4, name
        assert _rel(jgrads[name].double(), want) <= 2e-2, name


def _jax_run(variables):
    kfac = JKFAC(jmob.get_model(CLASSES, WIDTH), **HYPER)
    x0, _ = _batch()
    # Jitted: registration runs once, while the init is traced.
    _, kstate = jax.jit(kfac.init)(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = variables['params']
    extra = {'batch_stats': variables['batch_stats']}

    def step_fn(params, kstate, extra, x, y, inv_update):
        loss, _, grads, captures, _ = kfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(),
            params, x, extra_vars=extra, train=False)
        precond, kstate = kfac.step(kstate, grads, captures,
                                    factor_update=True,
                                    inv_update=inv_update)
        params = jax.tree.map(lambda p, g: p - LR * g, params, precond)
        return loss, precond, params, kstate, extra

    jstep = jax.jit(step_fn, static_argnames=('inv_update',))
    recs = []
    for step in range(STEPS):
        x, y = _batch(step)
        loss, precond, params, kstate, extra = jstep(
            params, kstate, extra, jnp.asarray(x), jnp.asarray(y),
            inv_update=step == 0)
        recs.append({'loss': float(loss),
                     'factors': jax.tree.map(np.asarray, kstate['factors']),
                     'precond': jax.tree.map(np.asarray, precond)})
    return recs


def test_kfac_steps_match_jax(jax_variables):
    jrecs = _jax_run(jax_variables)
    model = _port_model(jax_variables).eval()
    kfac = KFAC(model, device='cpu', **HYPER)
    state = kfac.init_state()
    kernels.reset_launches()
    for step, jr in enumerate(jrecs):
        x, y = _batch(step)
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, torch.from_numpy(y).long()),
            _nchw(x))
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True,
                                   inv_update=step == 0)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
        assert abs(float(loss) - jr['loss']) <= 1e-5 * abs(jr['loss'])
        want = convert.jax_factors_to_torch(jr['factors'], kfac.specs)
        for name, f in want.items():
            for side in 'AG':
                assert _rel(state['factors'][name][side],
                            f[side].numpy()) <= 1e-5, (step, name, side)
        want = convert.flax_to_torch(jr['precond'])
        for name, t in want.items():
            assert _rel(precond[name], t.numpy()) <= 1e-4, (step, name)
    assert set(kernels.LAUNCHES.values()) == {0}
    assert tuple(state['factors']['block0.dw']['A'].shape) == (8, 9, 9)
    assert tuple(state['inverses']['block0.dw']['G_inv'].shape) == (8, 1, 1)
