"""The last single-device ``KFAC`` knobs of the torch port
(``use_eigen_decomp``, ``precond_bucketing=False``, ``trainable``) and the
GroupNorm CIFAR ResNets, against the JAX package.

Models: the 1-1-1 CIFAR ResNet at 8 px (BatchNorm and GroupNorm), batch
8 from a numpy seed, one K-FAC step with exact eigh on both sides.

Tolerances: the knobs' validation messages equal JAX's word for word;
the per-layer preconditioning within 1e-6 of the bucketed path's largest
entry per tensor (held to a tolerance, not bitwise: the JAX package's
own bit-identity pins of the two paths fail, ROADMAP Queue 3) and within
1e-4 of JAX's per-layer path; a ``trainable`` step's preconditioned
gradients within 1e-4 of JAX's per tensor, frozen layers' gradients
equal to the plain ones bit for bit; the GroupNorm model's logits within
1e-5 of JAX's largest; the conversions exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.preconditioner import NOT_PORTED, \
    KFAC


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in
    parallel next to JAX's virtual devices)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


B, PX = 8, 8
HYPER = dict(damping=0.003, lr=0.1, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=1, inverse_method='eigen', eigh_method='xla')


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, PX, PX, 3)).astype('float32'),
            rng.integers(0, 10, size=B))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_step(norm='batch', **knobs):
    """One JAX ``KFAC`` step (jitted): the initial variables, the loss,
    the raw and the preconditioned gradients and the K-FAC object."""
    x, y = _data()
    jkfac = JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1), norm=norm),
                  **{**HYPER, **knobs})
    variables, kstate = jkfac.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mutable = ('batch_stats',) if 'batch_stats' in variables else ()
    extra = {c: variables[c] for c in mutable}

    @jax.jit
    def step(params, kstate, extra, x, y):
        loss, _, grads, captures, _ = jkfac.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(),
            params, x, extra_vars=extra, mutable_cols=mutable)
        precond, kstate = jkfac.step(kstate, grads, captures,
                                     factor_update=True, inv_update=True)
        return loss, grads, precond, kstate

    loss, grads, precond, kstate = step(variables['params'], kstate, extra,
                                        jnp.asarray(x), jnp.asarray(y))
    as_torch = lambda t: {k: v.numpy() for k, v in  # noqa: E731
                          convert.flax_to_torch(
                              jax.tree.map(np.asarray, t)).items()}
    return {'variables': jax.tree.map(np.asarray, variables),
            'loss': float(loss), 'grads': as_torch(grads),
            'precond': as_torch(precond), 'kfac': jkfac,
            'kstate': kstate}


def _port_step(variables, norm='batch', **knobs):
    x, y = _data()
    model = cifar_resnet.CifarResNet((1, 1, 1), norm=norm)
    model.load_state_dict(convert.flax_to_torch(
        variables['params'], variables.get('batch_stats')))
    kfac = KFAC(model, device='cpu', **{**HYPER, **knobs})
    yt = torch.from_numpy(y)
    loss, _, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, yt), _nchw(x))
    raw = {n: g.clone() for n, g in grads.items()}
    state = kfac.init_state()
    precond, state = kfac.step(state, grads, captures, factor_update=True,
                               inv_update=True)
    return {'loss': float(loss), 'grads': raw, 'precond': precond,
            'kfac': kfac, 'state': state}


# ---------------------------------------------------------------------------
# use_eigen_decomp
# ---------------------------------------------------------------------------

USE_EIGEN = [None, True, False]
METHODS = [None, 'auto', 'eigen', 'cholesky', 'newton']


def _outcome(cls, **kw):
    """The resolved ``(inverse_method, use_eigen_decomp)``, or the
    ``ValueError`` text."""
    try:
        k = cls(**kw)
    except ValueError as e:
        return str(e)
    return k.inverse_method, k.use_eigen_decomp


@pytest.mark.parametrize('method', METHODS)
@pytest.mark.parametrize('use_eigen', USE_EIGEN)
def test_use_eigen_decomp_maps_onto_inverse_method_as_jax(use_eigen,
                                                          method):
    """Every combination resolves, or raises the contradiction, as the
    JAX ``KFAC`` does (JAX: ``preconditioner.py:566-579``)."""
    kw = {'use_eigen_decomp': use_eigen, 'inverse_method': method}
    want = _outcome(lambda **k: JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1)),
                                      **k), **kw)
    got = _outcome(lambda **k: KFAC(cifar_resnet.CifarResNet((1, 1, 1)),
                                    device='cpu', **k), **kw)
    assert got == want


def test_use_eigen_decomp_runs_the_method_it_names():
    """``use_eigen_decomp=False`` bakes damped Cholesky inverses,
    ``True`` keeps eigen slots, on every layer."""
    model = cifar_resnet.CifarResNet((1, 1, 1))
    baked = KFAC(model, device='cpu', use_eigen_decomp=False).init_state()
    eigen = KFAC(model, device='cpu', use_eigen_decomp=True).init_state()
    assert all(set(e) == {'A_inv', 'G_inv'}
               for e in baked['inverses'].values())
    assert all(set(e) == {'QA', 'dA', 'QG', 'dG'}
               for e in eigen['inverses'].values())
    assert 'use_eigen_decomp' not in NOT_PORTED
    assert 'use_eigen_decomp: True' in repr(KFAC(model, device='cpu',
                                                 use_eigen_decomp=True))


# ---------------------------------------------------------------------------
# precond_bucketing=False
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_bucketing():
    """The JAX package's bucketed and per-layer preconditioning of one
    state and gradient set (its ``test_bucketing_opt_out_is_exact``
    setting)."""
    ref = _jax_step()
    jkfac, kstate = ref['kfac'], ref['kstate']
    x, y = _data()
    variables = ref['variables']
    _, _, grads, _, _ = jkfac.capture.loss_and_grads(
        lambda out: optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean(),
        variables['params'], jnp.asarray(x),
        extra_vars={'batch_stats': variables['batch_stats']},
        mutable_cols=('batch_stats',))
    def precondition(bucketing: bool) -> dict:
        # The knob is read while tracing: one jitted function per value.
        jkfac.precond_bucketing = bucketing
        p = jax.jit(lambda s, g: jkfac.precondition(s, g, 0.01, 0.1))(
            kstate, grads)
        return {k: v.numpy() for k, v in convert.flax_to_torch(
            jax.tree.map(np.asarray, p)).items()}

    out = {True: precondition(True), False: precondition(False)}
    jkfac.precond_bucketing = True
    return ref, kstate, grads, out


@pytest.mark.parametrize('fused', [True, False], ids=['k3', 'stock'])
def test_per_layer_preconditioning_matches_bucketed_and_jax(jax_bucketing,
                                                            fused,
                                                            monkeypatch):
    """``precond_bucketing=False`` preconditions each layer as a stack of
    one (with ``fused_precondition``, one K3 call per layer instead of
    one per shape), holding the bucketed result and JAX's per-layer
    result at the module's tolerances."""
    ref, kstate, jgrads, want = jax_bucketing
    specs = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu').specs
    state = {'inverses': convert.jax_inverses_to_torch(
        jax.tree.map(np.asarray, kstate['inverses']), specs)}
    grads = convert.flax_to_torch(jax.tree.map(np.asarray, jgrads))
    calls = []
    orig = kernels.bucket_precond

    def counted(gstack, *a, **kw):
        calls.append(gstack.shape[0])
        return orig(gstack, *a, **kw)

    monkeypatch.setattr(kernels, 'bucket_precond', counted)
    out = {}
    for bucketing in (True, False):
        kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                    precond_bucketing=bucketing, fused_precondition=fused,
                    **{k: v for k, v in HYPER.items() if k != 'damping'})
        calls.clear()
        out[bucketing] = kfac.precondition(state, grads, 0.01, 0.1)
        n_calls = list(calls)
        if fused and bucketing:
            assert len(n_calls) < len(kfac.specs) and max(n_calls) > 1
        elif fused:
            assert n_calls == [1] * len(kfac.specs)
        else:
            assert n_calls == []
    assert kfac.precond_bucketing is False
    assert 'precond_bucketing: False' in repr(kfac)
    for name, t in out[True].items():
        assert _rel(out[False][name], t) <= 1e-6, name
        assert _rel(out[False][name], want[False][name]) <= 1e-4, name


# ---------------------------------------------------------------------------
# trainable
# ---------------------------------------------------------------------------

def _frozen(path: str) -> bool:
    """True for the modules the predicate leaves training: everything but
    stage 3 and the head (a JAX ``a/b`` or a torch ``a.b`` path)."""
    return not ('layer3' in path or 'linear' in path)


def test_trainable_declines_frozen_layers_as_jax():
    """The same layers registered, and each frozen module declined with
    JAX's reason in ``skipped_modules``."""
    ref = _jax_step(trainable=_frozen)
    jkfac = ref['kfac']
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                trainable=_frozen, **HYPER)
    assert sorted(kfac.specs) == sorted(n.replace('/', '.')
                                        for n in jkfac.specs)
    frozen = lambda skipped: {  # noqa: E731
        k.replace('/', '.'): v for k, v in skipped.items()
        if v.startswith('frozen (trainable')}
    got, want = frozen(kfac.capture.skipped_modules), frozen(
        jkfac.capture.skipped_modules)
    assert got == want and 'linear' in got and 'layer3_block0.conv1' in got
    assert set(got.values()) == {'frozen (trainable predicate): plain '
                                 'gradients, no factor work'}


def test_trainable_step_matches_jax():
    """One step under the predicate: frozen layers pass their gradients
    through unchanged and get no factors; the rest match JAX."""
    ref = _jax_step(trainable=_frozen)
    got = _port_step(ref['variables'], trainable=_frozen)
    assert abs(got['loss'] - ref['loss']) <= 1e-5 * abs(ref['loss'])
    assert not any('layer3' in n or 'linear' in n
                   for n in got['state']['factors'])
    for name, t in ref['precond'].items():
        g = got['precond'][name]
        if 'layer3' in name or name.startswith('linear'):
            assert torch.equal(g, got['grads'][name]), name
        assert _rel(g.numpy(), t) <= 1e-4, name


# ---------------------------------------------------------------------------
# The GroupNorm CIFAR ResNets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['resnet20gn', 'resnet32gn'])
def test_group_norm_models_match_jax(name):
    """``get_model('resnet<depth>gn')``: the JAX model's parameters name
    for name, GroupNorm of 8 groups at flax's epsilon 1e-6, and its
    logits within 1e-5 of JAX's from the same weights."""
    x, _ = _data()
    jmodel = jres.get_model(name)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    assert 'batch_stats' not in variables
    model = cifar_resnet.get_model(name)
    model.load_state_dict(convert.flax_to_torch(variables['params']))
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(m.num_groups == 8 and m.eps == 1e-6 for m in norms)
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in model.modules())
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert _rel(got, want) <= 1e-5


def test_group_norm_conversion_round_trips():
    """The GroupNorm ``scale`` / ``bias`` cross as ``weight`` / ``bias``
    both ways, exactly, with the parameters and with a whole K-FAC
    state."""
    ref = _jax_step(norm='group')
    params = ref['variables']['params']
    sd = convert.flax_to_torch(params)
    assert {'bn1.weight', 'bn1.bias',
            'layer2_block0.bn2.weight'} <= set(sd)
    back, stats = convert.torch_to_flax(sd)
    assert stats == {}
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    specs = KFAC(cifar_resnet.CifarResNet((1, 1, 1), norm='group'),
                 device='cpu').specs
    kstate = jax.tree.map(np.asarray, ref['kstate'])
    torch_state = convert.jax_state_to_torch(kstate, specs)
    again = convert.torch_state_to_jax(torch_state, specs)
    for key in ('factors', 'inverses'):
        for a, b in zip(jax.tree.leaves(again[key]),
                        jax.tree.leaves(kstate[key])):
            assert np.array_equal(a, b)


def test_group_norm_step_matches_jax():
    """One K-FAC step of the GroupNorm model against JAX's."""
    ref = _jax_step(norm='group')
    got = _port_step(ref['variables'], norm='group')
    assert abs(got['loss'] - ref['loss']) <= 1e-5 * abs(ref['loss'])
    for name, t in ref['precond'].items():
        assert _rel(got['precond'][name].numpy(), t) <= 1e-4, name
