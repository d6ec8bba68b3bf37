"""Grouped and depthwise conv K-FAC (kind ``conv2d_grouped``) in the torch
port against the JAX package, on the CPU.

The net is the JAX suite's ``DWNet`` (``tests/test_grouped_conv.py``):
a 1x1 conv, a 3x3 depthwise conv (8 groups), a 3x3 conv of 2 groups and a
Linear head, all with biases, on 8 x 8 x 3 inputs; its weights are carried
over by ``convert.flax_to_torch``. Covered:

  - registration, the per-group A and G factors against JAX
    ``conv2d_grouped_a_factor`` / ``_g_factor`` (depthwise, ``cpg > 1``,
    bias, stride 2, bf16 multiplicands; the A blocks permuted from JAX's
    ``(kh, kw, cpg)`` basis to the port's ``(cpg, kh, kw)``) and against
    the port's own dense conv factor of each channel slice, the gradient
    matrices, the precondition with identity factors;
  - ``KFAC`` steps against the JAX ``KFAC`` with the knobs the grouped kind
    composes with: the inverse methods, the three reduced-precision
    knobs, pipelined chunks with staleness, deferred reduction,
    ``factor_batch_fraction``; a converted JAX state and a checkpoint
    bundle.

Gradient accumulation and ``DistributedKFAC`` with grouped layers are in
``tests/test_torch_grouped_conv_dist.py`` (each file stays well inside a
minute on one CPU core).

Tolerances, each relative to the largest reference entry of the tensor:
factors 1e-5, preconditioned gradients 1e-4, ``nu`` 1e-5 (fp32 summation
order); with the three bf16 knobs, factors 2e-2 and gradients 5e-2 (the
JAX stock path blends and multiplies in bf16 arithmetic, the port widens
and rounds once; one bf16 ulp is ~4e-3 and the gaps compound over the
steps). Factor functions 1e-5 (bf16 multiplicands too: both sides round
the same fp32 values).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED
from distributed_kfac_pytorch_tpu_torch.ops import factors as TF
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

FACTOR_TOL, PRECOND_TOL, NU_TOL = 1e-5, 1e-4, 1e-5
BF16_FACTOR_TOL, BF16_PRECOND_TOL = 2e-2, 5e-2
BATCH, LR, I_FREQ = 16, 0.1, 4
COMMON = dict(factor_update_freq=1, inv_update_freq=I_FREQ, damping=0.01,
              lr=LR, kl_clip=0.001)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Test files run in parallel processes next to JAX's virtual
    devices; one torch thread each keeps the machine from
    oversubscription."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class DWNet(nn.Module):
    """Torch twin of the JAX suite's ``DWNet``: pointwise -> depthwise ->
    grouped -> head (MobileNet-style mix)."""

    def __init__(self):
        super().__init__()
        self.pw = nn.Conv2d(3, 8, 1)
        self.dw = nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.grouped = nn.Conv2d(8, 16, 3, padding=1, groups=2)
        self.head = nn.Linear(16, 5)

    def forward(self, x):
        x = F.relu(self.pw(x))
        x = F.relu(self.dw(x))
        x = F.relu(self.grouped(x))
        return self.head(x.mean(dim=(2, 3)))


def _data(n=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=n).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    want = np.asarray(torch.as_tensor(want).float().numpy(), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _model(flax_params) -> DWNet:
    model = DWNet()
    model.load_state_dict(convert.flax_to_torch(flax_params))
    return model


# ---------------------------------------------------------------------------
# Registration, factors, gradient matrices
# ---------------------------------------------------------------------------

def test_registration_accepts_grouped():
    kfac = KFAC(DWNet(), device='cpu')
    kinds = {n: s.kind for n, s in kfac.specs.items()}
    assert kinds == {'pw': 'conv2d', 'dw': CONV2D_GROUPED,
                     'grouped': CONV2D_GROUPED, 'head': 'linear'}
    assert kfac.specs['dw'].feature_group_count == 8
    assert kfac.specs['grouped'].feature_group_count == 2
    assert kfac.specs['pw'].feature_group_count == 1
    assert not kfac.capture.skipped_modules
    # The other declines stay.
    dil = nn.Sequential(nn.Conv2d(4, 4, 3, dilation=2, groups=2))
    assert 'dilated' in KFAC(dil, device='cpu').capture.skipped_modules['0']


# (groups, cin, cout, stride, bias, compute dtype)
FACTOR_CASES = {
    'depthwise': (8, 8, 8, 1, False, None),
    'depthwise_x2_bias_s2': (8, 8, 16, 2, True, None),
    'cpg3_bias_s2': (2, 6, 4, 2, True, None),
    'cpg2_bias_bf16': (4, 8, 8, 1, True, torch.bfloat16),
}


@pytest.mark.parametrize('case', list(FACTOR_CASES))
def test_grouped_factors_match_jax(case):
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu.ops import factors as JF
    groups, c, cout, stride, bias, cdt = FACTOR_CASES[case]
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 7, 7, c)).astype(np.float32)
    oh = (7 + 2 - 3) // stride + 1
    g = rng.normal(size=(4, oh, oh, cout)).astype(np.float32)
    ks, st, pad = (3, 3), (stride, stride), ((1, 1), (1, 1))
    jcdt = jnp.bfloat16 if cdt is not None else None
    ja = np.asarray(jax.jit(lambda v: JF.conv2d_grouped_a_factor(
        v, ks, st, list(pad), groups, bias, compute_dtype=jcdt))(
            jnp.asarray(a)))
    jg = np.asarray(jax.jit(lambda v: JF.conv2d_grouped_g_factor(
        v, groups, compute_dtype=jcdt))(jnp.asarray(g)))
    ta = TF.conv2d_grouped_a_factor(_nchw(a), ks, st, pad, groups, bias,
                                    compute_dtype=cdt)
    tg = TF.conv2d_grouped_g_factor(_nchw(g), groups, compute_dtype=cdt)
    cpg = c // groups
    da = 9 * cpg + bias
    assert tuple(ta.shape) == (groups, da, da)
    assert tuple(tg.shape) == (groups, cout // groups, cout // groups)
    perm = convert.conv_a_perm(ks, cpg, bias)
    assert _rel(ta, ja[:, perm][:, :, perm]) <= FACTOR_TOL
    assert _rel(tg, jg) <= FACTOR_TOL
    # Slice equivalence on the port: group i is the dense conv factor of
    # channel slice i.
    opg = cout // groups
    for i in range(groups):
        dense_a = TF.conv2d_a_factor(_nchw(a)[:, i * cpg:(i + 1) * cpg],
                                     ks, st, pad, bias, compute_dtype=cdt)
        dense_g = TF.conv2d_g_factor(_nchw(g)[:, i * opg:(i + 1) * opg],
                                     compute_dtype=cdt)
        assert _rel(ta[i], dense_a) <= FACTOR_TOL, i
        assert _rel(tg[i], dense_g) <= FACTOR_TOL, i


def test_grouped_factor_rejects_indivisible_channels():
    with pytest.raises(ValueError, match='not divisible'):
        TF.conv2d_grouped_a_factor(torch.zeros(1, 6, 4, 4), (3, 3), (1, 1),
                                   ((1, 1), (1, 1)), 4, False)
    with pytest.raises(ValueError, match='not divisible'):
        TF.conv2d_grouped_g_factor(torch.zeros(1, 6, 4, 4), 4)


def test_grads_matrix_matches_jax_and_round_trips():
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu.capture import LayerSpec as JSpec
    from distributed_kfac_pytorch_tpu.layers import base as JL
    kfac = KFAC(DWNet(), device='cpu')
    rng = np.random.default_rng(2)
    for name in ('dw', 'grouped'):
        spec = kfac.specs[name]
        mod = getattr(kfac.model, name)
        fake = {'weight': torch.from_numpy(rng.normal(
                    size=mod.weight.shape).astype(np.float32)),
                'bias': torch.from_numpy(rng.normal(
                    size=mod.bias.shape).astype(np.float32))}
        mat = L.grads_to_matrix(spec, fake)
        ng = spec.feature_group_count
        cpg = mod.weight.shape[1]
        assert tuple(mat.shape) == (ng, mod.weight.shape[0] // ng,
                                    9 * cpg + 1)
        back = L.matrix_to_grads(spec, mat, fake)
        for key in fake:
            assert torch.equal(back[key], fake[key]), key
        jspec = JSpec(path=(name,), kind='conv2d_grouped', has_bias=True,
                      kernel_size=(3, 3), strides=(1, 1),
                      feature_group_count=ng)
        jmat = np.asarray(JL.grads_to_matrix(jspec, {
            'kernel': jnp.asarray(fake['weight'].numpy().transpose(
                2, 3, 1, 0)),
            'bias': jnp.asarray(fake['bias'].numpy())}))
        perm = convert.conv_a_perm((3, 3), cpg, True)
        assert torch.equal(mat, torch.from_numpy(jmat[..., perm]))
        assert L.factor_shapes(spec, fake) == (9 * cpg + 1,
                                               mod.weight.shape[0] // ng)


def test_grouped_precondition_identity_factors():
    """Identity factors and damping l: both block inverses are 1/(1+l) I,
    so a grouped layer's preconditioned gradient is grad / (1+l)^2 (the
    JAX suite's pin of the batched path, end to end)."""
    lam = 0.5
    kfac = KFAC(DWNet(), device='cpu', damping=lam, kl_clip=None,
                factor_update_freq=10 ** 9, inv_update_freq=1)
    torch.manual_seed(2)
    grads = {n: torch.randn_like(p)
             for n, p in kfac.model.named_parameters()}
    precond, state = kfac.step(kfac.init_state(), grads, {},
                               factor_update=False, inv_update=True)
    for name in ('dw', 'grouped'):
        for key in ('weight', 'bias'):
            full = f'{name}.{key}'
            torch.testing.assert_close(precond[full],
                                       grads[full] / (1 + lam) ** 2,
                                       rtol=1e-5, atol=1e-6)
        inv = state['inverses'][name]
        assert set(inv) == {'A_inv', 'G_inv'}
        assert inv['A_inv'].shape[0] == kfac.specs[name].feature_group_count


def test_grouped_layers_launch_no_kernel_and_use_cholesky():
    """Whatever ``inverse_method`` says, a grouped conv's blocks take the
    damped Cholesky; it is preconditioned outside the buckets."""
    kfac = KFAC(DWNet(), device='cpu', inverse_method='newton',
                **COMMON)
    state = kfac.init_state()
    x, y = _data(4)
    _, _, g, c = kfac.capture.loss_and_grads(
        lambda o: F.cross_entropy(o, torch.from_numpy(y).long()), _nchw(x))
    _, state = kfac.step(state, g, c, factor_update=True, inv_update=True)
    f = state['factors']['dw']['A'].double()
    want = torch.linalg.inv(f + 0.01 * torch.eye(f.shape[-1]))
    assert _rel(state['inverses']['dw']['A_inv'], want) <= 1e-4
    names = [n for n, s in kfac.specs.items()
             if s.kind != CONV2D_GROUPED]
    assert kfac._side_methods(10, 1, 'dw') == (None, None)
    assert names == ['pw', 'head']


# ---------------------------------------------------------------------------
# KFAC steps against the JAX KFAC, with every knob
# ---------------------------------------------------------------------------

KNOB_CASES = {
    'eigen_xla': dict(inverse_method='eigen', eigh_method='xla'),
    'auto_newton': dict(inverse_method='auto', auto_eigen_max_dim=8,
                        auto_large_method='newton', eigh_method='xla'),
    'bf16_three': dict(inverse_method='eigen', eigh_method='xla',
                       factor_dtype='bf16', inv_dtype='bf16',
                       precond_compute_dtype='bf16'),
    'chunks2_stale': dict(inverse_method='cholesky', inv_pipeline_chunks=2,
                          inv_staleness=1),
    'deferred': dict(inverse_method='eigen', eigh_method='xla',
                     deferred_factor_reduction=True),
    'fraction_half': dict(inverse_method='cholesky',
                          factor_batch_fraction=0.5),
}
KNOB_STEPS = 5


def _dtypes(knobs: dict, bf16) -> dict:
    return {k: (bf16 if v == 'bf16' else v) for k, v in knobs.items()}


def _flags(knobs: dict, step: int) -> dict:
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, I_FREQ, knobs.get('inv_pipeline_chunks', 1),
        deferred_reduce=knobs.get('deferred_factor_reduction', False),
        inv_staleness=knobs.get('inv_staleness', 0)))


def _jax_stepper(jk):
    """``(params, state, x, y, flags) -> (params, state, precond)``: one
    jitted K-FAC + SGD step of the JAX ``KFAC`` ``jk`` per cadence-flag
    combination."""
    import jax
    import optax
    jitted = {}

    def step_fn(params, state, x, y, flags):
        _, _, grads, captures, _ = jk.capture.loss_and_grads(
            lambda out: optax.softmax_cross_entropy_with_integer_labels(
                out, y).mean(), params, x)
        precond, state = jk.step(state, grads, captures, **dict(flags))
        return (jax.tree.map(lambda p, g: p - LR * g, params, precond),
                state, precond)

    def run(params, state, x, y, flags):
        key = tuple(sorted(flags.items()))
        if key not in jitted:
            jitted[key] = jax.jit(functools.partial(step_fn, flags=key))
        return jitted[key](params, state, x, y)

    return run


def _jax_knob_run(knobs: dict, steps: int):
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from test_grouped_conv import DWNet as JDWNet
    jk = JKFAC(JDWNet(), **COMMON, **_dtypes(knobs, jnp.bfloat16))
    x0, _ = _data()
    variables, state = jk.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = variables['params']
    init = jax.tree.map(np.asarray, params)
    step_fn = _jax_stepper(jk)
    recs = []
    for step in range(steps):
        x, y = (jnp.asarray(v) for v in _data(seed=step))
        params, state, precond = step_fn(params, state, x, y,
                                         _flags(knobs, step))
        recs.append({'factors': jax.tree.map(np.asarray, state['factors']),
                     'precond': jax.tree.map(np.asarray, precond)})
    return init, recs, state


def _port_knob_run(knobs: dict, init, steps: int):
    model = _model(init)
    kfac = KFAC(model, device='cpu', **COMMON,
                **_dtypes(knobs, torch.bfloat16))
    state = kfac.init_state()
    recs = []
    for step in range(steps):
        x, y = _data(seed=step)
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, torch.from_numpy(y).long()),
            _nchw(x))
        precond, state = kfac.step(state, grads, captures,
                                   **_flags(knobs, step))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
        recs.append({'factors': state['factors'],
                     'precond': {n: t.clone() for n, t in precond.items()}})
    return kfac, recs, state


@pytest.mark.parametrize('case', list(KNOB_CASES))
def test_kfac_steps_match_jax(case):
    knobs = KNOB_CASES[case]
    init, jrecs, _ = _jax_knob_run(knobs, KNOB_STEPS)
    kernels.reset_launches()
    kfac, trecs, state = _port_knob_run(knobs, init, KNOB_STEPS)
    assert set(kernels.LAUNCHES.values()) == {0}
    bf16 = 'factor_dtype' in knobs
    ftol = BF16_FACTOR_TOL if bf16 else FACTOR_TOL
    ptol = BF16_PRECOND_TOL if bf16 else PRECOND_TOL
    for step, (jr, tr) in enumerate(zip(jrecs, trecs)):
        want = convert.jax_factors_to_torch(jr['factors'], kfac.specs)
        for name, f in want.items():
            for side in 'AG':
                got = tr['factors'][name][side]
                assert got.shape == f[side].shape, (name, side)
                assert _rel(got, f[side]) <= ftol, (step, name, side)
        want = convert.flax_to_torch(jr['precond'])
        assert set(want) == set(tr['precond'])
        for name, t in want.items():
            assert _rel(tr['precond'][name], t) <= ptol, (step, name)
    grouped = state['factors']['grouped']
    assert grouped['A'].dtype == kfac.storage_dtype
    assert state['inverses']['grouped']['A_inv'].dtype == kfac.inv_dtype
    assert tuple(grouped['A'].shape) == (2, 37, 37)
    assert tuple(state['factors']['dw']['A'].shape) == (8, 10, 10)


def test_chunk_plan_has_one_item_per_grouped_layer():
    kfac = KFAC(DWNet(), device='cpu', inv_pipeline_chunks=2, **COMMON)
    state = kfac.init_state()
    items = dict(kfac.inverse_chunk_items(state['factors']))
    assert ('grouped', 'dw') in items and ('grouped', 'grouped') in items
    assert not any(k[0] == 'mat' and k[1] in ('dw', 'grouped')
                   for k in items)
    # G (da^3 + dg^3): 8 (10^3 + 1) and 2 (37^3 + 8^3).
    assert items[('grouped', 'dw')] == 8 * (10 ** 3 + 1)
    assert items[('grouped', 'grouped')] == 2 * (37 ** 3 + 8 ** 3)
    plan = kfac.inverse_chunk_plan(state['factors'])
    assert set(plan.values()) == {0, 1}


def test_converted_jax_state_and_memory_usage_match_jax():
    """A JAX state (grouped stacks included) converted to the port
    steps on as in JAX; the port state converts back bit for bit;
    ``memory_usage`` equals JAX's."""
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from test_grouped_conv import DWNet as JDWNet
    knobs = dict(inverse_method='cholesky')
    init, _, jstate = _jax_knob_run(knobs, 2)
    jk = JKFAC(JDWNet(), **COMMON, **knobs)
    x0, _ = _data()
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = variables['params']
    kfac = KFAC(_model(init), device='cpu', **COMMON, **knobs)
    tstate = {**kfac.init_state(), **convert.jax_state_to_torch(
        jax.tree.map(np.asarray, jstate), kfac.specs)}
    assert kfac.memory_usage(tstate) == jk.memory_usage(jstate)
    back = convert.torch_state_to_jax(tstate, kfac.specs)
    for key in ('factors', 'inverses'):
        jax.tree.map(np.testing.assert_array_equal, back[key],
                     jax.tree.map(np.asarray, jstate[key]))
    x, y = _data(seed=7)
    _, jstate, jp = _jax_stepper(jk)(
        params, jstate, jnp.asarray(x), jnp.asarray(y),
        {'factor_update': True, 'inv_update': True})
    _, _, g, c = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, torch.from_numpy(y).long()),
        _nchw(x))
    tp, tstate = kfac.step(tstate, g, c, factor_update=True,
                           inv_update=True)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, jp))
    assert max(_rel(tp[n], want[n]) for n in want) <= PRECOND_TOL
    want = convert.jax_inverses_to_torch(
        jax.tree.map(np.asarray, jstate['inverses']), kfac.specs)
    for side in ('A_inv', 'G_inv'):
        assert _rel(tstate['inverses']['grouped'][side],
                    want['grouped'][side]) <= PRECOND_TOL


def test_checkpoint_bundle_round_trip(tmp_path):
    """A bundle with grouped stacks (``training.checkpoint``) restores
    the state bit for bit, inverses included."""
    from distributed_kfac_pytorch_tpu_torch.training import checkpoint
    init = {k: v.numpy() for k, v in DWNet().state_dict().items()}
    model = DWNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    kfac = KFAC(model, device='cpu', **COMMON)
    state = kfac.init_state()
    x, y = _data()
    for step in range(3):
        _, _, g, c = kfac.capture.loss_and_grads(
            lambda o: F.cross_entropy(o, torch.from_numpy(y).long()),
            _nchw(x))
        _, state = kfac.step(state, g, c, factor_update=True,
                             inv_update=step == 0)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    tree = checkpoint.bundle_state(
        model.state_dict(), {}, kfac.state_dict(state, True), {}, {})
    mgr.save(3, tree)
    back = mgr.restore(3)
    loaded = kfac.load_state_dict(back['kfac'])
    for key in ('factors', 'inverses'):
        for n, e in state[key].items():
            for k, t in e.items():
                assert torch.equal(loaded[key][n][k], t), (key, n, k)
