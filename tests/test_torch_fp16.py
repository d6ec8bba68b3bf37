"""fp16 robustness of the torch port (``fp16.py``, ``KFACCapture.
loss_and_grads(loss_scale=)``, ``KFAC(nonfinite_guard=True)`` and the
``nan-batch`` fault) against the JAX package, on the CPU.

Mirrors the JAX suite's ``TestFp16Robustness``
(``tests/test_mixed_precision.py``), the loss-scale pin of the plain
capture path (``tests/test_capture.py``), the guard driven by the
``nan-batch`` injector (``tests/test_resilience.py``) and the deferred
guard (``tests/test_overlap.py``):

  - ``update_loss_scale`` over seeded finite / non-finite sequences, both
    clips included: scale and counter equal to JAX's bit for bit at every
    step;
  - ``sanitize_captures`` with the tied embedding's streams: the same
    tensors zeroed and the same count as JAX, finite ones untouched;
  - ``apply_if_finite`` both ways;
  - ``loss_and_grads(loss_scale=)`` on an fp16 MLP against JAX's at the
    same fp16 compute: loss, gradients and ``g`` captures within 2e-3 of
    the largest reference entry (one fp16 rounding of either framework's
    fp16 products), every ``g`` capture fp32 on both sides; on an fp32
    net it is the identity (1e-5), on the plain (``intercept=False``)
    path as on the intercepting one;
  - an fp16 block rematerialized with ``torch.utils.checkpoint`` whose
    recomputation stops early inside its last layer (before that layer's
    forward hooks): gradients and captures equal to the plain pass bit
    for bit, the parameters fp32 again and no layer's input left behind;
  - an injected inf in one ``g`` capture, sanitized: the K-FAC step's
    factors finite and within 1e-5 of JAX's;
  - the training step under the dynamic loss scale with one capture made
    non-finite while the gradients stay finite (one pass, and two
    accumulated micro-batches): the step is skipped, parameters, momentum
    and K-FAC state bit for bit, the scale halved (the port folds the
    captures' finiteness into the skip where JAX zeroes the capture);
  - ``nonfinite_guard`` eager, deferred, with chunk firings and
    ``factor_batch_fraction``, and with grouped convs: a clean step's
    factors within 1e-5 of JAX's, then a step on a ``nan-batch``-poisoned
    batch leaves every factor bit for bit (as in JAX) while the unguarded
    step poisons them;
  - the ``nan-batch`` injector against JAX's, array for array.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu import fp16 as jfp16
from distributed_kfac_pytorch_tpu.resilience import faults as jfaults
from distributed_kfac_pytorch_tpu_torch import convert, fp16
from distributed_kfac_pytorch_tpu_torch.capture import (KFACCapture,
                                                        recomputation)
from distributed_kfac_pytorch_tpu_torch.modules.precision import \
    set_compute_dtype
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.resilience import faults

FACTOR_TOL, FP16_TOL = 1e-5, 2e-3


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


class JMLP(fnn.Module):
    """Dense(12) -> tanh -> Dense(4), flax compute ``dtype``."""
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        x = jnp.tanh(fnn.Dense(12, dtype=self.dtype, name='d1')(x))
        return fnn.Dense(4, dtype=self.dtype, name='d2')(x)


class MLP(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.d1 = nn.Linear(6, 12)
        self.d2 = nn.Linear(12, 4)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        return self.d2(torch.tanh(self.d1(x)))


def _x(seed=0, n=16, d=6):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _pair(jdtype=None, tdtype=torch.float32, **knobs):
    """A JAX ``KFAC`` on ``JMLP`` and the port's on its converted twin."""
    jk = JKFAC(JMLP(dtype=jdtype), **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(_x()))
    params = variables['params']
    model = MLP(tdtype)
    model.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(model, device='cpu', **knobs)
    return jk, params, jstate, tk, tk.init_state()


def _jax_factors(jstate, tk):
    return convert.jax_factors_to_torch(
        jax.tree.map(np.asarray, jstate['factors']), tk.specs)


# ---------------------------------------------------------------------------
# The schedule, the sanitizer and the select
# ---------------------------------------------------------------------------

SCHEDULES = {
    'default_growth': dict(initial=2.0 ** 15, growth_interval=3, n=40,
                           p_finite=0.8),
    'max_clip': dict(initial=2.0 ** 23, growth_interval=2, n=30,
                     p_finite=0.9),
    'min_clip': dict(initial=4.0, growth_interval=5, n=30, p_finite=0.3),
    'amp_interval': dict(initial=2.0 ** 15, growth_interval=2000, n=25,
                          p_finite=0.7),
}


def test_init_loss_scale_resolves_its_device(monkeypatch):
    """``device='cpu'`` builds the scale state on the CPU; the default
    is the card, which raises without one, as every entry point does
    (``resolve_device``)."""
    state = fp16.init_loss_scale(device='cpu')
    assert {t.device.type for t in state.values()} == {'cpu'}
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fp16.init_loss_scale()


@pytest.mark.parametrize('case', list(SCHEDULES))
def test_update_loss_scale_matches_jax_bit_for_bit(case):
    c = SCHEDULES[case]
    flags = np.random.default_rng(len(case)).random(c['n']) < c['p_finite']
    t = fp16.init_loss_scale(c['initial'], device='cpu')
    j = jfp16.init_loss_scale(c['initial'])
    assert t['scale'].dtype == torch.float32
    assert t['growth_count'].dtype == torch.int32
    seen = set()
    for f in flags:
        t = fp16.update_loss_scale(t, bool(f),
                                   growth_interval=c['growth_interval'])
        j = jfp16.update_loss_scale(j, bool(f),
                                    growth_interval=c['growth_interval'])
        assert t['scale'].numpy().tobytes() == \
            np.asarray(j['scale']).tobytes()
        assert int(t['growth_count']) == int(j['growth_count'])
        seen.add(float(t['scale']))
    if case == 'max_clip':
        assert 2.0 ** 24 in seen
    if case == 'min_clip':
        assert 1.0 in seen
    # A device-tensor flag steps like a Python bool.
    assert float(fp16.update_loss_scale(
        t, torch.tensor(False))['scale']) == max(float(t['scale']) / 2, 1.0)


def test_sanitize_captures_matches_jax_with_tied_streams():
    rng = np.random.default_rng(3)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    g0 = arr(2, 3)
    g0[1, 2] = np.inf
    a_tied = arr(4, 3)
    a_tied[0, 0] = np.nan
    caps = {
        'embed': {'a': (np.arange(8).reshape(2, 4),), 'g': (arr(2, 4, 3),),
                  'a_tied': (a_tied, arr(4, 3)),
                  'g_tied': (arr(4, 7), arr(4, 7))},
        'L1': {'a': (arr(2, 5),), 'g': (g0,)},
        'L2': {'a': (np.full((2, 2), np.nan, np.float32),),
               'g': (arr(2, 2).astype(np.float16),)},
    }
    tcaps = {n: {k: tuple(torch.from_numpy(np.asarray(v)) for v in calls)
                 for k, calls in e.items()} for n, e in caps.items()}
    jcaps = {n: {k: tuple(jnp.asarray(v) for v in calls)
                 for k, calls in e.items()} for n, e in caps.items()}
    clean, count = fp16.sanitize_captures(tcaps)
    jclean, jcount = jfp16.sanitize_captures(jcaps)
    assert int(count) == int(jcount) == 3
    for n, e in jclean.items():
        for k, calls in e.items():
            for got, want, orig in zip(clean[n][k], calls, caps[n][k]):
                assert got.dtype == tcaps[n][k][0].dtype
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                if np.isfinite(np.asarray(orig, np.float64)).all():
                    np.testing.assert_array_equal(got.numpy(), orig)
    assert not clean['L1']['g'][0].any() and not clean['L2']['a'][0].any()
    assert not clean['embed']['a_tied'][0].any()


def test_apply_if_finite_both_ways():
    old = {'w': torch.zeros(3), 'n': [torch.zeros(2, dtype=torch.int32)],
           'step': 4}
    new = {'w': torch.ones(3), 'n': [torch.ones(2, dtype=torch.int32)],
           'step': 5}
    kept = fp16.apply_if_finite(torch.tensor(False), new, old)
    assert torch.equal(kept['w'], torch.zeros(3))
    assert torch.equal(kept['n'][0], torch.zeros(2, dtype=torch.int32))
    applied = fp16.apply_if_finite(True, new, old)
    assert torch.equal(applied['w'], torch.ones(3))
    assert bool(fp16.tree_all_finite(new))
    assert not bool(fp16.tree_all_finite(
        {'a': [torch.ones(2), torch.tensor([1.0, float('inf')])]}))


# ---------------------------------------------------------------------------
# loss_and_grads(loss_scale=)
# ---------------------------------------------------------------------------

def _mse(o):
    return (o.float() ** 2).mean() if isinstance(o, torch.Tensor) else o


@pytest.mark.parametrize('intercept', [True, False])
def test_loss_scale_fp16_matches_jax(intercept):
    """An fp16 MLP under a dynamic scale of 2**10: the port's loss,
    fp32 gradients and fp32 ``g`` captures against JAX's."""
    jk, params, _, tk, _ = _pair(jdtype=jnp.float16,
                                 tdtype=torch.float16)
    x = _x(1)
    scale = 2.0 ** 10
    jl, _, jg, jc, _ = jk.capture.loss_and_grads(
        lambda o: jnp.mean(o.astype(jnp.float32) ** 2), params,
        jnp.asarray(x), loss_scale=jnp.asarray(scale, jnp.float32),
        intercept=intercept)
    tl, out, tg, tc = tk.capture.loss_and_grads(
        lambda o: (o.float() ** 2).mean(), torch.from_numpy(x),
        loss_scale=torch.tensor(scale), intercept=intercept)
    assert out.dtype == torch.float16
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= FP16_TOL * abs(float(jl))
    jgt = convert.flax_to_torch(jax.tree.map(np.asarray, jg))
    for name, g in tg.items():
        assert g.dtype == torch.float32
        assert _rel(g, jgt[name]) <= FP16_TOL, name
    assert bool(tc) == intercept == bool(jc)
    for name in jc:
        for got, want in zip(tc[name]['g'], jc[name]['g']):
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            assert _rel(got, want) <= FP16_TOL, name
        for got, want in zip(tc[name]['a'], jc[name]['a']):
            assert got.dtype == torch.float32 if name == 'd1' \
                else got.dtype == torch.float16
            assert _rel(got.float(), np.asarray(want, np.float32)) \
                <= FP16_TOL


class BNNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.d1 = nn.Linear(6, 8)
        self.bn = nn.BatchNorm1d(8)
        self.d2 = nn.Linear(8, 3)

    def forward(self, x):
        return self.d2(self.bn(self.d1(x)))


def test_loss_scale_is_identity_on_both_paths():
    """fp32 nets: a scale of 2**14 (JAX) or 256 with a BatchNorm (the JAX
    plain-path pin) changes nothing beyond rounding, and the plain path
    unscales as the intercepting one does."""
    torch.manual_seed(0)
    x = torch.from_numpy(_x(2, n=8))
    cap = KFACCapture(MLP())
    loss_fn = lambda o: (o ** 2).mean()  # noqa: E731
    la, _, ga, ca = cap.loss_and_grads(loss_fn, x)
    lb, _, gb, cb = cap.loss_and_grads(loss_fn, x, loss_scale=2.0 ** 14)
    torch.testing.assert_close(lb, la, rtol=1e-6, atol=0)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-7)
    for n in ca:
        for u, v in zip(ca[n]['g'], cb[n]['g']):
            torch.testing.assert_close(v, u, rtol=1e-5, atol=1e-7)
    bn = BNNet()
    cap = KFACCapture(bn)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    res_i = cap.loss_and_grads(loss_fn, x, loss_scale=256.0)
    bn.load_state_dict(state)
    res_p = cap.loss_and_grads(loss_fn, x, loss_scale=256.0,
                               intercept=False)
    torch.testing.assert_close(res_p[0], res_i[0], rtol=1e-6, atol=0)
    for n in res_i[2]:
        torch.testing.assert_close(res_p[2][n], res_i[2][n], rtol=1e-5,
                                   atol=0)
    assert res_p[3] == {}


class RematMLP(MLP):
    """``MLP`` at fp16 with its body rematerialized: the recomputation
    stops after the last saved tensor, ``d2``'s cast weight, inside
    ``d2``'s call."""

    def __init__(self, remat):
        super().__init__(torch.float16)
        self.remat = remat

    def forward(self, x):
        if not self.remat:
            return super().forward(x)
        return checkpoint(super().forward, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              recomputation()))


def test_fp16_remat_recomputation_stopped_inside_a_layer():
    x = torch.from_numpy(_x(7))
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = RematMLP(remat)
        cap = KFACCapture(model)
        _, _, grads, caps = cap.loss_and_grads(
            lambda o: o.float().pow(2).mean(), x, loss_scale=256.0)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(not getattr(m, '_fp32_params', {})
                   for m in model.modules())
        assert cap._inputs == {}
        out[remat] = (grads, caps)
    (g0, c0), (g1, c1) = out[False], out[True]
    assert g0.keys() == g1.keys() == {n for n, _ in MLP().named_parameters()}
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in c0:
        for k in c0[n]:
            assert all(torch.equal(a, b) for a, b in zip(c0[n][k], c1[n][k]))


# ---------------------------------------------------------------------------
# Non-finite captures, the guard and the injector
# ---------------------------------------------------------------------------

def test_factor_update_unpoisoned_by_injected_inf():
    knobs = dict(factor_update_freq=1, inv_update_freq=1, damping=0.01,
                 inverse_method='cholesky')
    jk, params, jstate, tk, tstate = _pair(**knobs)
    x = _x(4)

    def jax_step(state, x):
        _, _, jg, jc, _ = jk.capture.loss_and_grads(
            lambda o: jnp.mean(o ** 2), params, x)
        jc['d1']['g'] = (jc['d1']['g'][0].at[0, 0].set(jnp.inf),)
        jclean, jcount = jfp16.sanitize_captures(jc)
        return jk.step(state, jg, jclean)[1], jcount

    _, _, tg, tc = tk.capture.loss_and_grads(
        lambda o: torch.mean(o ** 2), torch.from_numpy(x))
    g0 = tc['d1']['g'][0].clone()
    g0[0, 0] = float('inf')
    tc['d1']['g'] = (g0,)
    tclean, tcount = fp16.sanitize_captures(tc)
    jstate, jcount = jax.jit(jax_step)(jstate, jnp.asarray(x))
    assert int(tcount) == int(jcount) == 1
    _, tstate = tk.step(tstate, tg, tclean)
    jf = _jax_factors(jstate, tk)
    for n, e in tstate['factors'].items():
        for s, t in e.items():
            assert torch.isfinite(t).all()
            assert _rel(t, jf[n][s]) <= FACTOR_TOL, (n, s)


@pytest.mark.parametrize('grad_accum', [1, 2], ids=['one-pass', 'accum'])
def test_train_step_skips_on_a_non_finite_capture(grad_accum):
    """An inf in one ``a`` capture, the gradients finite: the skip decision
    sees it (``engine._capture_check``), so nothing but the scale state
    and ``kfac_state['step']`` moves; the same step unpoisoned steps."""
    from test_torch_fp16_dist import _digest

    from distributed_kfac_pytorch_tpu_torch.training import engine
    x = torch.from_numpy(_x(5))
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 4, 16))
    out = {}
    for poison in (False, True):
        torch.manual_seed(0)
        model = MLP()
        tk = KFAC(model, device='cpu', factor_update_freq=1,
                  inv_update_freq=1, damping=0.01, inverse_method='cholesky')
        state = engine.TrainState(
            model=model, kfac=tk, kfac_state=tk.init_state(),
            optimizer=torch.optim.SGD(model.parameters(), lr=0.1,
                                      momentum=0.9),
            grad_accum=grad_accum,
            loss_scale=fp16.init_loss_scale(device='cpu'))
        flags = {'factor_update': True, 'inv_update': True}
        hyper = {'lr': 0.1, 'damping': 0.01}
        engine.train_step(state, x, y, hyper, flags)
        before = _digest([dict(model.named_parameters()),
                          state.optimizer.state_dict()['state'],
                          {k: v for k, v in state.kfac_state.items()
                           if k != 'step'}])
        collect = tk.capture.collect

        def poisoned():
            caps = collect()
            a = caps['d1']['a'][0].clone()
            a[0, 0] = float('inf')
            caps['d1']['a'] = (a,)
            return caps

        if poison:
            tk.capture.collect = poisoned
        engine.train_step(state, x, y, hyper, flags)
        after = _digest([dict(model.named_parameters()),
                         state.optimizer.state_dict()['state'],
                         {k: v for k, v in state.kfac_state.items()
                          if k != 'step'}])
        out[poison] = (state.overflow, before == after,
                       float(state.loss_scale['scale']),
                       int(state.kfac_state['step']))
    assert out[False] == (False, False, 2.0 ** 15, 2)
    assert out[True] == (True, True, 2.0 ** 14, 2)


class DWNet(nn.Module):
    """Torch twin of the JAX suite's ``DWNet`` (pointwise, depthwise,
    grouped, head)."""

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


GUARD_CASES = {
    'eager': dict(),
    'deferred': dict(deferred_factor_reduction=True),
    'chunks_fraction': dict(inv_pipeline_chunks=2,
                            factor_batch_fraction=0.5),
    'grouped': dict(),
}


def _guard_nets(case):
    if case == 'grouped':
        from test_grouped_conv import DWNet as JDWNet
        x = np.random.default_rng(5).normal(
            size=(8, 6, 6, 3)).astype(np.float32)
        return JDWNet(), DWNet(), x, lambda a: torch.from_numpy(
            np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return JMLP(), MLP(), _x(5), torch.from_numpy


@pytest.mark.parametrize('case', list(GUARD_CASES))
def test_nonfinite_guard_keeps_factors_as_jax(case):
    """A clean factor step (a window head under deferred reduction), then
    a step on the ``nan-batch``-poisoned batch (under deferred reduction
    it accumulates, and the next head's reduce must skip the window):
    with the guard the factors stay bit for bit on both sides, without it
    the port's go non-finite."""
    knobs = dict(factor_update_freq=1, inv_update_freq=2, factor_decay=0.5,
                 damping=0.01, lr=0.1, kl_clip=None,
                 inverse_method='cholesky', nonfinite_guard=True,
                 **GUARD_CASES[case])
    deferred = knobs.get('deferred_factor_reduction', False)
    jmodel, tmodel, x, to_t = _guard_nets(case)
    bad, = list(faults.poison_at(iter([(x, np.zeros(len(x), np.int32))]),
                                 faults.FaultPlan(nan_batch_at=0)))
    jbad, = list(jfaults.poison_at(iter([(x, np.zeros(len(x), np.int32))]),
                                   jfaults.FaultPlan(nan_batch_at=0)))
    np.testing.assert_array_equal(bad[0], jbad[0])
    jk = JKFAC(jmodel, **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables['params']
    tmodel.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(tmodel, device='cpu', **knobs)
    unguarded = KFAC(tmodel, device='cpu',
                     **{**knobs, 'nonfinite_guard': False})
    tstate = tk.init_state()

    def jax_step(state, batch, flags):
        _, _, jg, jc, _ = jk.capture.loss_and_grads(
            lambda o: jnp.mean(o ** 2), params, batch)
        return jk.step(state, jg, jc, **dict(flags))[1]

    jax_step = jax.jit(jax_step, static_argnums=2)

    def steps(batch, flags):
        nonlocal jstate, tstate
        jstate = jax_step(jstate, jnp.asarray(batch),
                          tuple(sorted(flags.items())))
        _, _, tg, tc = tk.capture.loss_and_grads(
            lambda o: torch.mean(o ** 2), to_t(batch))
        _, tstate = tk.step(tstate, tg, tc, **flags)
        return tg, tc

    head = dict(factor_update=True, inv_update=True)
    if deferred:
        head['factor_reduce'] = True
    steps(x, head)
    jf = _jax_factors(jstate, tk)
    for n, e in tstate['factors'].items():
        for s, t in e.items():
            assert _rel(t, jf[n][s]) <= FACTOR_TOL, (n, s)
    before = {n: {s: t.clone() for s, t in e.items()}
              for n, e in tstate['factors'].items()}
    jbefore = jax.tree.map(np.asarray, jstate['factors'])
    tg, tc = steps(bad[0], dict(factor_update=True, inv_update=False))
    if deferred:
        steps(x, dict(factor_update=False, inv_update=False,
                      factor_reduce=True))
        assert float(tstate['accum_decay']) == 1.0
        assert all(torch.isfinite(t).all() for e in
                   tstate['factor_accum'].values() for t in e.values())
    for n, e in tstate['factors'].items():
        for s, t in e.items():
            assert torch.equal(t, before[n][s]), (n, s)
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jstate['factors']), jbefore)
    if not deferred:
        _, poisoned = unguarded.step(unguarded.init_state(), tg, tc,
                                     factor_update=True, inv_update=False)
        assert not all(torch.isfinite(t).all() for e in
                       poisoned['factors'].values() for t in e.values())


def test_guard_knob_in_repr_and_off_by_default():
    assert KFAC(MLP(), device='cpu').nonfinite_guard is False
    assert 'nonfinite_guard: True' in repr(
        KFAC(MLP(), device='cpu', nonfinite_guard=True))


def test_nan_batch_injector_matches_jax():
    rng = np.random.default_rng(6)
    batches = [(rng.normal(size=(4, 2)).astype(np.float32),
                np.zeros(4, np.int32)) for _ in range(3)]
    plan, jplan = (faults.parse_spec('nan-batch@4'),
                   jfaults.parse_spec('nan-batch@4'))
    faults.check_ported(plan)
    got = list(faults.poison_at(iter(batches), plan, first_step=3))
    want = list(jfaults.poison_at(iter(batches), jplan, first_step=3))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert not np.isfinite(got[1][0]).all()
    assert np.isfinite(got[0][0]).all() and np.isfinite(got[2][0]).all()
    assert np.isfinite(batches[1][0]).all()       # the source is not hit
    assert all(np.isfinite(b[0]).all()
               for b in faults.poison_at(iter(batches), None))
    with pytest.raises(ValueError, match='no float leaf'):
        faults.poison_batch((np.zeros((2, 3), np.int64),))
