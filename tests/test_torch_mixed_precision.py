"""The reduced-precision knobs of the torch port (``factor_dtype``,
``inv_dtype``, ``capture_dtype``, ``precond_compute_dtype`` and the CLIs'
``--bf16-*`` flags) against the JAX package on the CPU: the same seeded
numpy inputs through both, the Pallas kernels in ``interpret=True`` where
the JAX side reaches them, the port's kernels as their plain versions.

Tolerances, and why:

  - bf16 factors are compared in bf16 ulps. The port blends every EMA in
    fp32 and rounds once (K1's fused blend, and the same on its stock and
    distributed paths); the JAX fused path does the same in its kernel
    (its blend is 1 fp32 ulp from the port's), so one factor step from
    the same bf16 state is within 1 ulp of it. The JAX stock and
    distributed paths blend in bf16 arithmetic: the contribution, the
    weights ``decay`` and ``1 - decay`` (0.95 becomes 0.94921875), each
    product and the sum are rounded to bf16, half an ulp of the blend's
    larger term (``decay * old`` or ``(1 - decay) * new``) each: held
    within 3 ulps of that term, elementwise (2.06 seen; where the two
    terms cancel, that is many ulps of the result, so no bound in ulps of
    the result holds there). The JAX fused path sends conv A through that
    stock blend, so its conv A factors are held so too. Over
    5 training steps the ulp gaps compound through the inverses and the
    parameters: each factor is held within 2e-2 of its largest entry.
  - Preconditioning against the fp64 dense oracle: 1e-4 / 1e-4 / 5e-2 of
    each layer's largest entry for ``precond_compute_dtype`` None / fp32
    / bf16 (the JAX suite's own ladder).
  - Port against JAX on the same operands: fp32 paths 1e-5 of the
    largest entry (summation order), bf16-operand paths 1e-2 (both round
    the same values; fp32 noise can move a value across a bf16 rounding
    boundary, one bf16 ulp ~4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.ops import factors as JF
from distributed_kfac_pytorch_tpu.ops import linalg as JL
from distributed_kfac_pytorch_tpu.ops import pallas_kernels as JP
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import EMBEDDING
from distributed_kfac_pytorch_tpu_torch.ops import factors as PF
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.ops import linalg as PL
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from test_torch_mixed_precision_dist import bf16_ulp, ulp_keys

BF16 = {'torch': torch.bfloat16, 'jax': jnp.bfloat16}
FP32 = {'torch': torch.float32, 'jax': jnp.float32}
DTYPES = {None: {'torch': None, 'jax': None}, 'fp32': FP32, 'bf16': BF16}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16, x.dtype
        return convert.tensor_to_array(x)
    a = np.asarray(x)
    assert a.dtype.name == 'bfloat16', a.dtype
    return a.view(np.uint16)


def ulps(got, want) -> int:
    """The largest distance in bf16 ulps between two bf16 tensors or JAX
    arrays."""
    g, w = ulp_keys(_bits(got)), ulp_keys(_bits(want))
    assert g.shape == w.shape
    return int(np.abs(g - w).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Models: torch twins of the JAX suite's (tests/test_mixed_precision.py),
# flax parameter names kept, weights loaded through convert
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """flax names its Denses in construction order: the outer ``Dense(4)``
    is ``Dense_0``."""

    def __init__(self):
        super().__init__()
        self.Dense_1 = nn.Linear(8, 12)
        self.Dense_0 = nn.Linear(12, 4)

    def forward(self, x):
        return self.Dense_0(F.relu(self.Dense_1(x)))


class StraddleEmbedNet(nn.Module):
    """Embedding + four Linears hitting every precondition dispatch branch
    under ``auto_eigen_max_dim=16``: both-eigen, A-eigen/G-inv, both-inv,
    A-inv/G-eigen, plus the diagonal-A embedding."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(24, 8)
        self.l_ee = nn.Linear(8, 8)
        self.l_ei = nn.Linear(8, 24)
        self.l_ii = nn.Linear(24, 24)
        self.l_ie = nn.Linear(24, 6)

    def forward(self, ids):
        x = self.emb(ids).mean(dim=1)
        x = F.relu(self.l_ee(x))
        x = F.relu(self.l_ei(x))
        x = F.relu(self.l_ii(x))
        return self.l_ie(x)


def _jax_models():
    from test_mixed_precision import MLP as JMLP
    from test_mixed_precision import StraddleEmbedNet as JStraddle
    return JMLP(), JStraddle()


def _mlp_data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(16, 8)).astype(np.float32),
            rng.integers(0, 4, size=16))


def _embed_data():
    rng = np.random.default_rng(1)
    return rng.integers(0, 24, size=(32, 5)), rng.integers(0, 6, size=32)


def _xent_jax(y):
    return lambda out: optax.softmax_cross_entropy_with_integer_labels(
        out, jnp.asarray(y)).mean()


def _knobs(side: str, **names) -> dict:
    """KFAC dtype knobs for one framework from their names (None, 'fp32',
    'bf16')."""
    return {k: DTYPES[v][side] for k, v in names.items()}


def _one_step(jmodel, tmodel, x, y, **kw):
    """One factor + inverse + precondition step of the JAX ``KFAC`` and
    the port's on the same weights and batch. ``kw``: shared knobs, dtype
    knobs by name. Returns ``(port kfac, port grads, port precond, port
    state, jax precond as torch tensors, jax state)``."""
    dtype_keys = ('factor_dtype', 'factor_compute_dtype', 'inv_dtype',
                  'capture_dtype', 'precond_compute_dtype')
    names = {k: kw.pop(k) for k in dtype_keys if k in kw}
    jk = JKFAC(jmodel, **kw, **_knobs('jax', **names))
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables['params']
    _, _, jgrads, jcaps, _ = jk.capture.loss_and_grads(
        _xent_jax(y), params, jnp.asarray(x))
    jprecond, jstate = jax.jit(lambda s, g, c: jk.step(
        s, g, c, factor_update=True, inv_update=True))(jstate, jgrads, jcaps)
    tmodel.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(tmodel, device='cpu', **kw, **_knobs('torch', **names))
    state = tk.init_state()
    yt = torch.from_numpy(y)
    _, _, grads, caps = tk.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, yt), torch.from_numpy(x))
    precond, state = tk.step(state, grads, caps, factor_update=True,
                             inv_update=True)
    jp = convert.flax_to_torch(jax.tree.map(np.asarray, jprecond))
    return tk, grads, precond, state, jp, jstate


STEP_KW = dict(factor_update_freq=1, inv_update_freq=1, damping=0.01)


# ---------------------------------------------------------------------------
# KFAC: the JAX suite's cases (tests/test_mixed_precision.py)
# ---------------------------------------------------------------------------

def test_bf16_factor_storage_fp32_decomposition():
    """Counterpart of JAX ``test_bf16_factor_storage_fp32_decomposition``:
    bf16 factors, fp32 inverses, finite preconditioned gradients; the
    factors within 2 ulps of the JAX step (its stock blend) and the
    gradients within 1e-2 of the largest JAX entry (both decompose the
    same bf16 factors in fp32: a 1-ulp factor gap moves them ~1e-3)."""
    x, y = _mlp_data()
    jmodel = _jax_models()[0]
    tk, _, precond, state, jp, jstate = _one_step(
        jmodel, MLP(), x, y, factor_dtype='bf16', **STEP_KW)
    assert all(t.dtype == torch.bfloat16
               for f in state['factors'].values() for t in f.values())
    assert all(t.dtype == torch.float32
               for e in state['inverses'].values() for t in e.values())
    jf = convert.jax_factors_to_torch(
        jax.tree.map(np.asarray, jstate['factors']), tk.specs)
    for name, f in state['factors'].items():
        for side, t in f.items():
            assert ulps(t, jf[name][side]) <= 2, (name, side)
    for key, t in precond.items():
        assert torch.isfinite(t).all()
        assert _rel(_np(t), _np(jp[key])) <= 1e-2, key


def test_bf16_factor_compute_close_to_fp32():
    """Counterpart of JAX ``test_bf16_factor_compute_close_to_fp32``: bf16
    covariance multiplicands keep fp32 factors, within 2e-2 of the fp32
    ones and not equal to them; the port's bf16-multiplicand factors
    within 1e-3 of the JAX ones: both round activations that each
    framework computed to fp32 noise, so a value at a rounding boundary
    can land one bf16 ulp (2^-8 of itself) apart in one product (5e-5
    seen)."""
    x, y = _mlp_data()
    jmodel = _jax_models()[0]
    runs = {}
    for cdt in (None, 'bf16'):
        tk, _, _, state, _, jstate = _one_step(
            jmodel, MLP(), x, y, factor_compute_dtype=cdt, **STEP_KW)
        runs[cdt] = (state['factors'], convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, jstate['factors']), tk.specs))
    changed = False
    for name in runs[None][0]:
        for side in 'AG':
            f32, b16 = runs[None][0][name][side], runs['bf16'][0][name][side]
            assert b16.dtype == torch.float32
            np.testing.assert_allclose(_np(b16), _np(f32), rtol=2e-2,
                                       atol=2e-2)
            changed |= not torch.allclose(b16, f32, rtol=1e-6, atol=1e-7)
            assert _rel(_np(b16), _np(runs['bf16'][1][name][side])) <= 1e-3
    assert changed


def _oracle_mats(kfac, state, grads, damping):
    """fp64 dense-oracle preconditioned matrices per layer, from the
    post-step factors (the JAX suite's ``_oracle_mats``)."""
    want = {}
    for name, spec in kfac.specs.items():
        grad = _np(L.grads_to_matrix(spec, kfac._layer_params(name, grads))
                   ).astype(np.float64)
        a = _np(state['factors'][name]['A']).astype(np.float64)
        g = _np(state['factors'][name]['G']).astype(np.float64)
        g_inv = np.linalg.inv(g + damping * np.eye(g.shape[0]))
        if spec.kind == EMBEDDING:
            want[name] = (1.0 / (a + damping))[:, None] * (grad @ g_inv)
            continue
        if (kfac.method_for_dim(a.shape[0]) == 'eigen'
                and kfac.method_for_dim(g.shape[0]) == 'eigen'):
            da, qa = np.linalg.eigh(a)
            dg, qg = np.linalg.eigh(g)
            v = (qg.T @ grad @ qa) / (dg[:, None] * da[None, :] + damping)
            want[name] = qg @ v @ qa.T
        else:
            a_inv = np.linalg.inv(a + damping * np.eye(a.shape[0]))
            want[name] = g_inv @ grad @ a_inv
    return want


def _straddle_step(cdt, method, inv_dtype='fp32'):
    ids, y = _embed_data()
    return _one_step(_jax_models()[1], StraddleEmbedNet(), ids, y,
                     precond_compute_dtype=cdt, inv_dtype=inv_dtype,
                     inverse_method=method, auto_eigen_max_dim=16,
                     kl_clip=None, eigh_method='xla', lr=0.1,
                     **STEP_KW)


LADDER_TOL = {None: 1e-4, 'fp32': 1e-4, 'bf16': 5e-2}
JAX_TOL = {None: 1e-5, 'fp32': 1e-5, 'bf16': 1e-2}


@pytest.mark.parametrize('cdt', [None, 'fp32', 'bf16'])
@pytest.mark.parametrize('method', ['auto', 'cholesky'])
def test_dtype_ladder_vs_dense_oracle(method, cdt):
    """Counterpart of JAX ``test_dtype_ladder_vs_dense_oracle`` over every
    dispatch branch (embeddings included): each layer against the fp64
    oracle at the ladder's tolerance, and against the JAX step at
    ``JAX_TOL``. The bf16 operands really change the bits."""
    tk, grads, precond, state, jp, _ = _straddle_step(cdt, method)
    if method == 'auto':
        kinds = {n: tuple(k for k in e) for n, e in state['inverses'].items()}
        assert set(kinds['l_ee']) == {'QA', 'dA', 'QG', 'dG'}
        assert {'A_inv', 'G_inv'} <= set(kinds['l_ei'])
        assert set(kinds['emb']) == {'A_inv', 'QG', 'dG'}
    want = _oracle_mats(tk, state, grads, 0.01)
    for name, spec in tk.specs.items():
        got = _np(L.grads_to_matrix(spec, tk._layer_params(name, precond)))
        ref = _np(L.grads_to_matrix(spec, tk._layer_params(name, jp)))
        assert _rel(got, want[name]) <= LADDER_TOL[cdt], name
        assert _rel(got, ref) <= JAX_TOL[cdt], name
    if cdt == 'bf16':
        _, _, base, _, _, _ = _straddle_step(None, method)
        assert any(not torch.equal(precond[k], base[k]) for k in precond)


def test_bf16_resident_inverses_consumed_without_upcast():
    """Counterpart of JAX
    ``test_bf16_resident_inverses_consumed_without_upcast``: bf16 inverses
    read by bf16 operands track the widened read to 5e-2, and the port's
    resident step tracks the JAX one to 1e-2."""
    _, _, base, state, _, _ = _straddle_step(None, 'auto', 'bf16')
    assert all(t.dtype == torch.bfloat16
               for e in state['inverses'].values() for t in e.values())
    _, _, resident, _, jp, _ = _straddle_step('bf16', 'auto', 'bf16')
    for key, t in resident.items():
        assert torch.isfinite(t).all()
        assert _rel(_np(t), _np(base[key])) <= 5e-2, key
        assert _rel(_np(t), _np(jp[key])) <= 1e-2, key


def test_repr_lists_the_knobs():
    kfac = KFAC(MLP(), device='cpu', factor_dtype=torch.bfloat16,
                inv_dtype=torch.bfloat16,
                precond_compute_dtype=torch.bfloat16)
    text = repr(kfac)
    for knob in ('factor_dtype: torch.bfloat16', 'inv_dtype: torch.bfloat16',
                 "capture_dtype: 'auto'",
                 'precond_compute_dtype: torch.bfloat16',
                 'registered_layers: 2'):
        assert knob in text


@pytest.mark.parametrize('knob,value', [
    ('factor_dtype', torch.float16), ('factor_dtype', 'bf16'),
    ('inv_dtype', torch.float64), ('capture_dtype', torch.float16),
    ('capture_dtype', 'bf16'), ('precond_compute_dtype', torch.float16),
    ('factor_compute_dtype', torch.float64)])
def test_bad_dtype_raises_by_name(knob, value):
    with pytest.raises(ValueError, match=knob):
        KFAC(MLP(), device='cpu', **{knob: value})


def test_bf16_state_dict_round_trip():
    """``state_dict`` / ``load_state_dict`` keep bf16 factors and inverses
    bit for bit; an fp32 checkpoint loads into the bf16 storage dtype."""
    x, y = _mlp_data()
    tk, _, _, state, _, _ = _one_step(
        _jax_models()[0], MLP(), x, y, factor_dtype='bf16',
        inv_dtype='bf16', **STEP_KW)
    loaded = tk.load_state_dict(tk.state_dict(state, include_inverses=True))
    for part in ('factors', 'inverses'):
        for name, e in state[part].items():
            for k, t in e.items():
                assert loaded[part][name][k].dtype == torch.bfloat16
                assert torch.equal(loaded[part][name][k], t)
    wide = {'step': 1, 'factors': {n: {k: t.float() for k, t in f.items()}
                                   for n, f in state['factors'].items()}}
    rebuilt = tk.load_state_dict(wide)
    assert all(t.dtype == torch.bfloat16
               for f in rebuilt['factors'].values() for t in f.values())
    assert all(t.dtype == torch.bfloat16
               for e in rebuilt['inverses'].values() for t in e.values())


# ---------------------------------------------------------------------------
# ops.linalg: the compute_dtype branches, slots stored fp32 or bf16
# ---------------------------------------------------------------------------

def _orth(rng, n):
    return np.linalg.qr(rng.normal(size=(n, n)))[0].astype(np.float32)


def _spd(rng, n):
    m = rng.normal(size=(n, n))
    return (m @ m.T / n + 0.1 * np.eye(n)).astype(np.float32)


def _slots(store: str, **arrays):
    """``(torch, jax)`` dicts of the same slots stored in ``store``
    ('fp32' or 'bf16'; the JAX side rounds, the port converts its
    pattern)."""
    jx = {k: jnp.asarray(v).astype(DTYPES[store]['jax'])
          for k, v in arrays.items()}
    tx = {k: convert.array_to_tensor(np.asarray(v)) for k, v in jx.items()}
    return tx, jx


@pytest.mark.parametrize('store', ['fp32', 'bf16'])
@pytest.mark.parametrize('cdt', [None, 'fp32', 'bf16'])
@pytest.mark.parametrize('branch', ['eigen', 'inv', 'diag_inv',
                                    'diag_eigen'])
def test_precondition_branches_match_jax(branch, cdt, store):
    """Each branch of ``precondition_dispatch`` on the same gradient and
    stored slots: fp32 operands at 1e-5 of the largest JAX entry, bf16
    operands at 1e-2 (the same values rounded at the same points). The
    result is fp32 always.

    One deliberate delta: under ``compute_dtype=None`` with bf16-stored
    eigenvalues the port forms the damping quotient ``dG dA^T + l`` in
    fp32 from the stored values, while JAX's type promotion forms it in
    bf16 (a relative error up to 2^-9 per entry, 3.6e-3 of the largest
    entry seen): held at 1e-2 there."""
    rng = np.random.default_rng(7)
    g_dim, a_dim = 6, 10
    grad = rng.normal(size=(a_dim if branch.startswith('diag') else g_dim,
                            g_dim if branch.startswith('diag') else a_dim)
                      ).astype(np.float32)
    if branch == 'eigen':
        tx, jx = _slots(store, QA=_orth(rng, a_dim), QG=_orth(rng, g_dim),
                        dA=rng.uniform(0.1, 2, a_dim),
                        dG=rng.uniform(0.1, 2, g_dim))
        diag = None
    elif branch == 'inv':
        tx, jx = _slots(store, A_inv=_spd(rng, a_dim),
                        G_inv=_spd(rng, g_dim))
        diag = None
    elif branch == 'diag_inv':
        tx, jx = _slots(store, G_inv=_spd(rng, g_dim),
                        diag=rng.uniform(0.5, 2, a_dim))
        diag = 'diag'
    else:
        tx, jx = _slots(store, QG=_orth(rng, g_dim),
                        dG=rng.uniform(0.1, 2, g_dim),
                        diag=rng.uniform(0.5, 2, a_dim))
        diag = 'diag'
    t_diag = tx.pop('diag') if diag else None
    j_diag = jx.pop('diag') if diag else None
    got = PL.precondition_dispatch(torch.from_numpy(grad), tx, 0.003,
                                   diag_a=t_diag,
                                   compute_dtype=DTYPES[cdt]['torch'])
    ref = JL.precondition_dispatch(jnp.asarray(grad), jx, 0.003,
                                   diag_a=j_diag,
                                   compute_dtype=DTYPES[cdt]['jax'])
    assert got.dtype == torch.float32
    bf16_quotient = (cdt is None and store == 'bf16'
                     and branch in ('eigen', 'diag_eigen'))
    assert _rel(_np(got), np.asarray(ref, np.float32)) <= (
        1e-2 if cdt == 'bf16' or bf16_quotient else 1e-5)


def test_precondition_default_path_is_unchanged():
    """``compute_dtype=None`` on fp32 slots is the fp32 formula as it was,
    bit for bit: ``QG ((QG^T g QA) / (dG dA^T + l)) QA^T`` and ``G_inv g
    A_inv`` in their left-to-right association."""
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(6, 10)).astype(np.float32))
    qa, qg = (torch.from_numpy(_orth(rng, n)) for n in (10, 6))
    da, dg = (torch.from_numpy(rng.uniform(0.1, 2, n).astype(np.float32))
              for n in (10, 6))
    v = (qg.mT @ g @ qa) / (dg[:, None] * da[None, :] + 0.003)
    assert torch.equal(PL.precondition_eigen(g, qa, qg, da, dg, 0.003),
                       qg @ v @ qa.mT)
    a_inv, g_inv = (torch.from_numpy(_spd(rng, n)) for n in (10, 6))
    assert torch.equal(PL.precondition_inv(g, a_inv, g_inv),
                       g_inv @ g @ a_inv)


def test_bf16_operands_round_like_bf16_matmul_with_fp32_sums():
    """The bf16 mode rounds operands to bf16 and multiplies them in fp32:
    equal to an fp64 product of the rounded operands to fp32 sum noise,
    and not a bf16-output product."""
    rng = np.random.default_rng(9)
    g = rng.normal(size=(16, 32)).astype(np.float32)
    a_inv, g_inv = _spd(rng, 32), _spd(rng, 16)
    got = PL.precondition_inv(torch.from_numpy(g), torch.from_numpy(a_inv),
                              torch.from_numpy(g_inv),
                              compute_dtype=torch.bfloat16)
    # The JAX association G_inv (g A_inv); the inner product stays fp32.
    r = lambda m: _np(torch.from_numpy(m).bfloat16()).astype(  # noqa: E731
        np.float64)
    want = r(g_inv) @ (r(g) @ r(a_inv))
    assert _rel(_np(got), want) <= 1e-6
    wide = PL.precondition_inv(torch.from_numpy(g), torch.from_numpy(a_inv),
                               torch.from_numpy(g_inv))
    assert _rel(_np(wide), want) > 1e-4


# ---------------------------------------------------------------------------
# Kernels' plain versions with bf16 inputs
# ---------------------------------------------------------------------------

K1_CASES = {
    # (x shape, has_bias, scale, bf16 multiplicands)
    'dense_bias': ((40, 12), True, None, False),
    'dense_bf16_mult': ((40, 12), False, None, True),
    'conv_g_nchw': ((4, 8, 5, 5), False, 4 * 25 * 25.0 ** 2, False),
    'conv_g_bf16_mult': ((4, 8, 5, 5), False, 4 * 25 * 25.0 ** 2, True),
}


def _k1_inputs(case, seed=11):
    shape, bias, scale, bf16 = K1_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    n = (shape[1] if len(shape) == 2 else shape[1]) + int(bias)
    m = rng.normal(size=(n, n)) * 0.05
    old = (np.eye(n) * 0.7 + m + m.T).astype(np.float32)
    return x, torch.from_numpy(old).bfloat16(), bias, scale, bf16


@pytest.mark.parametrize('case', list(K1_CASES))
def test_k1_bf16_storage_is_the_rounded_fp32_blend(case):
    """K1 in bf16-storage mode (its plain version and the wrapper on the
    CPU) equals the widen, fp32 blend, round sequence bit for bit, and
    ``kernels.ema_blend`` of the contraction gives the same bits."""
    x, old, bias, scale, bf16 = _k1_inputs(case)
    xt = torch.from_numpy(x)
    cdt = torch.bfloat16 if bf16 else None
    got = kernels.factor_ema(xt, old, 0.95, scale=scale, has_bias=bias,
                             compute_dtype=cdt)
    assert got.dtype == torch.bfloat16
    wide = kernels.factor_ema(xt, old.float(), 0.95, scale=scale,
                              has_bias=bias, compute_dtype=cdt)
    assert torch.equal(got, wide.bfloat16())
    assert torch.equal(got, kernels.factor_ema_plain(
        xt, old, 0.95, scale=scale, has_bias=bias, bf16=bf16))
    contrib = kernels.factor_ema(xt, None, 0.0, scale=scale, has_bias=bias,
                                 compute_dtype=cdt)
    assert torch.equal(kernels.ema_blend(old, contrib, 0.95), got)
    assert torch.equal(PF.update_running_avg(contrib, old, 0.95), got)


@pytest.mark.parametrize('case', list(K1_CASES))
def test_k1_bf16_storage_vs_pallas_interpret(case):
    """Against the JAX fused path's blend (the Pallas kernel on the widened
    factor, then ``.astype(bf16)``): within 1 bf16 ulp (the two fp32 blends
    part by at most 1 fp32 ulp before the rounding)."""
    x, old, bias, scale, bf16 = _k1_inputs(case)
    if x.ndim == 4:
        jx = jnp.asarray(x.transpose(0, 2, 3, 1).reshape(-1, x.shape[1]))
    else:
        jx = jnp.asarray(x)
    jold = jnp.asarray(convert.tensor_to_array(old, jnp.bfloat16))
    ref = JP.fused_factor_ema(
        jx, jold.astype(jnp.float32), 0.95, scale=scale, has_bias=bias,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
        interpret=True).astype(jnp.bfloat16)
    got = kernels.factor_ema(torch.from_numpy(x), old, 0.95, scale=scale,
                             has_bias=bias,
                             compute_dtype=torch.bfloat16 if bf16 else None)
    assert ulps(got, ref) <= 1


def test_k1_k2_widen_bf16_captures():
    """A bf16 capture is read widened: K1 and K2 (plain, on the CPU) give
    what they give for its fp32 copy, and match the JAX stock factors of
    the same bf16 capture at 1e-5."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.normal(size=(24, 10)).astype(np.float32)
                         ).bfloat16()
    got = kernels.factor_ema(a, None, 0.0, has_bias=True)
    assert torch.equal(got, kernels.factor_ema(a.float(), None, 0.0,
                                               has_bias=True))
    ja = jnp.asarray(convert.tensor_to_array(a, jnp.bfloat16))
    assert _rel(_np(got), JF.linear_a_factor(ja, True)) <= 1e-5
    x = torch.from_numpy(rng.normal(size=(2, 3, 6, 6)).astype(np.float32)
                         ).bfloat16()
    got = kernels.patch_cov(x, (3, 3), (1, 1), 1, True)
    assert torch.equal(got, kernels.patch_cov(x.float(), (3, 3), (1, 1), 1,
                                              True))
    jxn = jnp.asarray(convert.tensor_to_array(x.permute(0, 2, 3, 1),
                                              jnp.bfloat16))
    ref = np.asarray(JF.conv2d_a_factor(jxn, (3, 3), (1, 1), 1, True,
                                        compute_dtype=jnp.float32))
    p = convert.conv_a_perm((3, 3), 3, True)
    assert _rel(_np(got), ref[p][:, p]) <= 1e-5


@pytest.mark.parametrize('kind', ['linear_a', 'linear_g', 'conv_a',
                                  'conv_g'])
def test_kfac_reduce_of_bf16_captures(kind):
    """KFAC-reduce statistics of bf16 captures: the port reduces the
    widened values over the shared axes in fp32, as JAX's ones-row matmul
    accumulates them (``preferred_element_type=float32``): within 1e-5 of
    the JAX factors (summation order), and equal to the reduce of the
    fp32 copy bit for bit."""
    rng = np.random.default_rng(13)
    if kind.startswith('linear'):
        x = torch.from_numpy(rng.normal(size=(4, 7, 6)).astype(np.float32)
                             ).bfloat16()
        jx = jnp.asarray(convert.tensor_to_array(x, jnp.bfloat16))
        if kind == 'linear_a':
            got = PF.linear_a_factor_reduced(x, True)
            wide = PF.linear_a_factor_reduced(x.float(), True)
            ref = JF.linear_a_factor_reduced(jx, True)
        else:
            got = PF.linear_g_factor_reduced(x)
            wide = PF.linear_g_factor_reduced(x.float())
            ref = JF.linear_g_factor_reduced(jx)
    else:
        x = torch.from_numpy(rng.normal(size=(3, 4, 8, 8)).astype(
            np.float32)).bfloat16()
        jx = jnp.asarray(convert.tensor_to_array(x.permute(0, 2, 3, 1),
                                                 jnp.bfloat16))
        if kind == 'conv_a':
            got = PF.conv2d_a_factor_reduced(x, (4, 4), (4, 4), 'VALID',
                                             True)
            wide = PF.conv2d_a_factor_reduced(x.float(), (4, 4), (4, 4),
                                              'VALID', True)
            ref = JF.conv2d_a_factor_reduced(jx, (4, 4), (4, 4), 'VALID',
                                             True)
            p = convert.conv_a_perm((4, 4), 4, True)
            ref = np.asarray(ref)[p][:, p]
        else:
            got = PF.conv2d_g_factor_reduced(x)
            wide = PF.conv2d_g_factor_reduced(x.float())
            ref = JF.conv2d_g_factor_reduced(jx)
    assert got.dtype == torch.float32
    assert torch.equal(got, wide)
    assert _rel(_np(got), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize('eigen', [True, False], ids=['eigen', 'baked'])
@pytest.mark.parametrize('cdt', [None, 'bf16'])
def test_k3_reads_bf16_stacks_widened(cdt, eigen):
    """K3's plain version (and its wrapper on the CPU) fed bf16 stacks:
    what it gives for their widened copies, bit for bit, and the JAX
    Pallas kernel on the same bf16 stacks at the phase-3 tolerances (fp32
    1e-5, bf16 multiplicands 1e-2)."""
    rng = np.random.default_rng(14)
    s, g_dim, a_dim = 3, 9, 13
    g = rng.normal(size=(s, g_dim, a_dim)).astype(np.float32)
    if eigen:
        arrays = dict(QA=np.stack([_orth(rng, a_dim) for _ in range(s)]),
                      QG=np.stack([_orth(rng, g_dim) for _ in range(s)]),
                      dA=rng.uniform(0.1, 2, (s, a_dim)),
                      dG=rng.uniform(0.1, 2, (s, g_dim)))
    else:
        arrays = dict(A_inv=np.stack([_spd(rng, a_dim) for _ in range(s)]),
                      G_inv=np.stack([_spd(rng, g_dim) for _ in range(s)]))
    tx, jx = _slots('bf16', **arrays)
    tcdt = DTYPES[cdt]['torch']
    v, vg = kernels.bucket_precond(torch.from_numpy(g), tx, 0.003,
                                   compute_dtype=tcdt)
    v32, vg32 = kernels.bucket_precond(
        torch.from_numpy(g), {k: t.float() for k, t in tx.items()}, 0.003,
        compute_dtype=tcdt)
    assert torch.equal(v, v32) and torch.equal(vg, vg32)
    v_ref, vg_ref = JP.fused_bucket_precondition(
        jnp.asarray(g), jx, 0.003, compute_dtype=DTYPES[cdt]['jax'],
        interpret=True)
    tol = 1e-2 if cdt == 'bf16' else 1e-5
    assert _rel(_np(v), v_ref) <= tol
    assert _rel(_np(vg), vg_ref) <= tol


# ---------------------------------------------------------------------------
# capture_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['auto', None, 'bf16'])
def test_capture_dtype(mode):
    """``'auto'`` and None pass captures through (the JAX package casts
    under ``'auto'`` on a TPU only); an explicit dtype casts every
    floating ``a`` capture and never an output-grad or an embedding's
    ids. The port's bf16 captures are the JAX ones to 1 bf16 ulp (each
    rounds activations its framework computed to fp32 noise)."""
    ids, y = _embed_data()
    jk = JKFAC(_jax_models()[1],
               capture_dtype=mode if mode != 'bf16' else jnp.bfloat16)
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    _, _, _, jcaps, _ = jk.capture.loss_and_grads(
        _xent_jax(y), variables['params'], jnp.asarray(ids))
    model = StraddleEmbedNet()
    model.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, variables['params'])))
    tk = KFAC(model, device='cpu',
              capture_dtype=mode if mode != 'bf16' else torch.bfloat16)
    yt = torch.from_numpy(y)
    _, _, _, caps = tk.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, yt), torch.from_numpy(ids))
    want = torch.bfloat16 if mode == 'bf16' else torch.float32
    for name, entry in caps.items():
        (a,), (g,) = entry['a'], entry['g']
        assert g.dtype == torch.float32
        if tk.specs[name].kind == EMBEDDING:
            assert a.dtype == torch.int64
            continue
        assert a.dtype == want
        ja = jcaps[name]['a'][0]
        if mode == 'bf16':
            assert ulps(a, ja) <= 1, name
        else:
            assert _rel(_np(a), np.asarray(ja)) <= 1e-6, name


def test_capture_dtype_auto_resolves_under_strict_fp32_factors():
    """``'auto'`` with a factor compute dtype wider than bf16 resolves to
    None, as in JAX (``preconditioner.py:510-518``)."""
    model = _jax_models()[0]
    jk = JKFAC(model, factor_compute_dtype=jnp.float32)
    jk.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)))
    tk = KFAC(MLP(), device='cpu', factor_compute_dtype=torch.float32)
    assert jk.capture.capture_dtype is None
    assert tk.capture_dtype is None and tk.capture.capture_dtype is None
    tk = KFAC(MLP(), device='cpu', factor_compute_dtype=torch.bfloat16)
    assert tk.capture_dtype == 'auto'


# ---------------------------------------------------------------------------
# convert: bf16 JAX factor and inverse state, both ways
# ---------------------------------------------------------------------------

def _jax_resnet_state(method):
    """A CIFAR ResNet (1, 1, 1) JAX K-FAC state after one step with bf16
    factors and bf16 inverses, ``inverse_method`` ``method``."""
    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(4, 8, 8, 3)).astype(np.float32))
    y = rng.integers(0, 10, size=4)
    jk = JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1)),
               factor_dtype=jnp.bfloat16, inv_dtype=jnp.bfloat16,
               inverse_method=method, eigh_method='xla',
               factor_update_freq=1, inv_update_freq=1)
    variables, state = jk.init(jax.random.PRNGKey(0), x)
    _, _, grads, caps, _ = jk.capture.loss_and_grads(
        _xent_jax(y), variables['params'], x,
        extra_vars={'batch_stats': variables['batch_stats']},
        mutable_cols=('batch_stats',))
    _, state = jax.jit(lambda s, g, c: jk.step(
        s, g, c, factor_update=True, inv_update=True))(state, grads, caps)
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize('method', ['eigen', 'cholesky'])
def test_convert_bf16_state_both_ways(method, resnet_bf16):
    """bf16 JAX factors and inverses (eigen slots; baked inverses) cross to
    the port and back bit for bit; a conv A factor, baked A inverse and
    eigenbasis rows land in the ``(c, kh, kw)`` basis; the result loads
    into a bf16 port ``KFAC`` as it is. The eigen state is the five-step
    run's after step 0 with its inverses cast to bf16, which is what the
    JAX ``inv_dtype=bfloat16`` stores (it decomposes in fp32 and casts)."""
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
    if method == 'eigen':
        state = resnet_bf16['jax'][0]['state']
        state = {**state, 'inverses': jax.tree.map(
            lambda t: np.asarray(jnp.asarray(t).astype(jnp.bfloat16)),
            state['inverses'])}
    else:
        state = _jax_resnet_state(method)
    model = cifar_resnet.CifarResNet((1, 1, 1))
    tk = KFAC(model, device='cpu', factor_dtype=torch.bfloat16,
              inv_dtype=torch.bfloat16, inverse_method=method)
    factors = convert.jax_factors_to_torch(state['factors'], tk.specs)
    inverses = convert.jax_inverses_to_torch(state['inverses'], tk.specs)
    conv = next(n for n, s in tk.specs.items() if s.kind == 'conv2d')
    jconv = conv.replace('.', '/')
    spec = tk.specs[conv]
    a = state['factors'][jconv]['A'].view(np.uint16)
    p = convert.conv_a_perm(spec.kernel_size, 3, spec.has_bias)
    assert np.array_equal(convert.tensor_to_array(factors[conv]['A']),
                          a[p][:, p])
    slot = 'QA' if 'QA' in inverses[conv] else 'A_inv'
    jslot = state['inverses'][jconv][slot].view(np.uint16)
    assert np.array_equal(convert.tensor_to_array(inverses[conv][slot]),
                          jslot[p] if slot == 'QA' else jslot[p][:, p])
    for tree in (factors, inverses):
        for e in tree.values():
            assert all(t.dtype == torch.bfloat16 for t in e.values())
    for conv_fn, back_fn, tree, key in (
            (factors, convert.torch_factors_to_jax, state['factors'],
             'factors'),
            (inverses, convert.torch_inverses_to_jax, state['inverses'],
             'inverses')):
        back = back_fn(conv_fn, tk.specs, bfloat16=jnp.bfloat16)
        assert set(back) == set(tree)
        for name, e in tree.items():
            for k, v in e.items():
                assert back[name][k].dtype == v.dtype
                assert np.array_equal(back[name][k].view(np.uint16),
                                      v.view(np.uint16)), (key, name, k)
    loaded = tk.load_state_dict({'step': 1, 'factors': factors,
                                 'inverses': inverses})
    for name, e in inverses.items():
        for k, t in e.items():
            assert torch.equal(loaded['inverses'][name][k], t)


# ---------------------------------------------------------------------------
# bf16 factors through K-FAC training steps: a CIFAR ResNet (1, 1, 1),
# against the JAX fused path (Pallas in interpret mode) and stock path
# ---------------------------------------------------------------------------

R_BATCH, R_STEPS, R_LR = 8, 5, 0.1
R_HYPER = dict(damping=0.003, lr=R_LR, kl_clip=0.001, factor_update_freq=1,
               inv_update_freq=2, eigh_method='xla')


def _resnet_batches():
    rng = np.random.default_rng(5)
    return [(rng.normal(size=(R_BATCH, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 10, size=R_BATCH)) for _ in range(R_STEPS)]


def _jax_resnet_kfac(fused: bool):
    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    return JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1)),
                 fused_factor_contraction=fused, fused_precondition=fused,
                 factor_dtype=jnp.bfloat16,
                 factor_compute_dtype=jnp.bfloat16, **R_HYPER)


def _jax_caps(jk, params, extra, x, y):
    return jk.capture.loss_and_grads(
        _xent_jax(y), params, jnp.asarray(x), extra_vars=extra,
        mutable_cols=('batch_stats',))


def _torch_resnet(variables):
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
    model = cifar_resnet.CifarResNet((1, 1, 1))
    model.load_state_dict(convert.flax_to_torch(variables['params'],
                                                variables['batch_stats']))
    kfac = KFAC(model, device='cpu', factor_dtype=torch.bfloat16,
                factor_compute_dtype=torch.bfloat16, **R_HYPER)
    return model, kfac


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope='module')
def resnet_bf16():
    """The JAX fused path's 5 steps (SGD, factors every step, inverses
    every 2nd) with the initial variables, the state after step 0 and
    each step's bf16 factors; the port's 5 steps on the same weights and
    batches."""
    batches = _resnet_batches()
    jk = _jax_resnet_kfac(True)
    variables, kstate = jk.init(jax.random.PRNGKey(0),
                                jnp.asarray(batches[0][0]))
    init = jax.tree.map(np.asarray, variables)
    params, extra = variables['params'], {
        'batch_stats': variables['batch_stats']}

    def step_fn(params, kstate, extra, x, y, inv_update):
        loss, _, grads, caps, upd = _jax_caps(jk, params, extra, x, y)
        precond, kstate = jk.step(kstate, grads, caps, factor_update=True,
                                  inv_update=inv_update)
        params = jax.tree.map(lambda p, g: p - R_LR * g, params, precond)
        return loss, params, kstate, {**extra, **upd}

    jstep = jax.jit(step_fn, static_argnames=('inv_update',))
    jrec = []
    for i, (x, y) in enumerate(batches):
        loss, params, kstate, extra = jstep(
            params, kstate, extra, jnp.asarray(x), jnp.asarray(y),
            inv_update=i % 2 == 0)
        jrec.append({'loss': float(loss), 'state': jax.tree.map(
            np.asarray, kstate)})
    model, kfac = _torch_resnet(init)
    opt = torch.optim.SGD(model.parameters(), lr=R_LR)
    state = kfac.init_state()
    trec = []
    for i, (x, y) in enumerate(batches):
        yt = torch.from_numpy(y)
        loss, _, grads, caps = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, yt), _nchw(x))
        precond, state = kfac.step(state, grads, caps, factor_update=True,
                                   inv_update=i % 2 == 0)
        for name, p in model.named_parameters():
            p.grad = precond[name]
        opt.step()
        trec.append({'loss': float(loss), 'factors': state['factors'],
                     'inverses': state['inverses']})
    return {'init': init, 'batches': batches, 'jax': jrec, 'port': trec,
            'specs': kfac.specs}


def _exact_captures(jcaps, seed=6):
    """Captures shaped as ``jcaps`` (JAX layout, NHWC) whose covariances
    are exact in fp32 whatever the summation order: multiples of 1/8 in
    [-4, 4] (exact in bf16 too), over power-of-two row counts, so both
    frameworks' contributions are the same bits and a factor step tests
    the EMA's rounding alone."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, entry in jcaps.items():
        out[name] = {k: tuple(
            (rng.integers(-32, 33, size=np.shape(v)) / 8.0).astype(
                np.float32) for v in calls) for k, calls in entry.items()}
    return out


def _to_port_captures(caps, specs):
    """JAX-layout captures as the port's (conv tensors NCHW)."""
    out = {}
    for name, entry in caps.items():
        conv = specs[name.replace('/', '.')].kind == 'conv2d'
        out[name.replace('/', '.')] = {k: tuple(
            _nchw(v) if conv else torch.from_numpy(v) for v in calls)
            for k, calls in entry.items()}
    return out


def _within_ulps_of_terms(got, want, old, contrib, decay, k=3) -> bool:
    """``|got - want| <= k`` bf16 ulps of the blend's larger term,
    elementwise (the bound of a blend in bf16 arithmetic)."""
    terms = np.maximum(np.abs(decay * _np(old)),
                       np.abs((1 - decay) * _np(contrib)))
    return bool((np.abs(_np(got) - _np(want))
                 <= k * bf16_ulp(terms)).all())


def test_bf16_factor_step_vs_jax_fused_and_stock(resnet_bf16):
    """One factor step from the same bf16 state (the JAX run's after step
    0) on captures whose contributions both frameworks compute exactly:
    within 1 bf16 ulp of the JAX fused path on every side it blends in its
    kernel (linear A/G, conv G); within 3 ulps of the blend's larger term
    of the JAX stock path everywhere, and of the fused path's conv A (its
    stock blend). (On real activations
    the fp32 contributions differ by summation order, which moves the
    entries that cancel to ~0 by far more than an ulp of themselves: the
    five-step test holds those runs relative to each factor's largest
    entry.)"""
    init, batches = resnet_bf16['init'], resnet_bf16['batches']
    s0 = jax.tree.map(jnp.asarray, resnet_bf16['jax'][0]['state'])
    specs = resnet_bf16['specs']
    x, y = batches[1]
    ref, caps = {}, None
    for fused in (True, False):
        jk = _jax_resnet_kfac(fused)
        jk.init(jax.random.PRNGKey(0), jnp.asarray(x))
        if caps is None:
            _, _, _, real, _ = _jax_caps(
                jk, init['params'], {'batch_stats': init['batch_stats']},
                x, y)
            caps = _exact_captures(jax.tree.map(np.asarray, real))
        # kfaclint: waive[retrace-jit-in-loop] one program per path (fused, stock), each called once
        out = jax.jit(jk.update_factors)(
            s0, jax.tree.map(jnp.asarray, caps))
        ref[fused] = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, out), specs)
    _, kfac = _torch_resnet(init)
    state = kfac.init_state()
    state['factors'] = convert.jax_factors_to_torch(
        resnet_bf16['jax'][0]['state']['factors'], specs)
    pcaps = _to_port_captures(caps, specs)
    got = kfac.update_factors(state, pcaps)
    contrib = kfac.update_factors(state, pcaps, factor_decay=0.0)
    decay = R_HYPER.get('factor_decay', 0.95)
    for name, spec in specs.items():
        for side in 'AG':
            g, old = got[name][side], state['factors'][name][side]
            assert g.dtype == torch.bfloat16
            for fused in (True, False):
                want = ref[fused][name][side]
                if fused and not (spec.kind == 'conv2d' and side == 'A'):
                    assert ulps(g, want) <= 1, (name, side)
                else:
                    assert _within_ulps_of_terms(
                        g, want, old, contrib[name][side], decay), (
                        name, side, fused)
    # The step moved the state: the rounding rule was exercised.
    assert any(not torch.equal(got[n][s], state['factors'][n][s])
               for n in specs for s in 'AG')


def test_bf16_factors_over_five_steps(resnet_bf16):
    """Five K-FAC + SGD steps with bf16 factors: every factor bf16 and
    within 2e-2 of the JAX fused run's, relative to its largest entry, at
    every step; the losses within 1e-3 of each other; inverses fp32."""
    specs = resnet_bf16['specs']
    for step, (j, t) in enumerate(zip(resnet_bf16['jax'],
                                      resnet_bf16['port'])):
        want = convert.jax_factors_to_torch(j['state']['factors'], specs)
        for name, f in t['factors'].items():
            for side, got in f.items():
                assert got.dtype == torch.bfloat16
                assert _rel(_np(got), _np(want[name][side])) <= 2e-2, (
                    step, name, side)
        assert all(v.dtype == torch.float32
                   for e in t['inverses'].values() for v in e.values())
        assert abs(t['loss'] - j['loss']) <= 1e-3 * abs(j['loss']), step


# ---------------------------------------------------------------------------
# The CLIs' --bf16-* flags
# ---------------------------------------------------------------------------

def _cli(name):
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    return {'cifar': train_cifar10_resnet, 'imagenet': train_imagenet_resnet,
            'lm': train_language_model}[name]


# What each flag sets, as the JAX OptimConfig maps it
# (training/optimizers.py:266-272).
FLAG_KNOBS = {
    'bf16_factors': {'factor_dtype': torch.bfloat16,
                     'factor_compute_dtype': torch.bfloat16},
    'bf16_inverses': {'inv_dtype': torch.bfloat16},
    'bf16_precond': {'precond_compute_dtype': torch.bfloat16},
}
OFF_KNOBS = {'factor_dtype': None, 'factor_compute_dtype': None,
             'inv_dtype': torch.float32, 'precond_compute_dtype': None}


@pytest.mark.parametrize('flag', [None, *FLAG_KNOBS])
@pytest.mark.parametrize('cli', ['cifar', 'imagenet', 'lm'])
def test_cli_flags_map_as_the_jax_optimconfig(cli, flag):
    from distributed_kfac_pytorch_tpu_torch.training import engine, \
        optimizers
    argv = [] if flag is None else ['--' + flag.replace('_', '-')]
    args = _cli(cli).build_parser().parse_args(argv)
    cfg = optimizers.OptimConfig(**engine.precision_config(args))
    _, _, kfac, _ = optimizers.get_optimizer(MLP(), cfg, device='cpu')
    want = {**OFF_KNOBS, **FLAG_KNOBS.get(flag, {})}
    assert {k: getattr(kfac, k) for k in want} == want


CLI_TINY = {
    'cifar': {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4,
              'synthetic_size': 16, 'epochs': 1, 'no_augment': True},
    # ResNet-18 stands in for ResNet-152, whose CPU firing is too slow.
    # Its 'auto' default: eigen slots up to 640, Cholesky above (stage 2's
    # 1153-wide sides); stages 3-4 (up to 4608) stay out for time.
    'imagenet': {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
                 'val_batch_size': 2, 'synthetic_size': 4, 'epochs': 1,
                 'kfac_update_freq': 1, 'kfac_cov_update_freq': 1,
                 'skip_layers': ['layer3_block0', 'layer3_block1',
                                 'layer4_block0', 'layer4_block1']},
    'lm': {'arch': 'transformer', 'emsize': 16, 'nheads': 2, 'nlayers': 1,
           'synthetic_vocab': 40, 'synthetic_size': 2000, 'bptt': 8,
           'batch_size': 2, 'max_steps': 3, 'epochs': 1,
           'kfac_update_freq': 2, 'tied': True, 'kfac_approx': 'reduce'},
}


@pytest.mark.parametrize('cli', ['cifar', 'imagenet', 'lm'])
def test_cli_trains_with_the_three_flags(cli):
    """Each CLI at a tiny size with ``--bf16-factors --bf16-inverses
    --bf16-precond``: finite losses, every factor and inverse slot bf16
    (the LM's embedding ``diag_inv`` included)."""
    res = _cli(cli).train({**CLI_TINY[cli], 'bf16_factors': True,
                           'bf16_inverses': True, 'bf16_precond': True,
                           'quiet': True}, device='cpu')
    assert res['losses'] and all(np.isfinite(res['losses']))
    kstate = res['state'].kfac_state
    for part in ('factors', 'inverses'):
        for entry in kstate[part].values():
            assert all(t.dtype == torch.bfloat16 for t in entry.values())
    if cli == 'lm':
        assert kstate['inverses']['embed']['A_inv'].dtype == torch.bfloat16
