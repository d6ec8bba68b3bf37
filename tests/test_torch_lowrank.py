"""The randomized low-rank inverse of the torch port against the JAX
package, on the CPU.

  - ``lowrank_eigh`` / ``batched_lowrank_eigh``, warm and cold (cold with
    the JAX package's own Gaussian draw passed in through the port-only
    ``sketch=``), on decayed-spectrum SPD stacks: the eigenvalues and the
    projector ``Q diag(d) Q^T`` within 1e-4 of the largest JAX entry (``Q``
    itself is compared through the projector: QR signs and rotations
    within the span may differ).
  - The truncated precondition branches (``precondition_eigen``'s
    damping-only complement, ``eigen_side_inverse``, the truncated ``QG``
    beside a diagonal A) for ``compute_dtype`` None, fp32 and bf16: fp32
    within 1e-5, bf16 within 1e-2 (the tolerances of
    ``tests/test_torch_mixed_precision.py``).
  - The constructor checks and the registration check that fails closed.
  - ``KFAC`` on a small Transformer LM (2 blocks, d 64, threshold 128, rank
    16: mlp_in's G (256) and mlp_out's A (257) engage) for 12 steps with
    firings at steps 0 and 6, against the JAX ``KFAC``: monolithic firing
    (low-rank / eigen layers, the truncated stock precondition),
    ``inv_pipeline_chunks=3`` with a mixed low-rank / Cholesky layer (the
    truncated side baked), and ``inv_staleness=1`` with bf16 inverse
    storage. Losses rel 1e-4 and factors rel 1e-4 (fp32 trajectories of
    one program); preconditioned gradients per layer by relative norm 2e-2,
    the warm-polish tolerance of ``tests/test_torch_kfac.py``. With bf16
    inverses the tolerances of a bf16 run in
    ``tests/test_torch_mixed_precision.py``: losses rel 1e-3,
    factors 2e-2 of their largest entry, and each preconditioned gradient
    within 1e-2 of the step's largest entry (a stored value whose fp32
    source differs by the fp32 noise may round to the neighbouring bf16
    value).
  - ``inv_lowrank_rank=0`` is bit for bit the port without the knob.

The JAX side runs eagerly (no Pallas kernel on this path); the port runs
its kernels' plain versions (CPU tensors).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
from distributed_kfac_pytorch_tpu.ops import linalg as JL
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.ops import linalg as PL
from distributed_kfac_pytorch_tpu_torch.preconditioner import (
    KFAC,
    eigen_family,
    truncated_entry,
)
from distributed_kfac_pytorch_tpu_torch.training import engine


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(float(np.max(np.abs(ref))), 1e-30))


def _spd_stack(n, count, decay_at, seed=0):
    """SPD matrices whose spectrum falls from 4 to 1 over the top
    ``decay_at`` and to 1e-3 beyond (distinct eigenvalues throughout)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        u, _ = np.linalg.qr(rng.randn(n, n))
        spec = np.concatenate([np.linspace(4.0, 1.0, decay_at),
                               np.linspace(1e-3, 1e-4, n - decay_at)])
        out.append((u * spec) @ u.T)
    return np.stack(out).astype(np.float32)


def _projector(q, d):
    q = np.asarray(q, np.float64)
    return (q * np.asarray(d, np.float64)[..., None, :]) @ np.swapaxes(
        q, -1, -2)


N, R, COUNT = 48, 8, 3


# ---------------------------------------------------------------------------
# ops.linalg: the truncated eigenpair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('power_iters', [0, 2])
def test_cold_lowrank_eigh_matches_jax(power_iters):
    stack = _spd_stack(N, COUNT, R)
    sketch = np.array(jax.random.normal(jax.random.PRNGKey(0), (N, R),
                                        jnp.float32))
    jq, jd = JL.batched_lowrank_eigh(jnp.asarray(stack), R,
                                     power_iters=power_iters)
    tq, td = PL.batched_lowrank_eigh(torch.from_numpy(stack), R,
                                     power_iters=power_iters,
                                     sketch=torch.from_numpy(sketch))
    assert tuple(tq.shape) == (COUNT, N, R) and tuple(td.shape) == (COUNT, R)
    assert _rel(np.sort(td.numpy(), -1), np.sort(np.asarray(jd), -1)) <= 1e-4
    assert _rel(_projector(tq.numpy(), td.numpy()),
                _projector(jq, jd)) <= 1e-4
    # Orthonormal columns, ascending Rayleigh eigenvalues on the cold path.
    gram = tq.mT @ tq
    assert float((gram - torch.eye(R)).abs().max()) <= 1e-5
    assert bool((td[:, 1:] >= td[:, :-1]).all())


@pytest.mark.parametrize('start', ['identity', 'rotated'])
def test_warm_lowrank_eigh_matches_jax(start):
    stack = _spd_stack(N, COUNT, R, seed=1)
    if start == 'identity':
        q_prev = np.broadcast_to(np.eye(N, R, dtype=np.float32),
                                 (COUNT, N, R)).copy()
    else:
        rng = np.random.RandomState(2)
        q_prev = np.stack([np.linalg.qr(rng.randn(N, R))[0]
                           for _ in range(COUNT)]).astype(np.float32)
    jq, jd = JL.batched_lowrank_eigh(jnp.asarray(stack), R,
                                     q_prev=jnp.asarray(q_prev))
    tq, td = PL.batched_lowrank_eigh(torch.from_numpy(stack), R,
                                     q_prev=torch.from_numpy(q_prev))
    assert _rel(np.sort(td.numpy(), -1), np.sort(np.asarray(jd), -1)) <= 1e-4
    assert _rel(_projector(tq.numpy(), td.numpy()),
                _projector(jq, jd)) <= 1e-4


def test_warm_lowrank_eigh_converges_to_the_top_eigenpairs():
    """Carried across firings, the warm path's projector converges to the
    top-``R`` part of the exact decomposition."""
    a = torch.from_numpy(_spd_stack(N, 1, R, seed=3)[0])
    q = torch.eye(N, R)
    for _ in range(6):
        q, d = PL.lowrank_eigh(a, R, q_prev=q)
    w, v = torch.linalg.eigh(a.double())
    top = (v[:, -R:] * w[-R:]) @ v[:, -R:].T
    assert _rel(((q * d) @ q.T).numpy(), top.numpy()) <= 1e-4


def test_sketch_is_seeded_and_rank_is_checked(monkeypatch):
    a = torch.from_numpy(_spd_stack(N, 1, R)[0])
    one = PL.lowrank_sketch(N, R, seed=5, device='cpu')
    assert torch.equal(one, PL.lowrank_sketch(N, R, seed=5, device='cpu'))
    assert not torch.equal(one, PL.lowrank_sketch(N, R, seed=6,
                                                  device='cpu'))
    q1, d1 = PL.lowrank_eigh(a, R, seed=5)
    q2, d2 = PL.lowrank_eigh(a, R, sketch=one)
    assert torch.equal(q1, q2) and torch.equal(d1, d2)
    for rank in (0, N, N + 1):
        with pytest.raises(ValueError, match='0 < rank < dim'):
            PL.lowrank_eigh(a, rank)
    assert PL.decomposition_cost(N, rank=R) == R * N ** 2
    assert PL.decomposition_cost(N) == N ** 3
    # The sketch's default device is the card, as every entry point's.
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        PL.lowrank_sketch(N, R)


# ---------------------------------------------------------------------------
# ops.linalg: the truncated precondition branches
# ---------------------------------------------------------------------------

DTYPES = {None: (None, None), 'fp32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16)}
TOL = {None: 1e-5, 'fp32': 1e-5, 'bf16': 1e-2}


def _basis(rng, n, r):
    q = np.linalg.qr(rng.normal(size=(n, n)))[0][:, :r]
    return q.astype(np.float32), rng.uniform(0.1, 2.0, r).astype(
        np.float32)


@pytest.mark.parametrize('cdt', list(DTYPES))
@pytest.mark.parametrize('sides', ['A', 'G', 'AG'])
def test_truncated_precondition_eigen_matches_jax(sides, cdt):
    rng = np.random.default_rng(11)
    g_dim, a_dim = 12, 20
    grad = rng.normal(size=(g_dim, a_dim)).astype(np.float32)
    ra, rg = (5 if 'A' in sides else a_dim), (4 if 'G' in sides else g_dim)
    qa_full, da_full = _basis(rng, a_dim, a_dim)
    qg_full, dg_full = _basis(rng, g_dim, g_dim)
    qa, da, qg, dg = qa_full[:, :ra], da_full[:ra], qg_full[:, :rg], \
        dg_full[:rg]
    tdt, jdt = DTYPES[cdt]
    got = PL.precondition_eigen(*(torch.from_numpy(np.ascontiguousarray(v))
                                  for v in (grad, qa, qg, da, dg)), 0.003,
                                compute_dtype=tdt)
    ref = JL.precondition_eigen(*(jnp.asarray(v) for v in
                                  (grad, qa, qg, da, dg)), 0.003,
                                compute_dtype=jdt)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL[cdt]
    if cdt is None:
        # The operator whose tail eigenvalues are 0, in float64: the full
        # bases with the discarded eigenvalues set to 0.
        da0 = np.where(np.arange(a_dim) < ra, da_full, 0.0)
        dg0 = np.where(np.arange(g_dim) < rg, dg_full, 0.0)
        qa64, qg64 = qa_full.astype(np.float64), qg_full.astype(np.float64)
        v = (qg64.T @ grad @ qa64) / (dg0[:, None] * da0[None, :] + 0.003)
        assert _rel(got.numpy(), qg64 @ v @ qa64.T) <= 1e-5


@pytest.mark.parametrize('r', [6, 16])
def test_eigen_side_inverse_matches_jax(r):
    rng = np.random.default_rng(12)
    q, d = _basis(rng, 16, r)
    got = PL.eigen_side_inverse(torch.from_numpy(q), torch.from_numpy(d),
                                0.01)
    ref = JL.eigen_side_inverse(jnp.asarray(q), jnp.asarray(d), 0.01)
    assert _rel(got.numpy(), ref) <= 1e-5
    dense = np.linalg.inv(_projector(q, d) + 0.01 * np.eye(16))
    assert _rel(got.numpy(), dense) <= 1e-5


@pytest.mark.parametrize('cdt', list(DTYPES))
def test_truncated_diag_a_dispatch_matches_jax(cdt):
    rng = np.random.default_rng(13)
    vocab, d = 30, 16
    grad = rng.normal(size=(vocab, d)).astype(np.float32)
    qg, dg = _basis(rng, d, 5)
    diag = rng.uniform(0.5, 2.0, vocab).astype(np.float32)
    tdt, jdt = DTYPES[cdt]
    got = PL.precondition_dispatch(
        torch.from_numpy(grad), {'QG': torch.from_numpy(qg),
                                 'dG': torch.from_numpy(dg)}, 0.003,
        diag_a=torch.from_numpy(diag), compute_dtype=tdt)
    ref = JL.precondition_dispatch(
        jnp.asarray(grad), {'QG': jnp.asarray(qg), 'dG': jnp.asarray(dg)},
        0.003, diag_a=jnp.asarray(diag), compute_dtype=jdt)
    assert _rel(got.numpy(), ref) <= TOL[cdt]


def test_square_pairs_keep_the_exact_formula_bit_for_bit():
    rng = np.random.default_rng(14)
    g = torch.from_numpy(rng.normal(size=(6, 10)).astype(np.float32))
    qa, da = (torch.from_numpy(v) for v in _basis(rng, 10, 10))
    qg, dg = (torch.from_numpy(v) for v in _basis(rng, 6, 6))
    v = (qg.mT @ g @ qa) / (dg[:, None] * da[None, :] + 0.003)
    assert torch.equal(PL.precondition_eigen(g, qa, qg, da, dg, 0.003),
                       qg @ v @ qa.mT)
    assert torch.equal(PL.eigen_side_inverse(qa, da, 0.003),
                       (qa * (1.0 / (da + 0.003))[None, :]) @ qa.mT)
    assert not truncated_entry({'QA': qa, 'QG': qg})
    assert truncated_entry({'QA': qa[:, :3], 'QG': qg})


# ---------------------------------------------------------------------------
# KFAC: constructor checks, the dispatch, fail-closed registration
# ---------------------------------------------------------------------------

VOCAB, D, HEADS, LAYERS, SEQ, BATCH, MAX_LEN = 64, 64, 4, 2, 8, 2, 16
RANK, THRESHOLD = 16, 128
STEPS, I_FREQ, LR = 12, 6, 0.1
HYPER = dict(damping=0.003, lr=LR, kl_clip=0.001, factor_update_freq=1,
             inv_update_freq=I_FREQ)
LOWRANK = dict(inv_lowrank_rank=RANK, inv_lowrank_dim_threshold=THRESHOLD)


def _torch_model():
    torch.manual_seed(0)
    return transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
        max_len=MAX_LEN, dropout=0.0, tie_weights=False)


@pytest.mark.parametrize('kwargs,match', [
    (dict(inv_lowrank_rank=-1), 'must be >= 0'),
    (dict(inv_lowrank_rank=4, inv_lowrank_dim_threshold=1), '>= 2'),
    (dict(hierarchical_reduce=True, deferred_factor_reduction=True),
     'mutually exclusive')])
def test_constructor_checks_raise_as_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        KFAC(_torch_model(), device='cpu', **kwargs)


def test_dispatch_seeds_and_fail_closed():
    kfac = KFAC(_torch_model(), device='cpu', inverse_method='cholesky',
                **LOWRANK)
    assert kfac.method_for_dim(THRESHOLD) == 'lowrank'
    assert kfac.method_for_dim(THRESHOLD - 1) == 'cholesky'
    assert kfac.lowrank_rank_for(257) == RANK
    assert kfac.lowrank_rank_for(65) is None
    assert eigen_family('lowrank') and eigen_family('eigen')
    state = kfac.init_state()
    mlp_in, mlp_out = (state['inverses'][f'block0.{n}']
                       for n in ('mlp_in', 'mlp_out'))
    # Mixed low-rank / Cholesky layers: truncated basis plus a baked slot.
    assert set(mlp_in) == {'A_inv', 'QG', 'dG', 'G_inv'}
    assert torch.equal(mlp_in['QG'], torch.eye(4 * D, RANK))
    assert torch.equal(mlp_in['dG'], torch.ones(RANK))
    assert tuple(mlp_out['QA'].shape) == (4 * D + 1, RANK)
    # An engaged side at or below the rank fails closed (here the
    # embedding's 64-wide G, the first side registered at threshold 64).
    with pytest.raises(ValueError, match="must be < the engaged factor "
                                         "dim 64 \\(layer 'embed' side G"):
        KFAC(_torch_model(), device='cpu', inv_lowrank_rank=65,
             inv_lowrank_dim_threshold=64).init_state()
    # The chunk planner costs engaged matrices r dim^2.
    chunked = KFAC(_torch_model(), device='cpu', inv_pipeline_chunks=3,
                   **{**HYPER, **LOWRANK})
    costs = dict(chunked.inverse_chunk_items(state['factors']))
    assert costs[('mat', 'block0.mlp_in', 'G')] == RANK * (4 * D) ** 2
    assert costs[('mat', 'block0.mlp_in', 'A')] == (D + 1) ** 3
    # State bytes: an engaged side holds r d, not d^2.
    eig = KFAC(_torch_model(), device='cpu', inverse_method='eigen')
    low = KFAC(_torch_model(), device='cpu', inverse_method='eigen',
               **LOWRANK)
    saved = (eig.memory_usage(eig.init_state())['inverses']
             - low.memory_usage(low.init_state())['inverses'])
    engaged = LAYERS * (4 * D * (4 * D + 1) + (4 * D + 1) * (4 * D + 2))
    kept = LAYERS * RANK * ((4 * D + 1) + (4 * D + 2))
    assert saved == 4 * (engaged - kept)


# ---------------------------------------------------------------------------
# KFAC: 12 steps on a small Transformer LM against the JAX KFAC
# ---------------------------------------------------------------------------

CONFIGS = {
    'monolithic_eigen': dict(inverse_method='eigen', eigh_method='xla'),
    'chunks3_mixed_cholesky': dict(inverse_method='cholesky',
                                   inv_pipeline_chunks=3),
    # Strict fp32 precondition operands: with compute dtype None JAX forms
    # the damping quotient of bf16 eigenvalues in bf16 (a recorded delta
    # of the port), the port in fp32.
    'stale_bf16_inverses': dict(
        inverse_method='eigen', eigh_method='xla', inv_staleness=1,
        inv_dtype=(torch.bfloat16, jnp.bfloat16),
        precond_compute_dtype=(torch.float32, jnp.float32)),
}


def _knobs(name, jax_side):
    out = {}
    for k, v in CONFIGS[name].items():
        out[k] = v[1 if jax_side else 0] if isinstance(v, tuple) else v
    return {**HYPER, **LOWRANK, **out}


def _flags(name, step):
    knobs = CONFIGS[name]
    return engine.kfac_step_flags(engine.cadence_flags(
        step, 1, I_FREQ, knobs.get('inv_pipeline_chunks', 1),
        inv_staleness=knobs.get('inv_staleness', 0)))


def _batch(step):
    rng = np.random.default_rng(100 + step)
    ids = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    return ids, targets


def _xent(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, targets[..., None], -1).mean()


def _jax_run(name):
    model = jtl.TransformerLM(vocab_size=VOCAB, d_model=D,
                              num_layers=LAYERS, num_heads=HEADS,
                              max_len=MAX_LEN, dropout=0.0,
                              tie_weights=False)
    kfac = JKFAC(model, skip_layers=[], **_knobs(name, True))
    ids0, _ = _batch(0)
    # Jitted: registration runs once, while the init is traced; the step
    # compiles once per set of cadence flags.
    variables, kstate = jax.jit(lambda k, v: kfac.init(k, v, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(ids0))
    params = variables['params']
    init = jax.tree.map(np.asarray, params)

    def step_fn(params, kstate, ids, targets, flags):
        loss, _, grads, captures, _ = kfac.capture.loss_and_grads(
            lambda out: _xent(out, targets), params, ids, train=False)
        precond, kstate = kfac.step(kstate, grads, captures, **dict(flags))
        params = jax.tree.map(lambda p, g: p - LR * g, params, precond)
        return loss, precond, params, kstate

    jstep = jax.jit(step_fn, static_argnums=4)
    rec = []
    for step in range(STEPS):
        ids, targets = (jnp.asarray(v) for v in _batch(step))
        loss, precond, params, kstate = jstep(
            params, kstate, ids, targets,
            tuple(sorted(_flags(name, step).items())))
        rec.append({'loss': float(loss),
                    'factors': jax.tree.map(np.asarray, kstate['factors']),
                    'precond': jax.tree.map(np.asarray, precond)})
    return init, rec, jax.tree.map(np.asarray, kstate['inverses'])


def _torch_run(init, knobs, name):
    model = transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
        max_len=MAX_LEN, dropout=0.0, tie_weights=False)
    convert.load_flax_params(model, init)
    kfac = KFAC(model, device='cpu', **knobs)
    state = kfac.init_state()
    rec = []
    for step in range(STEPS):
        ids, targets = (torch.from_numpy(v).long() for v in _batch(step))
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: engine.lm_loss(out, targets), ids)
        precond, state = kfac.step(state, grads, captures,
                                   **_flags(name, step))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
        rec.append({'loss': float(loss), 'factors': state['factors'],
                    'precond': {n: t.clone() for n, t in precond.items()}})
    return kfac, state, rec


@pytest.fixture(scope='module', params=list(CONFIGS))
def runs(request):
    name = request.param
    init, jrec, jinv = _jax_run(name)
    kernels.reset_launches()
    kfac, state, trec = _torch_run(init, _knobs(name, False), name)
    return {'name': name, 'init': init, 'kfac': kfac, 'state': state,
            'jax': jrec, 'jinv': jinv, 'torch': trec,
            'launches': dict(kernels.LAUNCHES)}


def _bf16(runs) -> bool:
    return 'inv_dtype' in CONFIGS[runs['name']]


def test_kfac_losses_match_jax(runs):
    got = [r['loss'] for r in runs['torch']]
    np.testing.assert_allclose(got, [r['loss'] for r in runs['jax']],
                               rtol=1e-3 if _bf16(runs) else 1e-4)
    assert all(math.isfinite(v) for v in got)


@pytest.mark.parametrize('step', [0, 5, 6, 11])
def test_kfac_factors_match_jax(runs, step):
    ref = convert.jax_factors_to_torch(runs['jax'][step]['factors'],
                                       runs['kfac'].specs)
    got = runs['torch'][step]['factors']
    tol = 2e-2 if _bf16(runs) else 1e-4
    for name, f in ref.items():
        for side in 'AG':
            assert _rel(got[name][side].numpy(), f[side].numpy()) <= tol, (
                name, side, step)


@pytest.mark.parametrize('step', [0, 5, 6, 11])
def test_kfac_preconditioned_grads_match_jax(runs, step):
    ref = convert.flax_to_torch(runs['jax'][step]['precond'])
    got = runs['torch'][step]['precond']
    assert set(ref) == set(got)
    if _bf16(runs):
        big = max(float(np.abs(t.numpy()).max()) for t in ref.values())
        for name, t in ref.items():
            err = float(np.abs(got[name].numpy() - t.numpy()).max())
            assert err <= 1e-2 * big, (name, step, err / big)
        return
    for name, t in ref.items():
        want = t.numpy().astype(np.float64)
        diff = got[name].numpy().astype(np.float64) - want
        rel = np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 2e-2, (name, step, rel)


def test_kfac_lowrank_state_layout_and_launches(runs):
    kfac, state = runs['kfac'], runs['state']
    inv = state['inverses']['block1.mlp_in']
    assert tuple(inv['QG'].shape) == (4 * D, RANK)
    assert inv['QG'].dtype == kfac.inv_dtype
    mixed = kfac.inverse_method == 'cholesky'
    assert ('G_inv' in inv) is mixed
    # The port's carried basis spans what the JAX one spans.
    jinv = convert.jax_inverses_to_torch(runs['jinv'], kfac.specs)
    for layer, side in (('block1.mlp_in', 'G'), ('block1.mlp_out', 'A')):
        got = _projector(state['inverses'][layer][f'Q{side}'].float(),
                         state['inverses'][layer][f'd{side}'].float())
        want = _projector(jinv[layer][f'Q{side}'].float(),
                          jinv[layer][f'd{side}'].float())
        tol = 2e-2 if kfac.inv_dtype == torch.bfloat16 else 1e-3
        assert _rel(got, want) <= tol, (layer, side)
    assert set(runs['launches'].values()) == {0}


def test_rank_zero_is_the_port_without_the_knob():
    """``inv_lowrank_rank=0`` (any threshold) runs the exact path bit for
    bit, three steps with a firing."""
    outs = []
    init = None
    for knobs in ({}, dict(inv_lowrank_rank=0, inv_lowrank_dim_threshold=2)):
        model = _torch_model()
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        kfac = KFAC(model, device='cpu', **HYPER, **knobs)
        state = kfac.init_state()
        rec = []
        for step in range(3):
            ids, targets = (torch.from_numpy(v).long()
                            for v in _batch(step))
            _, _, grads, caps = kfac.capture.loss_and_grads(
                lambda out: engine.lm_loss(out, targets), ids)
            precond, state = kfac.step(state, grads, caps,
                                       factor_update=True,
                                       inv_update=step % 2 == 0)
            rec.append(precond)
        outs.append((rec, state))
    (a, sa), (b, sb) = outs
    for pa, pb in zip(a, b):
        assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for n, e in sa['inverses'].items():
        assert all(torch.equal(t, sb['inverses'][n][k]) for k, t in e.items())


def test_hierarchical_single_device_step_refuses():
    kfac = KFAC(_torch_model(), device='cpu', hierarchical_reduce=True,
                **HYPER)
    state = kfac.init_state()
    ids, targets = (torch.from_numpy(v).long() for v in _batch(0))
    _, _, grads, caps = kfac.capture.loss_and_grads(
        lambda out: engine.lm_loss(out, targets), ids)
    with pytest.raises(ValueError, match='multi-slice'):
        kfac.step(state, grads, caps, factor_update=True)


def test_factor_only_restore_rebuilds_cold():
    """A checkpoint without inverses, or one of the exact path, rebuilds
    the low-rank slots cold through the seeded sketch; a bundle with the
    (d, r) bases keeps them bit for bit."""
    kfac = KFAC(_torch_model(), device='cpu', inverse_method='eigen',
                eigh_method='xla', **HYPER, **LOWRANK)
    state = kfac.init_state()
    ids, targets = (torch.from_numpy(v).long() for v in _batch(0))
    _, _, grads, caps = kfac.capture.loss_and_grads(
        lambda out: engine.lm_loss(out, targets), ids)
    _, state = kfac.step(state, grads, caps, factor_update=True,
                         inv_update=True)
    kept = kfac.load_state_dict(kfac.state_dict(state, include_inverses=True))
    for n, e in state['inverses'].items():
        assert all(torch.equal(kept['inverses'][n][k], t)
                   for k, t in e.items())
    cold = kfac.load_state_dict(kfac.state_dict(state))
    exact = KFAC(_torch_model(), device='cpu', inverse_method='eigen',
                 eigh_method='xla', **HYPER)
    exact_state = exact.init_state()
    from_exact = kfac.load_state_dict(
        {**kfac.state_dict(state), 'inverses': exact_state['inverses']})
    # The rebuild's 256-wide bucket: both blocks' mlp_in G, one stack.
    stack = torch.stack([state['factors'][f'block{i}.mlp_in']['G']
                         for i in range(LAYERS)])
    q, d = PL.batched_lowrank_eigh(stack, RANK)
    for rebuilt in (cold, from_exact):
        e = rebuilt['inverses']['block0.mlp_in']
        assert torch.equal(e['QG'], q[0]) and torch.equal(e['dG'], d[0])
