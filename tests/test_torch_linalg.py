"""Linear algebra and the bucketed-preconditioning kernel's plain version
of the torch port against the JAX package, on the same numpy inputs.

The warm polish is compared through ``Q diag(d) Q^T`` and the
preconditioned products, never ``Q`` itself: rotations inside an
eigenvalue cluster are free (``ops/linalg.py`` ``eigh_polish`` note).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.ops import linalg as JL
from distributed_kfac_pytorch_tpu.ops import pallas_kernels as JP
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.ops import linalg as L


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, b, n, spread=1.0):
    m = rng.normal(size=(b, n, n))
    return ((m @ m.transpose(0, 2, 1)) / n * spread
            + 0.05 * np.eye(n)).astype('float32')


def _rotation(rng, b, n, angle):
    """Orthonormal bases a small rotation away from the identity."""
    s = rng.normal(size=(b, n, n))
    skew = angle * (s - s.transpose(0, 2, 1)) / np.sqrt(n)
    return np.stack([np.linalg.qr(np.eye(n) + k)[0] for k in skew]
                    ).astype('float32')


def _recon(q, d):
    q, d = np.asarray(q, np.float64), np.asarray(d, np.float64)
    return q @ (d[:, :, None] * q.transpose(0, 2, 1))


@pytest.mark.parametrize('start', ['identity', 'rotated'])
def test_eigh_polish_matches_jax(start):
    # Tolerance 1e-4 relative to the largest entry: both frameworks run
    # the same fixed 16-iteration fp32 polish, so they differ by
    # summation order amplified through the iteration, not by algorithm.
    rng = np.random.default_rng(0)
    a = _spd(rng, 3, 12)
    if start == 'identity':
        q0 = np.broadcast_to(np.eye(12, dtype='float32'), a.shape).copy()
    else:
        w, v = np.linalg.eigh(a.astype(np.float64))
        q0 = (v @ _rotation(rng, 3, 12, 0.2)).astype('float32')
    qj, dj = jax.vmap(lambda m, q: JL.eigh_polish(m, q, iters=16))(
        jnp.asarray(a), jnp.asarray(q0))
    qt, dt = L.eigh_polish(torch.from_numpy(a), torch.from_numpy(q0),
                           iters=16)
    ref = _recon(qj, dj)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(_recon(qt.numpy(), dt.numpy()) / scale,
                               ref / scale, rtol=0, atol=1e-4)
    # Both reconstruct the input matrix to polish accuracy.
    np.testing.assert_allclose(_recon(qt.numpy(), dt.numpy()) / scale,
                               a / scale, rtol=0, atol=1e-3)


def test_batched_eigh_xla_matches_jax():
    rng = np.random.default_rng(1)
    a = _spd(rng, 2, 9)
    qj, dj = JL.batched_eigh(jnp.asarray(a), 'xla', clip=0.0)
    qt, dt = L.batched_eigh(torch.from_numpy(a), 'xla', clip=0.0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_recon(qt.numpy(), dt.numpy()),
                               _recon(qj, dj), rtol=0, atol=1e-5)


def _eigen_entry(rng, s, a_dim, g_dim):
    qa = np.linalg.qr(rng.normal(size=(s, a_dim, a_dim)))[0]
    qg = np.linalg.qr(rng.normal(size=(s, g_dim, g_dim)))[0]
    return {'QA': qa.astype('float32'),
            'dA': rng.uniform(0.1, 2.0, (s, a_dim)).astype('float32'),
            'QG': qg.astype('float32'),
            'dG': rng.uniform(0.1, 2.0, (s, g_dim)).astype('float32')}


def _torch_entry(entry):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in entry.items()}


# Tolerance for the preconditioned products: rel 1e-5 with an absolute
# floor of 1e-5 -- four chained fp32 products whose association differs
# (the JAX kernel forms (QG^T g) QA, the port QG^T (g QA)).
V_RTOL, V_ATOL = 1e-5, 1e-5


@pytest.mark.parametrize('dims', [(12, 8), (13, 9), (65, 10)],
                         ids=['aligned', 'ragged', 'linear_65x10'])
def test_bucket_precond_plain_eigen_vs_pallas(dims):
    a_dim, g_dim = dims
    rng = np.random.default_rng(2)
    g = rng.normal(size=(3, g_dim, a_dim)).astype('float32')
    entry = _eigen_entry(rng, 3, a_dim, g_dim)
    v_ref, vg_ref = JP.fused_bucket_precondition(
        jnp.asarray(g), {k: jnp.asarray(v) for k, v in entry.items()},
        0.003, interpret=True)
    v, vg = kernels.bucket_precond_plain(torch.from_numpy(g),
                                         _torch_entry(entry), 0.003)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=V_RTOL,
                               atol=V_ATOL)
    np.testing.assert_allclose(vg.numpy(), np.asarray(vg_ref),
                               rtol=V_RTOL, atol=V_ATOL)
    # The port's own stock path agrees too.
    stock = L.precondition_dispatch(torch.from_numpy(g),
                                    _torch_entry(entry), 0.003)
    np.testing.assert_allclose(stock.numpy(), np.asarray(v_ref),
                               rtol=V_RTOL, atol=V_ATOL)


def test_bucket_precond_plain_baked_vs_pallas():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(2, 8, 12)).astype('float32')
    entry = {'A_inv': _spd(rng, 2, 12), 'G_inv': _spd(rng, 2, 8)}
    v_ref, vg_ref = JP.fused_bucket_precondition(
        jnp.asarray(g), {k: jnp.asarray(v) for k, v in entry.items()},
        0.003, interpret=True)
    v, vg = kernels.bucket_precond_plain(torch.from_numpy(g),
                                         _torch_entry(entry), 0.003)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=V_RTOL,
                               atol=V_ATOL)
    np.testing.assert_allclose(vg.numpy(), np.asarray(vg_ref), rtol=V_RTOL,
                               atol=V_ATOL)


# The bf16-multiplicand mode: every operand and the intermediates U and T
# rounded to bf16 (Pallas: default precision on bf16 operands), held at
# 1e-2 of the largest reference entry -- the chip tolerance of the mode.
# Both round at the same points; what is left is fp32 accumulation order
# moving a value across a bf16 rounding boundary (~3e-3 seen at these
# shapes).
BF16_REL = 1e-2


@pytest.mark.parametrize('eigen', [True, False], ids=['eigen', 'baked'])
@pytest.mark.parametrize('dims', [(3, 9, 13), (2, 64, 130)],
                         ids=['3x9x13', '2x64x130'])
def test_bucket_precond_plain_bf16_vs_pallas(dims, eigen):
    s, g_dim, a_dim = dims
    rng = np.random.default_rng(5)
    g = rng.normal(size=dims).astype('float32')
    entry = (_eigen_entry(rng, s, a_dim, g_dim) if eigen else
             {'A_inv': _spd(rng, s, a_dim), 'G_inv': _spd(rng, s, g_dim)})
    v_ref, vg_ref = JP.fused_bucket_precondition(
        jnp.asarray(g), {k: jnp.asarray(v) for k, v in entry.items()},
        0.003, compute_dtype=jnp.bfloat16, interpret=True)
    v, vg = kernels.bucket_precond_plain(torch.from_numpy(g),
                                         _torch_entry(entry), 0.003,
                                         bf16=True)
    for got, ref in ((v.numpy(), np.asarray(v_ref)),
                     (vg.numpy(), np.asarray(vg_ref))):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()
    # The mode does round: fp32 multiplicands land measurably elsewhere.
    v32, _ = kernels.bucket_precond_plain(torch.from_numpy(g),
                                          _torch_entry(entry), 0.003)
    assert np.abs(v32.numpy() - v.numpy()).max() > 1e-4 * np.abs(
        v32.numpy()).max()


def test_precondition_eigen_and_inv_match_jax():
    rng = np.random.default_rng(4)
    grad = rng.normal(size=(6, 10)).astype('float32')
    e = {k: v[0] for k, v in _eigen_entry(rng, 1, 10, 6).items()}
    ref = JL.precondition_eigen(jnp.asarray(grad), *(
        jnp.asarray(e[k]) for k in ('QA', 'QG', 'dA', 'dG')), 0.003)
    got = L.precondition_eigen(torch.from_numpy(grad), *(
        torch.from_numpy(e[k]) for k in ('QA', 'QG', 'dA', 'dG')), 0.003)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=V_RTOL,
                               atol=V_ATOL)
    a_inv, g_inv = _spd(rng, 1, 10)[0], _spd(rng, 1, 6)[0]
    ref = JL.precondition_inv(jnp.asarray(grad), jnp.asarray(a_inv),
                              jnp.asarray(g_inv))
    got = L.precondition_inv(torch.from_numpy(grad),
                             torch.from_numpy(a_inv),
                             torch.from_numpy(g_inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=V_RTOL,
                               atol=V_ATOL)


def test_eigen_side_inverse_matches_jax():
    # rel 1e-4: entries of (F + 0.01 I)^-1 reach 1/0.06, so fp32 rounding
    # of the two frameworks' products differs at ~1e-6 of that.
    rng = np.random.default_rng(5)
    a = _spd(rng, 1, 7)[0]
    d, q = np.linalg.eigh(a.astype(np.float64))
    q, d = q.astype('float32'), d.astype('float32')
    ref = JL.eigen_side_inverse(jnp.asarray(q), jnp.asarray(d), 0.01)
    got = L.eigen_side_inverse(torch.from_numpy(q), torch.from_numpy(d),
                               0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_bucket_precond_wrapper_on_cpu_launches_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(6)
    entry = _torch_entry(_eigen_entry(rng, 2, 5, 4))
    kernels.bucket_precond(torch.zeros(2, 4, 5), entry, 0.003)
    assert kernels.LAUNCHES['bucket_precond'] == 0
