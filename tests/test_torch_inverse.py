"""Damped inverses of the torch port against the JAX package: the Cholesky
inverse, the Newton--Schulz iteration (the plain version of the K4
kernel) against ``linalg.newton_schulz_inverse`` and against the Pallas
kernel in interpret mode, and ``damped_inverse_stack``. Inputs are numpy
arrays from a seed; each test states its tolerance."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.ops import linalg as JL
from distributed_kfac_pytorch_tpu.ops import pallas_kernels as JP
from distributed_kfac_pytorch_tpu_torch.ops import kernels, linalg


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, n, k=None):
    """``W W^T / k`` with W (n, k) Gaussian: well conditioned for k = 2n
    (eigenvalues ~[0.09, 2.9]), ill conditioned as k nears n."""
    k = 2 * n if k is None else k
    w = rng.standard_normal((n, k)).astype(np.float32)
    return (w @ w.T / k).astype(np.float32)


def _stack(seed, n, ks):
    rng = np.random.default_rng(seed)
    return np.stack([_spd(rng, n, k) for k in ks])


def _jax_ns(stack, damping, iters, tol=1e-5):
    return np.asarray(jax.vmap(lambda m: JL.newton_schulz_inverse(
        m, damping, iters=iters, tol=tol))(jnp.asarray(stack)))


@pytest.mark.parametrize('n', [8, 70, 130])
def test_get_inverse_matches_jax(n):
    # rtol 1e-5 (atol 1e-6 of entries ~1): fp32 Cholesky + triangular
    # solves of the same well-conditioned matrices in two libraries.
    stack = _stack(0, n, [2 * n, 3 * n])
    ref = jax.vmap(lambda m: JL.get_inverse(m, damping=0.003))(
        jnp.asarray(stack))
    got = linalg.get_inverse(torch.from_numpy(stack), 0.003)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_get_inverse_not_positive_definite_is_nan_like_jax():
    m = np.diag(np.array([1.0, -2.0, 3.0], np.float32))
    ref = np.asarray(JL.get_inverse(jnp.asarray(m)))
    got = linalg.get_inverse(torch.from_numpy(m)).numpy()
    assert np.isnan(ref).all() and np.isnan(got).all()


# Condition numbers ~3.7, 9, 34 and 97: each matrix stops at its own
# iteration.
VARIED_KS = (80, 32, 16, 12)


@pytest.mark.parametrize('iters', [100, 5], ids=['converge', 'cap5'])
def test_ns_plain_matches_jax_newton_schulz(iters):
    # rtol 1e-5 (atol 1e-5 on inverses of norm up to ~30): the same fp32
    # iteration, matmuls summed in different orders. With iters=5 every
    # matrix stops at the cap.
    stack = _stack(1, 8, VARIED_KS)
    ref = _jax_ns(stack, 0.001, iters)
    got, k_run = kernels.batched_inverse_plain(torch.from_numpy(stack),
                                               0.001, iters)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if iters == 5:
        assert k_run.tolist() == [5, 5, 5, 5]


def test_ns_iteration_counts_pin_the_loop_semantics():
    # The JAX loop stopped after k iterations exactly when capping it at
    # k gives its full result bitwise and capping it at k - 1 does not:
    # the residual is that of the iterate before the update, and the
    # update of the iteration that meets tol is still applied.
    stack = _stack(1, 8, VARIED_KS)
    full = _jax_ns(stack, 0.001, 100)
    _, k_run = kernels.batched_inverse_plain(torch.from_numpy(stack), 0.001)
    k_run = k_run.tolist()
    assert len(set(k_run)) > 1, k_run          # they stop apart
    for i, k in enumerate(k_run):
        assert 0 < k < 100
        at_k = _jax_ns(stack[i:i + 1], 0.001, k)[0]
        before = _jax_ns(stack[i:i + 1], 0.001, k - 1)[0]
        np.testing.assert_array_equal(at_k, full[i])
        assert not np.array_equal(before, full[i])


def test_ns_without_damping_and_wrapper_on_cpu():
    # damping None folds nothing in (the JAX default); the wrapper on a
    # CPU tensor runs the plain version and launches nothing.
    stack = _stack(2, 12, (24, 36)) + 0.1 * np.eye(12, dtype=np.float32)
    ref = _jax_ns(stack, None, 100)
    kernels.reset_launches()
    got, k_run = kernels.batched_inverse(torch.from_numpy(stack), None,
                                         with_iters=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert k_run.dtype == torch.int32 and k_run.shape == (2,)
    assert kernels.LAUNCHES['ns_inverse'] == 0


@pytest.mark.parametrize('n', [48, 128])
def test_ns_plain_matches_pallas_interpret(n):
    # rtol 1e-4 / atol 1e-3, the JAX package's own Pallas-vs-XLA tolerance
    # (tests/test_newton_inverse.py): the Pallas kernel pads n to 128 lanes
    # with an identity block, so its X_0 is I / max(row sum, 1) rather than
    # I / row sum, and its iterates differ from the unpadded iteration
    # that the port (and the JAX package off the TPU) follows.
    rng = np.random.RandomState(3)
    stack = np.stack([(a @ a.T / n).astype(np.float32) for a in
                      (rng.randn(n, n).astype(np.float32) for _ in range(2))])
    pal = JP.batched_inverse(jnp.asarray(stack), 0.003, iters=30,
                             force_pallas=True, interpret=True)
    got = kernels.batched_inverse(torch.from_numpy(stack), 0.003, iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize('method', ['newton', 'cholesky'])
def test_damped_inverse_stack_matches_jax(method):
    # rtol 1e-5 / atol 1e-5: the same algorithm per method on both sides
    # (the JAX newton stack runs the vmapped XLA iteration on the CPU).
    stack = _stack(4, 20, (40, 60, 30))
    ref = JP.damped_inverse_stack(jnp.asarray(stack), 0.003, method,
                                  iters=100)
    got = kernels.damped_inverse_stack(torch.from_numpy(stack), 0.003,
                                       method, iters=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_damped_inverse_stack_rejects_unknown_method():
    with pytest.raises(ValueError, match='newton'):
        kernels.damped_inverse_stack(torch.eye(3)[None], 0.1, 'eigen')


def test_eigen_side_inverse_is_the_damped_inverse():
    # Full-rank bases: Q diag(1/(d + l)) Q^T equals the Cholesky damped
    # inverse of Q diag(d) Q^T (rtol 1e-4: fp32, condition ~30).
    stack = _stack(5, 16, (32,))[0]
    d, q = np.linalg.eigh(stack.astype(np.float64))
    q, d = q.astype(np.float32), d.astype(np.float32)
    got = linalg.eigen_side_inverse(torch.from_numpy(q), torch.from_numpy(d),
                                    0.003)
    ref = np.asarray(JL.eigen_side_inverse(jnp.asarray(q), jnp.asarray(d),
                                           0.003))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), linalg.get_inverse(torch.from_numpy(stack), 0.003),
        rtol=1e-4, atol=1e-4)


def _k4_ablation():
    path = Path(__file__).resolve().parent.parent / 'scripts' / \
        'k4_ablation.py'
    spec = importlib.util.spec_from_file_location('k4_ablation', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', ['committed', 'cvt_rna', 'one_level',
                                  'stages3', 'mma_only'])
def test_k4_ablation_variants_apply_to_the_sources(name):
    # Each variant of scripts/k4_ablation.py is a text edit of the
    # committed K4 sources; an edit that no longer matches (the sources
    # moved on) must fail here rather than on the card.
    ab = _k4_ablation()
    assert set(ab.VARIANTS) == {'committed', 'cvt_rna', 'one_level',
                                'stages3', 'mma_only'}
    committed = ab.edited_sources(kernels.CSRC, 'committed')
    srcs = ab.edited_sources(kernels.CSRC, name)
    assert (srcs == committed) == (name == 'committed')

