"""The Brent--Luk Jacobi eigh of the torch port (``ops.linalg`` plain
version and the ``ops.kernels`` K5 wrapper on CPU tensors) against the
JAX package, on the same numpy inputs.

Tolerances:
  - the slot iteration, A and V after the same rounds: <= 1e-5 relative
    to max|A| (fp32 rounding of the same rotations in another order);
  - ``jacobi_eigh`` against the fp64 oracle, as the JAX package's own
    test holds its Jacobi (``tests/test_jacobi_eigh.py``): eigenvalues,
    ``max|Q^T Q - I|`` and reconstruction <= 5e-5 relative to the
    largest eigenvalue (at least 1);
  - against JAX ``jacobi_eigh`` and the Pallas kernel in interpret mode:
    eigenvalues rtol 1e-5 / atol 1e-6, eigenvectors rtol 1e-4 / atol
    1e-5 (the interpret-vs-vmapped tolerances of that test). An
    eigenvector moves by ~(rounding x |A|) / (eigenvalue gap), so columns
    are compared where the gap to both neighbours is >= 1e-2 of the
    largest eigenvalue; below that the two rounding orders alone move
    them by up to 2.4e-5 (measured, n = 17, gap 5e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.ops import linalg as JL
from distributed_kfac_pytorch_tpu.ops import pallas_kernels as PK
from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
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


def _spd(n: int, seed: int, count: int | None = None) -> np.ndarray:
    rng = np.random.RandomState(seed)
    shape = (n, n) if count is None else (count, n, n)
    a = rng.randn(*shape).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) / n


def _separated(d: np.ndarray, gap: float = 1e-2) -> np.ndarray:
    """Mask of eigenvalues at least ``gap`` (relative) from both
    neighbours: only there is an eigenvector defined up to sign."""
    scale = max(1.0, float(np.abs(d).max()))
    diff = np.diff(d) > gap * scale
    left = np.concatenate([[True], diff])
    right = np.concatenate([diff, [True]])
    return left & right


def _check_vectors(q, q_ref, d_ref):
    """Eigenvector columns up to sign, where eigenvalues are separated."""
    keep = _separated(d_ref)
    sign = np.sign(np.sum(q * q_ref, axis=0))
    sign[sign == 0] = 1.0
    np.testing.assert_allclose((q * sign)[:, keep], q_ref[:, keep],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('n', [2, 4, 8, 16])
def test_slot_iteration_matches_jax(n):
    m = _spd(n, n)
    sweeps = 3
    a_t, v_t = L.jacobi_slot_iteration(torch.from_numpy(m), torch.eye(n),
                                       sweeps)
    a_j, v_j = JL.jacobi_slot_iteration(jnp.asarray(m),
                                        jnp.eye(n, dtype=jnp.float32),
                                        sweeps)
    scale = np.abs(m).max()
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('n', [1, 2, 3, 8, 17, 33])
def test_jacobi_eigh_matches_fp64_oracle(n):
    m = _spd(n, n)
    q, d = L.jacobi_eigh(torch.from_numpy(m))
    q, d = q.numpy(), d.numpy()
    ref = np.linalg.eigvalsh(m.astype(np.float64))
    scale = max(1.0, np.abs(ref).max())
    assert q.shape == (n, n) and d.shape == (n,)
    assert np.abs(d - ref).max() / scale < 5e-5
    assert (d[:-1] <= d[1:]).all()                  # ascending
    assert np.abs(q.T @ q - np.eye(n)).max() < 5e-5
    assert np.abs(q @ np.diag(d) @ q.T - m).max() / scale < 5e-5


@pytest.mark.parametrize('n', [1, 2, 3, 8, 17, 33])
def test_jacobi_eigh_matches_jax(n):
    m = _spd(n, 100 + n)
    q_t, d_t = L.jacobi_eigh(torch.from_numpy(m))
    q_j, d_j = JL.jacobi_eigh(jnp.asarray(m))
    d_j = np.asarray(d_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-6)
    _check_vectors(q_t.numpy(), np.asarray(q_j), d_j)


@pytest.mark.parametrize('n', [1, 2, 3, 8, 17, 33])
def test_batched_eigh_jacobi_matches_pallas_interpret(n):
    stack = _spd(n, 200 + n, count=2)
    q_t, d_t = L.batched_eigh(torch.from_numpy(stack), 'jacobi', clip=0.0)
    q_p, d_p = PK.batched_jacobi_eigh(jnp.asarray(stack), force_pallas=True,
                                      interpret=True)
    d_p = np.maximum(np.asarray(d_p), 0.0)
    np.testing.assert_allclose(d_t.numpy(), d_p, rtol=1e-5, atol=1e-6)
    for b in range(2):
        _check_vectors(q_t[b].numpy(), np.asarray(q_p[b]), d_p[b])


def test_batched_eigh_jacobi_clips_and_takes_sweeps():
    m = np.diag(np.array([-1e-3, 0.5, 2.0], np.float32))[None]
    _, d = L.batched_eigh(torch.from_numpy(m), 'jacobi', clip=0.0)
    np.testing.assert_array_equal(d.numpy(), [[0.0, 0.5, 2.0]])
    # Zero sweeps: the diagonal is the eigenvalues of the input as is.
    dense = _spd(6, 7)[None]
    _, d0 = L.batched_eigh(torch.from_numpy(dense), 'jacobi', clip=None,
                           sweeps=0)
    np.testing.assert_allclose(d0.numpy()[0], np.sort(np.diag(dense[0])))


@pytest.mark.parametrize('n_pad', [2, 4, 6, 8, 14, 652])
def test_slot_table_is_the_plain_exchange(n_pad):
    dest = K.jacobi_slot_dest(n_pad)
    assert dest.dtype == torch.int32
    assert sorted(dest.tolist()) == list(range(n_pad))
    m = torch.randn(3, n_pad, n_pad)
    moved = torch.empty_like(m)
    moved[:, :, dest.long()] = m                    # slot k -> dest[k]
    if n_pad == 2:                                  # no exchange at p = 1
        assert torch.equal(moved, m)
    else:
        assert torch.equal(moved, L.jacobi_exchange(m, -1))
        rows = torch.empty_like(m)
        rows[:, dest.long(), :] = m
        assert torch.equal(rows, L.jacobi_exchange(m, -2))


def test_cpu_tensor_runs_the_plain_version_and_counts_no_launch():
    stack = torch.from_numpy(_spd(9, 3, count=3))
    K.reset_launches()
    q, d = K.batched_jacobi_eigh(stack)
    q_ref, d_ref = K.batched_jacobi_eigh_plain(stack)
    assert torch.equal(q, q_ref) and torch.equal(d, d_ref)
    assert K.LAUNCHES['jacobi_eigh'] == 0
    assert K.KERNEL_INFO['jacobi_eigh']['source'].endswith('jacobi_eigh.cu')
    assert 'jacobi_eigh' in K.SOURCES


def test_resolve_eigh_method_aliases_warm():
    assert [L.resolve_eigh_method(m) for m in
            ('auto', 'warm', 'xla', 'jacobi')] == ['auto', 'auto', 'xla',
                                                   'jacobi']
    assert [L.default_jacobi_sweeps(n) for n in (2, 512, 513, 650, 1024,
                                                 1025)] == [
        JL.default_jacobi_sweeps(n) for n in (2, 512, 513, 650, 1024, 1025)]
