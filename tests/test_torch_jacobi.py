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


# ---------------------------------------------------------------------------
# The cluster path's two facts and its plan (csrc/jacobi_eigh.cu)
# ---------------------------------------------------------------------------

def _a_rounds_with_log(a, sweeps):
    """A's rounds of ``jacobi_slot_iteration`` alone, logging each round's
    ``(c, s)``."""
    n_pad = a.shape[-1]
    p = n_pad // 2
    log = []
    for _ in range(sweeps * (n_pad - 1)):
        d = torch.diagonal(a, dim1=-2, dim2=-1)
        apq = torch.diagonal(a[..., :p, p:], dim1=-2, dim2=-1)
        c, s = L.jacobi_rotation(d[..., :p], d[..., p:], apq)
        log.append((c, s))
        a = L._rotate_halves(L._rotate_halves(a, c, s, -2), c, s, -1)
        if p > 1:
            a = L.jacobi_exchange(L.jacobi_exchange(a, -2), -1)
    return a, log


def _v_from_log(log, n_pad, ring_storage):
    """V from the log: columns rotated and exchanged as the plain loop does
    them, or (``ring_storage``) kept in place at the kernels' ring indices
    (slot k's column at 1 + (pos[k] - r) mod (n_pad - 1), slot 0's at 0)
    and gathered into slot order at the end."""
    p = n_pad // 2
    v = torch.eye(n_pad)
    if not ring_storage:
        for c, s in log:
            v = L._rotate_halves(v, c, s, -1)
            if p > 1:
                v = L.jacobi_exchange(v, -1)
        return v
    pos = K.jacobi_ring_position(n_pad).long()
    m = n_pad - 1

    def index(r):
        return torch.where(pos < 0, 0, (pos - r) % m + 1)

    v = v[:, torch.argsort(index(0))]               # storage order
    for r, (c, s) in enumerate(log):
        idx = index(r)
        lo, hi = v[:, idx[:p]], v[:, idx[p:]]
        v[:, idx[:p]] = c * lo - s * hi
        v[:, idx[p:]] = s * lo + c * hi
    return v[:, index(len(log))]


@pytest.mark.parametrize('ring_storage', [False, True])
@pytest.mark.parametrize('n', [2, 9, 12])
def test_split_iteration_is_bitwise(n, ring_storage):
    """A's rounds logging (c, s), then V from the log, give the joint
    iteration's A and V bit for bit (odd n through the pad)."""
    a0, v0 = L.jacobi_pad(torch.from_numpy(_spd(n, 300 + n)))
    sweeps = 3
    a_ref, v_ref = L.jacobi_slot_iteration(a0, v0, sweeps)
    a, log = _a_rounds_with_log(a0, sweeps)
    v = _v_from_log(log, a0.shape[-1], ring_storage)
    assert torch.equal(a, a_ref)
    assert torch.equal(v, v_ref)


@pytest.mark.parametrize('n_pad', [2, 4, 6, 10, 652])
def test_ring_order_plus_offset_is_repeated_exchange(n_pad):
    ring = K.jacobi_ring_order(n_pad)
    pos = K.jacobi_ring_position(n_pad)
    assert ring.dtype == pos.dtype == torch.int32
    m = n_pad - 1
    assert sorted(ring.tolist()) == list(range(1, n_pad))
    assert pos[0] == -1 and torch.equal(
        pos[ring.long()], torch.arange(m, dtype=torch.int32))
    x = torch.arange(n_pad)
    for r in range(3 * n_pad + 2):
        # Slot k holds what slot ring[(pos[k] - r) mod m] held at the start.
        got = torch.where(pos < 0, 0, ring[((pos - r) % m).long()])
        if r in (0, 1, 5, m, n_pad, 2 * m + 3, 3 * n_pad + 1):
            assert torch.equal(got, x), (n_pad, r)
        if n_pad > 2:
            x = L.jacobi_exchange(x, 0)


def test_cluster_plan_fits_and_picks_the_smallest_cluster():
    limit = K._SMEM_PER_BLOCK - K._SMEM_RESERVE
    cap = K.jacobi_cluster_capacity()
    assert cap == 664
    for n_pad in range(2, cap + 1, 2):
        p = n_pad // 2
        plan = K.jacobi_cluster_plan(n_pad, 16, 12 * (n_pad - 1))
        assert plan is not None, n_pad
        assert plan.smem_bytes == K.jacobi_cluster_bytes(n_pad, plan.cluster)
        assert plan.smem_bytes <= limit
        assert plan.pairs_per_cta * plan.cluster >= p
        assert plan.cluster == 1 or p >= 2 * plan.cluster
        smaller = [c for c in (1, 2, 4, 8) if c < plan.cluster]
        assert all(K.jacobi_cluster_bytes(n_pad, c) > limit or p < 2 * c
                   for c in smaller), n_pad
        assert 1 <= plan.v_rows <= n_pad
        assert plan.v_smem_bytes <= K._SMEM_PER_SM // 2 - K._SMEM_RESERVE
    for n_pad in (cap + 2, cap + 4, 700, 1024, 4608):
        assert K.jacobi_cluster_plan(n_pad, 4, 100) is None
    assert K.jacobi_cluster_plan(652, 16, 13 * 651).cluster == 8
    assert K.jacobi_cluster_plan(650, 16, 13 * 649).cluster == 8
    assert K.jacobi_cluster_plan(288, 10, 12 * 287).cluster == 2
    assert K.jacobi_cluster_plan(144, 11, 12 * 143).cluster == 1
    with pytest.raises(ValueError):
        K.jacobi_cluster_plan(651, 1, 1)


@pytest.mark.parametrize('n_pad,batch,rounds', [
    (652, 16, 13 * 651), (652, 200, 13 * 651), (576, 1000, 13 * 575),
    (64, 70000, 12 * 63), (2, 5, 0)])
def test_cluster_plan_log_chunks_within_budget(n_pad, batch, rounds):
    plan = K.jacobi_cluster_plan(n_pad, batch, rounds)
    per_matrix = 8 * max(1, rounds) * (n_pad // 2)
    assert 1 <= plan.chunk <= min(batch, 65535)
    assert plan.log_bytes == plan.chunk * per_matrix
    assert plan.log_bytes <= K._JACOBI_LOG_BYTES
    # As many matrices per chunk as the budget allows.
    assert plan.chunk == min(batch, 65535) or \
        (plan.chunk + 1) * per_matrix > K._JACOBI_LOG_BYTES
