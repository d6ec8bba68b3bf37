"""Dense linear algebra for K-FAC factor inversion (PyTorch port of
``distributed_kfac_pytorch_tpu/ops/linalg.py``).

Every function takes leading batch dims: a same-size factor stack is one
call. Decompositions run in fp32 whatever the storage dtype. The warm
polish is matmul-only; with the port's entry points TF32 is off, so
``torch.matmul`` on fp32 runs in full fp32 -- the counterpart of the JAX
package's ``Precision.HIGHEST``.

The Brent--Luk Jacobi eigh (:func:`jacobi_eigh`) is the plain version of
the Jacobi kernel (``ops.kernels.batched_jacobi_eigh``, K5).

The randomized low-rank path (:func:`lowrank_eigh`, the *Randomized
K-FACs* recipe) keeps a rank-``r`` truncated eigenpair ``Q (n, r)``, ``d
(r,)`` of a large factor; every precondition function takes such a
*truncated* basis beside full-rank ones, with the discarded tail's
eigenvalues taken as 0 (the damping-only complement ``I / l`` on it).

The precondition functions take the JAX ``compute_dtype`` (None, fp32 or
bf16 operands, fp32 accumulation) and read slots stored in bf16 widened.
"""

from __future__ import annotations

import torch

from distributed_kfac_pytorch_tpu_torch.observability import profiling


def decomposition_cost(dim: int, count: int = 1,
                       rank: int | None = None) -> float:
    """Cost proxy of decomposing ``count`` SPD matrices of ``dim``: the
    ``dim^3`` scaling every dense factorization here shares, the cost
    model of the chunk planners; ``rank`` (a low-rank decomposition,
    :func:`lowrank_eigh`) makes it ``rank * dim^2``."""
    if rank:
        return float(count) * float(rank) * float(dim) ** 2
    return float(count) * float(dim) ** 3


def get_eigendecomp(x: torch.Tensor, clip: float | None = 0.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition in fp32, eigenvalues ascending and
    floored at ``clip``; returns ``(Q, d)``."""
    d, q = torch.linalg.eigh(x.float())
    if clip is not None:
        d = torch.clamp(d, min=clip)
    return q, d


def _sign(x: torch.Tensor) -> torch.Tensor:
    """+1 where ``x >= 0`` (sign(0) = +1), else -1."""
    return torch.where(x >= 0, 1.0, -1.0)


def default_jacobi_sweeps(n: int) -> int:
    """Sweep count reaching fp32 roundoff: 12 up to n=512, +log2 beyond."""
    return 12 if n <= 512 else 12 + max(0, (n - 1).bit_length() - 9)


def jacobi_rotation(app: torch.Tensor, aqq: torch.Tensor,
                    apq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pair ``(c, s)`` of the Jacobi rotation zeroing ``apq``: ``tau =
    (aqq - app) / (2 apq)`` (``t = 0`` where ``|apq| <= 1e-30``), ``t =
    sign(tau) / (|tau| + sqrt(1 + tau^2))`` with sign(0) = +1 (equal
    diagonals take the full 45-degree rotation), ``c = 1 / sqrt(1 + t^2)``,
    ``s = t c``."""
    small = apq.abs() <= 1e-30
    tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
    t = _sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _rotate_halves(m: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Mix the two halves of ``m`` along ``dim`` (-2: rows, -1: columns)
    with per-pair ``(c, s)``: ``[c lo - s hi, s lo + c hi]``."""
    p = m.shape[dim] // 2
    lo, hi = m.narrow(dim, 0, p), m.narrow(dim, p, p)
    c, s = (c[..., :, None], s[..., :, None]) if dim == -2 else (
        c[..., None, :], s[..., None, :])
    return torch.cat([c * lo - s * hi, s * lo + c * hi], dim=dim)


def jacobi_exchange(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Brent--Luk systolic move to the next pairing along ``dim``:
    tops' = [t0, b0, t1..t_{p-2}]; bots' = [b1..b_{p-1}, t_{p-1}]."""
    p = m.shape[dim] // 2
    t, b = m.narrow(dim, 0, p), m.narrow(dim, p, p)
    return torch.cat([t.narrow(dim, 0, 1), b.narrow(dim, 0, 1),
                      t.narrow(dim, 1, p - 2), b.narrow(dim, 1, p - 1),
                      t.narrow(dim, p - 1, 1)], dim=dim)


def jacobi_slot_iteration(a: torch.Tensor, v: torch.Tensor, sweeps: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Brent--Luk Jacobi inner loop over an even-dim slot-basis pair
    (any leading batch dims): ``sweeps * (n - 1)`` rounds, each pairing
    slot ``i`` with slot ``p + i`` (``p = n / 2``), rotating the paired
    halves of ``a`` (rows, then columns) and of ``v`` (columns), then
    moving to the next tournament pairing with :func:`jacobi_exchange`.

    Returns ``(a, v)``: ``a`` ~diagonal in the final slot order and the
    columns of ``v`` the matching eigenvector candidates.
    """
    n_pad = a.shape[-1]
    p = n_pad // 2
    a, v = a.float(), v.float()
    for _ in range(sweeps * (n_pad - 1)):
        d = torch.diagonal(a, dim1=-2, dim2=-1)
        apq = torch.diagonal(a[..., :p, p:], dim1=-2, dim2=-1)
        c, s = jacobi_rotation(d[..., :p], d[..., p:], apq)
        a = _rotate_halves(_rotate_halves(a, c, s, -2), c, s, -1)
        v = _rotate_halves(v, c, s, -1)
        if p > 1:
            a = jacobi_exchange(jacobi_exchange(a, -2), -1)
            v = jacobi_exchange(v, -1)
    return a, v


def jacobi_pad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot iteration's start ``(a, v)`` for a ``(..., n, n)`` stack
    (``n >= 2``): fp32 copies at even size ``n_pad = n + n % 2``, odd ``n``
    padded with a decoupled unit eigenvalue, and ``v`` the identity."""
    n = x.shape[-1]
    n_pad = n + n % 2
    a = x.new_zeros((*x.shape[:-2], n_pad, n_pad), dtype=torch.float32)
    a[..., :n, :n] = x
    if n_pad != n:
        a[..., n, n] = 1.0
    v = torch.eye(n_pad, dtype=torch.float32, device=x.device).expand_as(
        a).clone()
    return a, v


def jacobi_finish(d: torch.Tensor, v: torch.Tensor, n: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort the slot-order eigenpairs ``(v, d)`` ascending (stably, as
    ``jnp.argsort``) and, for a padded stack, drop the pad eigenpair, whose
    eigenvector is exactly ``e_n``. Returns ``(Q, d)``."""
    order = torch.argsort(d, dim=-1, stable=True)
    d = torch.gather(d, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand_as(v))
    if v.shape[-1] != n:
        # The kept columns' positions, in order (no host sync).
        drop = (v[..., n, :] >= 0.5).to(torch.int32)
        idx = torch.argsort(drop, dim=-1, stable=True)[..., :n]
        v = torch.gather(v[..., :n, :], -1,
                         idx[..., None, :].expand(*idx.shape[:-1], n, n))
        d = torch.gather(d, -1, idx)
    return v, d


def jacobi_eigh(x: torch.Tensor, sweeps: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of a ``(..., n, n)`` stack by
    Brent--Luk parallel Jacobi (the JAX ``jacobi_eigh``, batched): ``(Q,
    d)`` with eigenvalues ascending. ``sweeps`` defaults to
    :func:`default_jacobi_sweeps` of ``n``."""
    n = x.shape[-1]
    x = x.float()
    if sweeps is None:
        sweeps = default_jacobi_sweeps(n)
    if n == 1:
        return torch.ones_like(x), x.reshape(*x.shape[:-2], 1).clone()
    a, v = jacobi_slot_iteration(*jacobi_pad(x), sweeps)
    return jacobi_finish(torch.diagonal(a, dim1=-2, dim2=-1), v, n)


def resolve_eigh_method(method: str) -> str:
    """The eigh-method alias: ``'warm'`` behaves as ``'auto'`` (polish when
    a previous basis exists, the library eigh when not)."""
    return 'auto' if method in ('auto', 'warm') else method


def eigh_polish(a: torch.Tensor, q_prev: torch.Tensor, iters: int = 16,
                theta: float = 0.8, t_max: float = 0.2,
                ns_steps: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start symmetric eigendecomposition by basis polishing.

    The JAX ``eigh_polish``: per iteration, rotate into the current basis
    ``B = Q^T a Q``, take the clipped simultaneous Jacobi tangents of its
    off-diagonal pairs as a skew ``X``, rescale ``X`` to spectral norm at
    most ``theta`` (power iteration on ``-X^2``), update ``Q <- Q (I + X)``
    and re-orthonormalize with ``ns_steps`` Newton--Schulz steps. Returns
    ``(Q, d)`` with eigenvalues in tracked (not sorted) order. Within a
    tight eigenvalue cluster the basis may mix members; the preconditioner
    is flat across such clusters, so compare ``Q diag(d) Q^T``, not ``Q``.
    """
    a = a.float()
    q = q_prev.float()
    n = q.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        b = q.mT @ (a @ q)
        b = 0.5 * (b + b.mT)
        d = torch.diagonal(b, dim1=-2, dim2=-1)
        e = b - torch.diag_embed(d)
        delta = d[..., None, :] - d[..., :, None]     # d_j - d_i
        abs_e = e.abs()
        tau = delta / torch.clamp(2.0 * abs_e, min=1e-30)
        t = _sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.clamp(t, -t_max, t_max)
        x = _sign(e) * t * (abs_e > 1e-30)
        x = torch.triu(x, 1)
        x = x - x.mT
        v = torch.full((*x.shape[:-1], 1), 1.0 / n, dtype=torch.float32,
                       device=a.device)
        for _ in range(10):
            w = x @ (x @ v)
            v = -w / torch.clamp(torch.linalg.vector_norm(
                w, dim=(-2, -1), keepdim=True), min=1e-30)
        nrm = torch.sqrt(torch.linalg.vector_norm(
            x @ (x @ v), dim=(-2, -1), keepdim=True))
        x = x * torch.clamp(theta / torch.clamp(nrm, min=1e-30), max=1.0)
        q = q + q @ x
        for _ in range(ns_steps):
            q = 0.5 * (q @ (3.0 * eye - q.mT @ q))
    d = torch.diagonal(q.mT @ (a @ q), dim1=-2, dim2=-1)
    return q, d


def batched_eigh(stack: torch.Tensor, method: str = 'xla',
                 clip: float | None = 0.0,
                 sweeps: int | None = None,
                 q_prev: torch.Tensor | None = None,
                 polish_iters: int = 16
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecompose a ``(B, n, n)`` SPD stack: ``(Q, d)``.

    ``'xla'`` is the library eigh (``torch.linalg.eigh``, ascending);
    ``'jacobi'`` the Brent--Luk Jacobi eigh (ascending) through
    ``ops.kernels.batched_jacobi_eigh`` -- the CUDA kernel for a stack on
    the card, :func:`jacobi_eigh` on the CPU; ``'warm'`` requires
    ``q_prev`` and runs :func:`eigh_polish` (eigenvalues in tracked
    order); ``'auto'`` picks ``'warm'`` when ``q_prev`` is given, else
    ``'xla'``.
    """
    if method == 'auto':
        method = 'warm' if q_prev is not None else 'xla'
    if method == 'warm':
        if q_prev is None:
            raise ValueError("eigh method 'warm' requires q_prev")
        with profiling.annotate('kfac/eigh/warm'):
            qs, ds = eigh_polish(stack, q_prev, iters=polish_iters)
    elif method == 'jacobi':
        from distributed_kfac_pytorch_tpu_torch.ops import kernels
        with profiling.annotate('kfac/eigh/jacobi'):
            qs, ds = kernels.batched_jacobi_eigh(stack, sweeps)
    elif method == 'xla':
        with profiling.annotate('kfac/eigh/xla'):
            return get_eigendecomp(stack, clip=clip)
    else:
        raise ValueError("eigh method must be 'auto', 'xla', 'jacobi' or "
                         f"'warm', got {method!r}")
    if clip is not None:
        ds = torch.clamp(ds, min=clip)
    return qs, ds


def lowrank_sketch(n: int, rank: int, seed: int = 0,
                   device='cuda') -> torch.Tensor:
    """The cold path's Gaussian test matrix ``(n, rank)``: drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, then moved to
    ``device`` (default ``'cuda'``; the CPU when asked for), so the CPU
    and the card draw the same values."""
    from distributed_kfac_pytorch_tpu_torch import resolve_device
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(n, rank, generator=gen).to(resolve_device(device))


def lowrank_eigh(a: torch.Tensor, rank: int,
                 q_prev: torch.Tensor | None = None,
                 power_iters: int = 2, polish_iters: int = 8,
                 seed: int = 0, sketch: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-``rank`` truncated eigendecomposition of SPD matrices (any
    leading batch dims): ``(Q, d)`` with ``Q (..., n, rank)`` orthonormal
    columns and ``d (..., rank)`` their Rayleigh eigenvalues. The JAX
    ``lowrank_eigh``, batched.

    Warm (``q_prev``, the carried ``(..., n, rank)`` bases): one subspace
    step ``Q0 = orth(A q_prev)`` by QR, one projection ``B0 = Q0^T A Q0``,
    :func:`eigh_polish` of the ``rank x rank`` ``B0`` from the identity
    (``polish_iters`` iterations), then ``Q = Q0 Z`` (eigenvalues in
    tracked order). Cold: ``Y = A S`` for the Gaussian sketch ``S``
    (:func:`lowrank_sketch` of ``seed``, the same for every matrix of the
    batch; ``sketch``, a port-only argument, passes another draw, such
    as the JAX package's), ``power_iters`` steps ``Y <- A orth(Y)``, then
    a Rayleigh--Ritz ``eigh`` of ``Q0^T A Q0`` (ascending). Every product
    is fp32 (the port's entry points turn TF32 off). Raises unless ``0 <
    rank < n``.
    """
    a = a.float()
    n = a.shape[-1]
    if not 0 < rank < n:
        raise ValueError(
            f'lowrank_eigh needs 0 < rank < dim, got rank={rank} dim={n}')
    if q_prev is not None:
        q0, _ = torch.linalg.qr(a @ q_prev.float())
        b0 = q0.mT @ (a @ q0)
        b0 = 0.5 * (b0 + b0.mT)
        eye = torch.eye(rank, dtype=torch.float32, device=a.device)
        z, d = eigh_polish(b0, eye.expand_as(b0), iters=polish_iters)
        return q0 @ z, d
    if sketch is None:
        sketch = lowrank_sketch(n, rank, seed, a.device)
    y = a @ sketch.float()
    for _ in range(max(0, power_iters)):
        q0, _ = torch.linalg.qr(y)
        y = a @ q0
    q0, _ = torch.linalg.qr(y)
    b = q0.mT @ (a @ q0)
    d, u = torch.linalg.eigh(0.5 * (b + b.mT))
    return q0 @ u, d


def batched_lowrank_eigh(stack: torch.Tensor, rank: int,
                         q_prev: torch.Tensor | None = None,
                         power_iters: int = 2, polish_iters: int = 8,
                         clip: float | None = 0.0, seed: int = 0,
                         sketch: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`lowrank_eigh` of a ``(B, n, n)`` stack, warm from the
    ``(B, n, rank)`` ``q_prev`` or cold from the sketch, with the
    eigenvalues floored at ``clip``: ``(Q (B, n, rank), d (B, rank))``."""
    with profiling.annotate('kfac/eigh/lowrank'):
        qs, ds = lowrank_eigh(stack, rank, q_prev=q_prev,
                              power_iters=power_iters,
                              polish_iters=polish_iters, seed=seed,
                              sketch=sketch)
    if clip is not None:
        ds = torch.clamp(ds, min=clip)
    return qs, ds


@profiling.scope('kfac/inverse/cholesky')
def get_inverse(x: torch.Tensor, damping=None) -> torch.Tensor:
    """Damped SPD inverse ``(x + damping I)^-1`` in fp32 by Cholesky: a
    triangular solve of the factor against ``I``, then ``inv_l^T @
    inv_l``. A matrix that is not positive definite in fp32 gets a NaN
    inverse, as the JAX package's Cholesky gives (no error, no host
    sync)."""
    x = x.float()
    eye = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    if damping is not None:
        x = x + damping * eye
    chol, info = torch.linalg.cholesky_ex(x)
    chol = torch.where((info == 0)[..., None, None], chol, float('nan'))
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
    return inv_l.mT @ inv_l


def newton_schulz_inverse(x: torch.Tensor, damping=None, iters: int = 100,
                          tol: float = 1e-5, *, with_iters: bool = False):
    """Damped SPD inverse by Newton--Schulz iteration, per matrix of any
    leading batch dims.

    ``M = x + damping I``, ``X_0 = I / max(max row abs sum of M, 1e-30)``;
    while ``k < iters`` and ``res > tol``: ``Y = M X``, ``res = max|Y -
    I|`` (the residual of the iterate before the update), ``X <- 2X -
    XY``. Each matrix stops on its own, as a vmapped ``while_loop`` does;
    a NaN residual stops it. With ``with_iters`` also returns the int32
    iterations run per matrix.
    """
    x = x.float()
    n = x.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=x.device)
    m = x if damping is None else x + damping * eye
    bound = torch.clamp(m.abs().sum(-1).amax(-1), min=1e-30)
    xk = eye / bound[..., None, None]
    res = torch.full(bound.shape, float('inf'), device=x.device)
    k_run = torch.zeros(bound.shape, dtype=torch.int32, device=x.device)
    for _ in range(iters):
        active = res > tol
        if not bool(active.any()):
            break
        y = m @ xk
        r = (y - eye).abs().amax((-2, -1))
        xk = torch.where(active[..., None, None], 2.0 * xk - xk @ y, xk)
        res = torch.where(active, r, res)
        k_run += active.to(torch.int32)
    return (xk, k_run) if with_iters else xk


def get_elementwise_inverse(v: torch.Tensor, damping=None) -> torch.Tensor:
    """Reciprocal of each nonzero element of ``v + damping`` (zeros stay
    zero): the inverse of a diagonal factor (embedding A)."""
    if damping is not None:
        v = v + damping
    nonzero = v != 0.0
    return torch.where(nonzero, 1.0 / torch.where(nonzero, v, 1.0), 0.0)


def truncated_side(q: torch.Tensor) -> bool:
    """Whether an eigenbasis is truncated: ``(..., n, r)`` with ``r <
    n`` (:func:`lowrank_eigh`)."""
    return q.shape[-1] < q.shape[-2]


def _precond_operand(compute_dtype):
    """The operand rounding of a non-default precondition compute dtype
    (the JAX ``_precond_mm``): ``torch.float32`` keeps fp32 operands
    (strict fp32: the port's entry points turn TF32 off);
    ``torch.bfloat16`` rounds each operand to bf16 and keeps it in an fp32
    tensor. Every product is then an fp32 ``torch.matmul``: the products
    of bf16 values are exact in fp32 and the sums accumulate in fp32, the
    JAX ``preferred_element_type=float32`` contract (a bf16
    ``torch.matmul`` on the card would round its output to bf16)."""
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    bf16 = kernels.mult_bf16(compute_dtype)
    return lambda t: kernels._round(t, bf16)


@profiling.scope('kfac/precond/eigen')
def precondition_eigen(grad: torch.Tensor, qa: torch.Tensor,
                       qg: torch.Tensor, da: torch.Tensor, dg: torch.Tensor,
                       damping, compute_dtype=None) -> torch.Tensor:
    """Eigenbasis preconditioning ``QG ((QG^T grad QA) / (dG dA^T + l))
    QA^T``, returning fp32.

    ``compute_dtype`` None reads every operand widened to fp32 (the
    default path); ``torch.float32`` / ``torch.bfloat16`` round the four
    products' operands as :func:`_precond_operand` says, in the JAX
    association ``QG^T (grad QA)`` and ``QG (V2 QA^T)``, while the damping
    quotient stays fp32 on the stored (possibly bf16-rounded)
    eigenvalues.

    With a truncated side (:func:`truncated_side`) the discarded tail's
    eigenvalues are 0, and the quotient splits into the captured block and
    a damping-only complement: ``grad / l + QG (C / (dG dA^T + l) - C / l)
    QA^T`` for ``C = QG^T grad QA`` (the complement in fp32, the thin
    products' operands rounded as above). A square / square pair keeps
    the formula above."""
    truncated = truncated_side(qa) or truncated_side(qg)
    if compute_dtype is None:
        qa, qg = qa.float(), qg.float()
        v1 = qg.mT @ grad.float() @ qa
        v2 = v1 / (dg.float()[..., :, None] * da.float()[..., None, :]
                   + damping)
        if not truncated:
            return qg @ v2 @ qa.mT
        return grad.float() / damping + qg @ (v2 - v1 / damping) @ qa.mT
    r = _precond_operand(compute_dtype)
    qa, qg = r(qa), r(qg)
    v1 = qg.mT @ (r(grad) @ qa)
    denom = dg.float()[..., :, None] * da.float()[..., None, :] + damping
    if not truncated:
        return qg @ (r(v1 / denom) @ qa.mT)
    mid = r(v1 / denom - v1 / damping)
    return grad.float() / damping + qg @ (mid @ qa.mT)


@profiling.scope('kfac/precond/inv')
def precondition_inv(grad: torch.Tensor, a_inv: torch.Tensor,
                     g_inv: torch.Tensor, compute_dtype=None
                     ) -> torch.Tensor:
    """Inverse-method preconditioning ``G_inv @ grad @ A_inv``, fp32
    (``compute_dtype`` as in :func:`precondition_eigen`)."""
    if compute_dtype is None:
        return g_inv.float() @ grad.float() @ a_inv.float()
    r = _precond_operand(compute_dtype)
    return r(g_inv) @ (r(grad) @ r(a_inv))


@profiling.scope('kfac/precond/diag_a')
def precondition_diag_a(grad: torch.Tensor, a_inv_diag: torch.Tensor,
                        g_inv: torch.Tensor, compute_dtype=None
                        ) -> torch.Tensor:
    """Preconditioning with a diagonal A inverse (embedding layers):
    ``(A_inv[:, None] * grad) @ G_inv`` for a ``(vocab, dim)`` gradient.
    The diagonal scale runs in fp32; ``compute_dtype`` rounds the G-side
    product's operands."""
    scaled = a_inv_diag.float()[:, None] * grad.float()
    if compute_dtype is None:
        return scaled @ g_inv.float()
    r = _precond_operand(compute_dtype)
    return r(scaled) @ r(g_inv)


def eigen_side_inverse(q: torch.Tensor, d: torch.Tensor,
                       damping) -> torch.Tensor:
    """Damped inverse from an eigendecomposition: ``Q diag(1/(d + l))
    Q^T``; for a truncated ``(n, r)`` basis the inverse of the operator
    whose tail eigenvalues are 0, ``I / l + Q diag(1/(d + l) - 1/l)
    Q^T``."""
    q = q.float()
    if truncated_side(q):
        eye = torch.eye(q.shape[-2], dtype=torch.float32, device=q.device)
        scale = 1.0 / (d.float() + damping) - 1.0 / damping
        return eye / damping + (q * scale[..., None, :]) @ q.mT
    return (q * (1.0 / (d.float() + damping))[..., None, :]) @ q.mT


def precondition_dispatch(grad: torch.Tensor, entry: dict, damping,
                          diag_a: torch.Tensor | None = None,
                          compute_dtype=None) -> torch.Tensor:
    """Per-layer preconditioning dispatched on the inverse slots present:
    both sides eigen (no baked inverse) -> :func:`precondition_eigen` with
    the live damping; any baked inverse -> :func:`precondition_inv`.

    ``diag_a``: the diagonal A inverse of an embedding layer (damping
    baked in); ``entry`` then supplies the G side, baked (``G_inv``,
    :func:`precondition_diag_a`) or eigen (``diag_a[:, None] * ((grad QG)
    / (dG + damping)) QG^T``; a truncated ``QG`` adds the complement,
    ``diag_a[:, None] * (grad / l + (V - grad QG / l) QG^T)`` for that
    ``V``). ``compute_dtype`` reaches every branch (the JAX
    ``precondition_dispatch``); slots may be stored in bf16."""
    if diag_a is not None:
        if 'G_inv' in entry:
            return precondition_diag_a(grad, diag_a, entry['G_inv'],
                                       compute_dtype=compute_dtype)
        with profiling.annotate('kfac/precond/diag_a_eigen'):
            return _precondition_diag_a_eigen(grad, entry, damping,
                                              diag_a, compute_dtype)
    if 'A_inv' not in entry and 'G_inv' not in entry:
        return precondition_eigen(grad, entry['QA'], entry['QG'],
                                  entry['dA'], entry['dG'], damping,
                                  compute_dtype=compute_dtype)
    return precondition_inv(grad, entry['A_inv'], entry['G_inv'],
                            compute_dtype=compute_dtype)


def _precondition_diag_a_eigen(grad: torch.Tensor, entry: dict, damping,
                               diag_a: torch.Tensor,
                               compute_dtype) -> torch.Tensor:
    """:func:`precondition_dispatch`'s diagonal-A branch with an eigen G
    side."""
    truncated = truncated_side(entry['QG'])
    dg = entry['dG'].float()[None, :]
    if compute_dtype is None:
        qg = entry['QG'].float()
        v1 = grad.float() @ qg
        v = v1 / (dg + damping)
        if truncated:
            return diag_a.float()[:, None] * (
                grad.float() / damping + (v - v1 / damping) @ qg.T)
        return diag_a.float()[:, None] * (v @ qg.T)
    r = _precond_operand(compute_dtype)
    qg = r(entry['QG'])
    v1 = r(grad) @ qg
    v = v1 / (dg + damping)
    if truncated:
        return diag_a.float()[:, None] * (
            grad.float() / damping + r(v - v1 / damping) @ qg.T)
    return diag_a.float()[:, None] * (r(v) @ qg.T)
