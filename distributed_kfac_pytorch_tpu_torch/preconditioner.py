"""Single-device K-FAC preconditioner (PyTorch port of
``distributed_kfac_pytorch_tpu/preconditioner.py``, class ``KFAC``).

The step keeps the JAX package's functional form

    precond_grads, new_state = kfac.step(state, grads, captures,
                                         factor_update=..., inv_update=...)

over plain dicts of tensors, so a test can compare the state key by key.
``state`` is ``{'step': int, 'factors': {layer: {'A', 'G'}}, 'inverses':
{layer: {...}}, 'inv_chunk_phase': int}`` (plus ``factor_accum`` /
``accum_decay`` and ``frozen_factors`` with their knobs); ``grads`` maps
parameter names (``model.named_parameters()``) to gradients, and
unregistered parameters pass through unchanged. Each step returns new factor / inverse tensors
rather than updating the old ones in place.

On the main path hand-written CUDA kernels do the work (``ops.kernels``):
the factor contraction + EMA (linear A/G and conv G), the conv-A patch
covariance, the bucketed preconditioning with the KL-clip ``v.g``
partial (eigen and baked forms), under ``'newton'`` the batched
Newton--Schulz damped inverse of each size bucket at an inverse firing,
and under ``eigh_method='jacobi'`` the batched Jacobi eigh of each eigen
size bucket.
``fused_factor_contraction`` and ``fused_precondition`` default to True
here (the JAX package defaults them off: there they are unproven TPU
study kernels); with a knob off that stage runs the stock torch path.
Conv A always goes through the patch-covariance kernel. The KL-clip scale
stays a device tensor: no host sync per layer.

Inverses follow the JAX per-dim dispatch (:meth:`KFAC.method_for_dim`):
eigen slots (``Q``, ``d``, damping applied at precondition time) or
baked damped inverses (``A_inv``/``G_inv``, damping applied at firing
time, by damped Cholesky or Newton--Schulz). With ``inv_lowrank_rank =
r > 0`` every dense factor dim at or above ``inv_lowrank_dim_threshold``
takes the randomized low-rank path instead (``'lowrank'``): a truncated
eigenpair ``Q (dim, r)``, ``d (r,)`` seeded with ``r`` identity columns and
refreshed warm from the carried basis at each firing
(``linalg.lowrank_eigh``, ``r dim^2`` work); its tail eigenvalues count as
0. A *mixed* layer (one side eigen or low-rank, the other baked) also
bakes its eigen side at the firing's damping, and is preconditioned
through its baked inverses. A shape group with a truncated basis is
preconditioned by stock torch (``linalg.precondition_dispatch``), never by
the bucketed kernel, as the JAX package dispatches it.

Embedding layers carry a diagonal A (a vector over the vocabulary, its
inverse the elementwise one, damping baked at the firing) and a dense G
under the per-dim dispatch; they are preconditioned one by one outside
the buckets, their ``v.g`` inside the KL clip. Grouped / depthwise convs
(``conv2d_grouped``) carry ``(G, d, d)`` stacks of per-group factors,
computed by stock torch (im2col + batched products); whatever
``inverse_method`` says, each side's stack gets one batched damped
Cholesky at a firing (:func:`grouped_block_inverses`), and the layer is
preconditioned on its own, ``G_inv @ V_g @ A_inv`` batched over the
groups, outside the buckets (no kernel runs for it, as in the JAX
package). ``kfac_approx`` (the
weight-sharing approximation, ``sharing.approx``) and
``tied_embeddings`` (the attend site of a tied in/out embedding feeds its
one factor pair) follow the JAX ``KFAC``, as do the reduced-precision
knobs ``factor_dtype``, ``inv_dtype``, ``capture_dtype`` and
``precond_compute_dtype`` (bf16 storage is blended and decomposed in
fp32, and rounded once on the way back).

The firing schedule follows the JAX package too: ``inv_pipeline_chunks``
spreads a firing over ``k`` cost-balanced chunks of the window
(:meth:`KFAC.inverse_chunk_plan`), ``inv_staleness=1`` decomposes a
snapshot of the window head's factors (``frozen_factors``),
``deferred_factor_reduction`` folds the factor steps into a local
accumulator (``factor_accum``, ``accum_decay``) that the window head
applies, and ``factor_batch_fraction`` thins the factor statistics within
the step (:func:`capture.subsample_captures`).
"""

from __future__ import annotations

import enum
import warnings
from typing import Any, Sequence

import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch import resolve_device, \
    set_fp32_precision
from distributed_kfac_pytorch_tpu_torch import fp16
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import CONV2D, \
    CONV2D_GROUPED, EMBEDDING, KFAC_REDUCE, LINEAR, KFACCapture, \
    subsample_captures
from distributed_kfac_pytorch_tpu_torch.observability import \
    metrics as obs_metrics
from distributed_kfac_pytorch_tpu_torch.observability import profiling
from distributed_kfac_pytorch_tpu_torch.ops import factors as F
from distributed_kfac_pytorch_tpu_torch.ops import kernels, linalg
from distributed_kfac_pytorch_tpu_torch.parallel.placement import \
    load_balance
from distributed_kfac_pytorch_tpu_torch.sharing import approx

class CommMethod(enum.Enum):
    """Communication strategy of ``parallel.DistributedKFAC`` (the JAX
    package's ``CommMethod``).

    - COMM_OPT: every rank holds all inverses and preconditions every
      layer; inverses are gathered after each firing.
    - MEM_OPT: each layer's inverses live on one rank, which
      preconditions the layer and delivers the result.
    - HYBRID_OPT: a ``grad_worker_fraction`` of the ranks per layer hold
      its inverses and precondition it; the rest receive the result
      (KAISA).
    """
    COMM_OPT = 1
    MEM_OPT = 2
    HYBRID_OPT = 3


def comm_method_of(value: CommMethod | str) -> CommMethod:
    """A :class:`CommMethod`, or its name (``'hybrid-opt'``,
    ``'HYBRID_OPT'``), as a :class:`CommMethod`."""
    if isinstance(value, str):
        return CommMethod[value.upper().replace('-', '_')]
    return CommMethod(value)


#: The dtypes of the reduced-precision knobs (``capture_dtype`` also takes
#: ``'auto'``).
PRECISION_DTYPES = (None, torch.float32, torch.bfloat16)


def check_dtype(knob: str, value, allowed=PRECISION_DTYPES) -> None:
    """Raise a ``ValueError`` naming the knob unless ``value`` is one of
    ``allowed``."""
    if not any(value is a or (a is not None and value == a)
               for a in allowed):
        raise ValueError(f'{knob} must be one of {allowed!r}, got '
                         f'{value!r}')


class KFAC:
    """K-FAC gradient preconditioner over a torch model (single device).

    Hyperparameters follow the JAX ``KFAC`` (see its docstring); every
    constructor knob of the JAX ``KFAC`` is ported.

    Args:
      model: the ``nn.Module`` to precondition; its ``nn.Linear``,
        ``nn.Conv2d`` (grouped ones as ``conv2d_grouped``) and
        ``nn.Embedding`` layers are registered at construction.
      use_eigen_decomp: True is ``inverse_method='eigen'``, False
        ``'cholesky'``; None (default) leaves ``inverse_method`` alone.
        Set with an ``inverse_method`` that contradicts it, it raises.
      inverse_method: None or ``'auto'`` (default: the eigen path for factor
        dims <= ``auto_eigen_max_dim`` -- every CIFAR ResNet factor --
        and ``auto_large_method`` damped inverses above), ``'eigen'``
        (every factor), ``'cholesky'`` or ``'newton'`` (every factor
        baked as a damped inverse; ``'newton'`` runs the Newton--Schulz
        kernel).
      auto_eigen_max_dim: largest factor dim ``'auto'`` keeps on the
        eigen path (default 640).
      auto_large_method: ``'cholesky'`` (default) or ``'newton'``: the
        damped inverse ``'auto'`` uses above ``auto_eigen_max_dim``.
      newton_iters: iteration cap of ``'newton'`` (the loop stops early
        once ``max|M X - I| <= 1e-5``).
      eigh_method: ``'auto'`` or its alias ``'warm'`` (warm-start polish
        seeded from the previous basis), ``'xla'`` (``torch.linalg.eigh``
        every firing) or ``'jacobi'`` (the Brent--Luk Jacobi eigh kernel
        every firing, cold: the previous basis is not used).
      kfac_approx: the weight-sharing approximation, ``'expand'``
        (default), ``'reduce'`` (every sequence/patch-shared layer) or a
        ``{pattern: approx}`` dict (``sharing.approx``). A Linear is
        shared when its input has more than 2 dims, which the port reads
        at the first recorded call: :attr:`specs` carry the resolved map
        from the first factor update on.
      tied_embeddings: capture the ``attend`` call of registered
        ``Embed`` modules, so a tied in/out embedding's two uses feed its
        one factor pair; None (default) turns it on exactly when
        ``kfac_approx`` names 'reduce' somewhere.
      factor_compute_dtype: ``None``/``torch.float32`` (fp32
        multiplicands) or ``torch.bfloat16`` (bf16-rounded multiplicands);
        accumulation is fp32 either way.
      factor_dtype: storage dtype of the running factors, ``None`` (fp32)
        or ``torch.bfloat16``. Contributions are fp32; the EMA widens the
        stored factor, blends in fp32 and rounds once to the storage
        dtype, on every path (K1's fused blend included).
      inv_dtype: storage dtype of the inverses, eigenbases and
        eigenvalues (default ``torch.float32``; ``torch.bfloat16``). The
        decompositions always run in fp32 on the widened factors, the
        warm polish from the stored basis widened.
      capture_dtype: dtype of the captured activations ``a`` (never the
        output-grads): ``'auto'`` (default: passthrough, as the JAX
        package off a TPU), ``None`` (passthrough) or a dtype to cast
        floating captures to.
      precond_compute_dtype: operand dtype of the precondition products
        (accumulation fp32, the eigen damping quotient fp32): ``None``
        (default: operands read widened), ``torch.float32`` (strict fp32)
        or ``torch.bfloat16`` (bf16-rounded operands); also K3's mode.
      precond_bucketing: precondition same-shape layers as one stack
        (default True); False preconditions layer by layer, each a stack
        of one (one K3 launch per layer with ``fused_precondition``).
        ``parallel.DistributedKFAC`` always stacks, as the JAX package's
        distributed path does.
      trainable: optional predicate ``trainable(name) -> bool`` on each
        module's ``named_modules`` name; a module it marks frozen gets
        plain gradients and no factor or inverse work
        (``capture.KFACCapture``; JAX passes the flax path, ``a/b``).
      fused_factor_contraction / fused_precondition: route the factor
        contraction + EMA and the bucketed preconditioning through their
        CUDA kernels (default True).
      factor_batch_fraction: the fraction of the batch rows the factor
        statistics read, in (0, 1] (``capture.subsample_captures``; the
        gradients always see the whole batch).
      inv_pipeline_chunks: fire the inverses in ``k`` cost-balanced
        chunks (:meth:`inverse_chunk_plan`), chunk ``j`` at phase ``j *
        inv_update_freq / k`` of each window (``step(inv_chunk=j)``;
        ``training.engine.cadence_flags``); ``k`` must divide
        ``inv_update_freq``. Step 0 fires monolithically.
      inv_pipeline_costs: measured ``{dim: ms}`` of a whole firing's size
        buckets, in place of the ``dim^3`` proxy (``r dim^2`` for a
        low-rank bucket); it must cover every dense factor dim.
      inv_lowrank_rank: ``r``, the rank of the randomized truncated
        eigendecomposition (the JAX knob; *Randomized K-FACs*). 0 (default)
        is off. With ``r > 0`` every dense factor dim at or above
        ``inv_lowrank_dim_threshold`` (default 2048) decomposes as a
        rank-``r`` eigenpair whatever ``inverse_method`` says, always warm
        from the carried basis (``eigh_method`` is not read for it); a
        rank at or above an engaged dim raises at registration.
      deferred_factor_reduction: factor steps fold into a local
        accumulator; the window head (``step(factor_reduce=True)``)
        applies it to the factors, one collective per window under
        ``parallel.DistributedKFAC``.
      hierarchical_reduce: the two-level factor reduction of a
        multi-slice ``parallel.DistributedKFAC(num_slices > 1)``: a mean
        within the slice on every factor step, folded into a per-slice
        accumulator, and one mean across slices at the window head
        (``step(factor_reduce=True)``). Exclusive with
        ``deferred_factor_reduction``; the single-device :meth:`step`
        raises under it.
      inv_staleness: 0, or 1: window heads snapshot the factors
        (``step(factor_snapshot=True)``) and the chunks fire from that
        snapshot one step after their phase.
      nonfinite_guard: keep the previous factors when the candidate
        (post-blend) factors of a factor step are not all finite
        (:func:`guard_nonfinite_factors`, one flag over every factor, a
        device-side select: no host sync); under
        ``deferred_factor_reduction`` the check runs at the window head's
        reduce, a non-finite window is skipped whole and the accumulator
        resets either way. It guards the factor statistics only: the
        step's gradients still flow through the precondition (the
        dynamic loss scale of ``training.engine`` skips whole steps).
        Default False (no guard).
      symmetry_aware_comm: average only each factor's packed triangle
        across ranks (``ops.factors.pack_symmetric``), about half the
        bytes; read by ``parallel.DistributedKFAC``.
      assignment_strategy: ``'compute'`` (``n^3``) or ``'memory'``
        (``n^2``): the cost model of the distributed work placement.
      collect_metrics: carry the on-device step metrics in the state
        (``state['metrics']``, :mod:`observability.metrics`): damping, the
        KL-clip ``nu``, gradient and preconditioned norms per shape
        bucket, firing counts, ``nonfinite_skips`` and ``eig_clipped``,
        updated by :meth:`step` without a host read. Off (the default),
        the step is the plain one, bit for bit and launch for launch; on,
        the parameters, losses and every other state entry are the same
        bits as off (the statistics only read the preconditioned
        matrices). The metrics are not checkpointed: after a resume the
        counters start again from zero, as in the JAX package.
      comm_method / grad_worker_fraction: the distributed strategy
        (:class:`CommMethod`, or its name) and, for HYBRID_OPT, the
        fraction of ranks that hold each layer's inverses; consumed by
        ``parallel.DistributedKFAC``. A single-device ``KFAC`` ignores
        the four.
      device: where the state lives (default ``'cuda'``; raises without a
        CUDA device unless ``'cpu'`` is passed).
    """

    def __init__(self, model: nn.Module, *,
                 damping: float = 0.001,
                 factor_decay: float = 0.95,
                 factor_update_freq: int = 10,
                 inv_update_freq: int = 100,
                 kl_clip: float | None = 0.001,
                 lr: float = 0.1,
                 use_eigen_decomp: bool | None = None,
                 inverse_method: str | None = None,
                 auto_eigen_max_dim: int = 640,
                 auto_large_method: str = 'cholesky',
                 eigh_method: str = 'auto',
                 eigh_polish_iters: int = 8,
                 newton_iters: int = 100,
                 factor_dtype: Any = None,
                 factor_compute_dtype: Any = None,
                 factor_batch_fraction: float = 1.0,
                 inv_dtype: Any = torch.float32,
                 capture_dtype: Any = 'auto',
                 precond_compute_dtype: Any = None,
                 precond_bucketing: bool = True,
                 inv_pipeline_chunks: int = 1,
                 inv_pipeline_costs: dict | None = None,
                 inv_lowrank_rank: int = 0,
                 inv_lowrank_dim_threshold: int = 2048,
                 deferred_factor_reduction: bool = False,
                 hierarchical_reduce: bool = False,
                 inv_staleness: int = 0,
                 nonfinite_guard: bool = False,
                 kfac_approx: Any = 'expand',
                 tied_embeddings: bool | None = None,
                 skip_layers: str | Sequence[str] | None = None,
                 trainable: Any = None,
                 fused_factor_contraction: bool = True,
                 fused_precondition: bool = True,
                 symmetry_aware_comm: bool = False,
                 assignment_strategy: str = 'compute',
                 comm_method: CommMethod | str = CommMethod.COMM_OPT,
                 grad_worker_fraction: float = 0.25,
                 collect_metrics: bool = False,
                 device='cuda'):
        self.device = resolve_device(device)
        set_fp32_precision()
        if factor_update_freq < 1 or inv_update_freq < 1:
            raise ValueError('update frequencies must be >= 1')
        if inv_update_freq % factor_update_freq != 0:
            warnings.warn(
                'inv_update_freq is not a multiple of factor_update_freq: '
                'some inverse updates will reuse stale factors '
                f'({inv_update_freq=} {factor_update_freq=})')
        if inv_pipeline_chunks < 1:
            raise ValueError(
                f'{inv_pipeline_chunks=} must be >= 1')
        if inv_pipeline_chunks > 1:
            if inv_update_freq % inv_pipeline_chunks != 0:
                raise ValueError(
                    'inv_pipeline_chunks must divide inv_update_freq '
                    'so chunk phases land on whole steps '
                    f'({inv_pipeline_chunks=} {inv_update_freq=})')
            stride = inv_update_freq // inv_pipeline_chunks
            if stride % factor_update_freq != 0:
                warnings.warn(
                    'inv_update_freq/inv_pipeline_chunks is not a '
                    'multiple of factor_update_freq: some chunk '
                    'firings will reuse stale factors '
                    f'({inv_update_freq=} {inv_pipeline_chunks=} '
                    f'{factor_update_freq=})')
        if inv_staleness not in (0, 1):
            raise ValueError(
                f'{inv_staleness=} must be 0 or 1 (one-window-stale '
                'off-critical-path inverses; deeper staleness is not '
                'supported)')
        if inv_staleness == 1:
            k = max(1, inv_pipeline_chunks)
            if inv_update_freq % k != 0 or inv_update_freq // k < 2:
                raise ValueError(
                    'inv_staleness=1 fires chunk j at phase '
                    'j*(inv_update_freq/inv_pipeline_chunks)+1 of each '
                    'window, which needs inv_update_freq/'
                    'inv_pipeline_chunks >= 2 so the shifted phases '
                    f'stay inside the window ({inv_update_freq=} '
                    f'{inv_pipeline_chunks=})')
        if not 0.0 < factor_batch_fraction <= 1.0:
            raise ValueError(
                f'{factor_batch_fraction=} must be in (0, 1]')
        inv_lowrank_rank = int(inv_lowrank_rank)
        inv_lowrank_dim_threshold = int(inv_lowrank_dim_threshold)
        if inv_lowrank_rank < 0:
            raise ValueError(
                f'{inv_lowrank_rank=} must be >= 0 (0 disables the '
                'randomized low-rank inverse path)')
        if inv_lowrank_rank > 0 and inv_lowrank_dim_threshold < 2:
            raise ValueError(
                f'{inv_lowrank_dim_threshold=} must be >= 2 with '
                'inv_lowrank_rank > 0 (a rank-r truncation of a '
                'dim < 2 factor cannot satisfy rank < dim)')
        if hierarchical_reduce and deferred_factor_reduction:
            raise ValueError(
                'hierarchical_reduce and deferred_factor_reduction are '
                'mutually exclusive: hierarchical reduce already '
                'defers the cross-slice half of the factor reduction to '
                'the window boundary, and its in-slice mean must run '
                'every factor step')
        if inverse_method is None:
            inverse_method = ('auto' if use_eigen_decomp is None
                              else 'eigen' if use_eigen_decomp
                              else 'cholesky')
        if inverse_method not in ('auto', 'eigen', 'cholesky', 'newton'):
            raise ValueError("inverse_method must be 'auto', 'eigen', "
                             f"'cholesky' or 'newton', got {inverse_method!r}")
        if use_eigen_decomp is not None and (
                inverse_method == 'auto'
                or use_eigen_decomp != (inverse_method == 'eigen')):
            raise ValueError(
                f'{use_eigen_decomp=} contradicts {inverse_method=}; '
                'set one or the other')
        if auto_large_method not in ('cholesky', 'newton'):
            raise ValueError("auto_large_method must be 'cholesky' or "
                             f"'newton', got {auto_large_method!r}")
        if eigh_method not in ('auto', 'xla', 'jacobi', 'warm'):
            raise ValueError("eigh_method must be 'auto', 'xla', 'jacobi' "
                             f"or 'warm', got {eigh_method!r}")
        check_dtype('factor_dtype', factor_dtype)
        check_dtype('factor_compute_dtype', factor_compute_dtype)
        check_dtype('inv_dtype', inv_dtype)
        check_dtype('capture_dtype', capture_dtype,
                    (*PRECISION_DTYPES, 'auto'))
        check_dtype('precond_compute_dtype', precond_compute_dtype)
        if (capture_dtype == 'auto' and factor_compute_dtype is not None
                and factor_compute_dtype.itemsize
                > torch.bfloat16.itemsize):
            # A strict fp32 factor request keeps its captures wide (the
            # JAX rule; 'auto' passes through on the port anyway).
            capture_dtype = None
        if assignment_strategy not in ('compute', 'memory'):
            raise ValueError("assignment_strategy must be 'compute' or "
                             f"'memory', got {assignment_strategy!r}")
        if kfac_approx is None:
            kfac_approx = 'expand'
        if tied_embeddings is None:
            named = (kfac_approx.values() if isinstance(kfac_approx, dict)
                     else [kfac_approx])
            tied_embeddings = any(v == 'reduce' for v in named)
        self.kfac_approx = kfac_approx
        self.tied_embeddings = bool(tied_embeddings)
        self.model = model
        self.capture = KFACCapture(model, skip_layers=skip_layers,
                                   tied_embeddings=self.tied_embeddings,
                                   capture_dtype=capture_dtype,
                                   trainable=trainable)
        self.specs = approx.annotate_specs(self.capture.specs, kfac_approx)
        self._specs_observed = False
        self.damping = damping
        self.factor_decay = factor_decay
        self.factor_update_freq = factor_update_freq
        self.inv_update_freq = inv_update_freq
        self.kl_clip = kl_clip
        self.lr = lr
        self.inverse_method = inverse_method
        self.use_eigen_decomp = inverse_method == 'eigen'
        self.auto_eigen_max_dim = auto_eigen_max_dim
        self.auto_large_method = auto_large_method
        self.eigh_method = eigh_method
        self.eigh_polish_iters = eigh_polish_iters
        self.newton_iters = newton_iters
        self.factor_compute_dtype = factor_compute_dtype
        self.factor_dtype = factor_dtype
        self.inv_dtype = torch.float32 if inv_dtype is None else inv_dtype
        self.capture_dtype = capture_dtype
        self.precond_compute_dtype = precond_compute_dtype
        self.precond_bucketing = bool(precond_bucketing)
        self.factor_batch_fraction = factor_batch_fraction
        self.inv_pipeline_chunks = inv_pipeline_chunks
        self.inv_pipeline_costs = (dict(inv_pipeline_costs)
                                   if inv_pipeline_costs else None)
        self.inv_lowrank_rank = inv_lowrank_rank
        self.inv_lowrank_dim_threshold = inv_lowrank_dim_threshold
        self.deferred_factor_reduction = bool(deferred_factor_reduction)
        self.hierarchical_reduce = bool(hierarchical_reduce)
        self.inv_staleness = int(inv_staleness)
        self.nonfinite_guard = bool(nonfinite_guard)
        self.fused_factor_contraction = bool(fused_factor_contraction)
        self.fused_precondition = bool(fused_precondition)
        self.symmetry_aware_comm = bool(symmetry_aware_comm)
        self.assignment_strategy = assignment_strategy
        self.comm_method = comm_method_of(comm_method)
        self.grad_worker_fraction = grad_worker_fraction
        self.collect_metrics = bool(collect_metrics)
        # observability.metrics.precond_stats's bucket matrix, per device.
        self.stats_cache: dict = {}
        #: The KL-clip scale of the last :meth:`precondition` (a device
        #: scalar).
        self.last_nu = None

    def __repr__(self) -> str:
        """Hyperparameter dump (the JAX ``KFAC.__repr__`` for the knobs
        the port has)."""
        fields = ('damping', 'factor_decay', 'factor_update_freq',
                  'inv_update_freq', 'kl_clip', 'lr', 'use_eigen_decomp',
                  'inverse_method',
                  'auto_eigen_max_dim', 'auto_large_method',
                  'inv_lowrank_rank', 'inv_lowrank_dim_threshold',
                  'eigh_method',
                  'eigh_polish_iters', 'newton_iters',
                  'factor_batch_fraction', 'factor_dtype',
                  'factor_compute_dtype', 'inv_dtype', 'capture_dtype',
                  'precond_compute_dtype', 'precond_bucketing',
                  'inv_pipeline_chunks',
                  'deferred_factor_reduction', 'hierarchical_reduce',
                  'inv_staleness', 'nonfinite_guard', 'kfac_approx',
                  'tied_embeddings',
                  'symmetry_aware_comm', 'assignment_strategy',
                  'comm_method', 'grad_worker_fraction',
                  'fused_factor_contraction', 'fused_precondition',
                  'collect_metrics')
        lines = [f'  {name}: {getattr(self, name)!r}' for name in fields]
        lines.append(f'  registered_layers: {len(self.specs)}')
        return 'KFAC(\n' + '\n'.join(lines) + '\n)'

    @property
    def storage_dtype(self) -> torch.dtype:
        """The running factors' dtype (``factor_dtype``, fp32 if None)."""
        return self.factor_dtype or torch.float32

    # ------------------------------------------------------------------
    # Per-dim inverse dispatch and state
    # ------------------------------------------------------------------

    def method_for_dim(self, dim: int) -> str:
        """Inverse method of a factor of this dimension: ``'lowrank'`` for
        every dim at or above ``inv_lowrank_dim_threshold`` while
        ``inv_lowrank_rank > 0``, whatever ``inverse_method`` says; else
        ``'auto'`` dispatches per dim (eigen up to ``auto_eigen_max_dim``,
        ``auto_large_method`` above) and the global modes return
        themselves."""
        if (self.inv_lowrank_rank > 0
                and dim >= self.inv_lowrank_dim_threshold):
            return 'lowrank'
        if self.inverse_method == 'auto':
            return ('eigen' if dim <= self.auto_eigen_max_dim
                    else self.auto_large_method)
        return self.inverse_method

    def lowrank_rank_for(self, dim: int) -> int | None:
        """The truncation rank of a factor dim, or None where the exact
        path runs (the chunk planners' cost hook)."""
        return (self.inv_lowrank_rank
                if self.method_for_dim(dim) == 'lowrank' else None)

    def _side_methods(self, a_dim: int, g_dim: int, name: str
                      ) -> tuple[str | None, str | None]:
        """(A-side, G-side) inverse methods of layer ``name``; an
        embedding's diagonal A has none, and a grouped conv neither side
        (its block stacks take :func:`grouped_block_inverses`, outside the
        per-dim dispatch)."""
        kind = self.specs[name].kind
        if kind == CONV2D_GROUPED:
            return None, None
        ma = None if kind == EMBEDDING else self.method_for_dim(a_dim)
        return ma, self.method_for_dim(g_dim)

    def _is_mixed(self, methods) -> bool:
        """One side eigen and the other baked (a diagonal A is neither)."""
        ma, mg = methods
        return ma is not None and eigen_family(ma) != eigen_family(mg)

    # ------------------------------------------------------------------
    # Pipelined inverse firing: the chunk plan
    # ------------------------------------------------------------------

    @property
    def window_reduce(self) -> bool:
        """Whether the factors take the window-head reduction
        (``step(factor_reduce=True)``): under ``deferred_factor_reduction``
        or ``hierarchical_reduce``."""
        return self.deferred_factor_reduction or self.hierarchical_reduce

    @property
    def pipelined_firing(self) -> bool:
        """Whether firings run chunk by chunk: ``inv_pipeline_chunks >
        1``, or ``inv_staleness == 1``, which fires even one chunk
        mid-window from the frozen snapshot (at ``k == 1`` the plan is one
        chunk holding every item)."""
        return self.inv_pipeline_chunks > 1 or self.inv_staleness == 1

    def inverse_chunk_items(self, factors: dict
                            ) -> list[tuple[tuple, float]]:
        """Cost-weighted inverse work items of a pipelined firing, in
        registration order: one per dense factor matrix, ``('mat', layer,
        'A'|'G')``, one per grouped conv (its block stacks), ``('grouped',
        layer)``, and one per embedding's diagonal A, ``('diag',
        layer)``. A matrix costs the ``dim^3`` proxy
        (``linalg.decomposition_cost``; ``r dim^2`` for a low-rank
        matrix), or with ``inv_pipeline_costs``
        its bucket's measured ms split evenly over the bucket's matrices;
        a grouped conv costs ``G (da^3 + dg^3)`` and a diagonal A its dim,
        both rescaled into the measured unit (:func:`measured_unit_scale`,
        which requires the measurement to cover every dense factor
        dim)."""
        dense_count: dict[int, int] = {}
        for name, spec in self.specs.items():
            if spec.kind == CONV2D_GROUPED:
                continue
            f = factors[name]
            if spec.kind != EMBEDDING:
                a = int(f['A'].shape[-1])
                dense_count[a] = dense_count.get(a, 0) + 1
            g = int(f['G'].shape[-1])
            dense_count[g] = dense_count.get(g, 0) + 1
        measured = self.inv_pipeline_costs or {}
        proxy_scale = measured_unit_scale(measured, dense_count,
                                          'dense factor dim')

        def unit_cost(dim: int) -> float:
            if dim in measured:
                return float(measured[dim]) / dense_count[dim]
            return linalg.decomposition_cost(
                dim, rank=self.lowrank_rank_for(dim))

        items: list[tuple[tuple, float]] = []
        for name, spec in self.specs.items():
            f = factors[name]
            a_dim = int(f['A'].shape[-1])
            g_dim = int(f['G'].shape[-1])
            if spec.kind == CONV2D_GROUPED:
                items.append((('grouped', name), proxy_scale
                              * grouped_cost(spec, a_dim, g_dim)))
                continue
            if spec.kind == EMBEDDING:
                items.append((('diag', name), proxy_scale * a_dim))
            else:
                items.append((('mat', name, 'A'), unit_cost(a_dim)))
            items.append((('mat', name, 'G'), unit_cost(g_dim)))
        return items

    def inverse_chunk_plan(self, factors: dict) -> dict[tuple, int]:
        """``{item: chunk}``: the greedy LPT packing
        (:func:`plan_inverse_chunks`) of :meth:`inverse_chunk_items` onto
        ``inv_pipeline_chunks`` chunks, deterministic for a model. Raises
        if there are more chunks than items."""
        items = self.inverse_chunk_items(factors)
        k = self.inv_pipeline_chunks
        if k > len(items):
            raise ValueError(
                f'inv_pipeline_chunks={k} exceeds the {len(items)} '
                'inverse work items of this model (dense factor '
                'matrices + grouped/diagonal layers); lower it to at '
                f'most {len(items)}')
        return plan_inverse_chunks(items, k)

    def observe_specs(self) -> None:
        """Resolve the specs against what the recorded calls showed (each
        Linear's shared-axis positions, each embedding's tied calls):
        once, at the first factor update; the 'reduce' policy needs the
        former."""
        if self._specs_observed:
            return
        self.specs.update(approx.annotate_specs(
            self.capture.observed_specs(self.specs), self.kfac_approx))
        self._specs_observed = True

    def approx_summary(self) -> dict[str, str]:
        """``{layer: approx}`` of the resolved specs (``sharing.approx.
        approx_summary``)."""
        return approx.approx_summary(self.specs)

    def _layer_params(self, name: str, tensors: dict) -> dict:
        """``{'weight', 'bias'}`` entries of one layer from a dict keyed by
        parameter name."""
        out = {'weight': tensors[f'{name}.weight']}
        if self.specs[name].has_bias:
            out['bias'] = tensors[f'{name}.bias']
        return out

    def init_state(self) -> dict:
        """Fresh state: identity factors (an embedding's diagonal A: ones;
        a grouped conv: stacks of identity blocks) in the storage dtype;
        eigen slots seeded with their exact eigendecomposition (``Q = I, d
        = 1``) so the warm polish has a basis from step 0 (a low-rank side:
        the ``(dim, r)`` identity columns and ``r`` unit eigenvalues, so
        that every firing is warm); baked slots
        (non-eigen sides, the eigen side of a mixed layer, an embedding's
        diagonal ``A_inv``, a grouped conv's block stacks) zero, computed
        at step 0 before first use; every inverse slot in ``inv_dtype``."""
        params = dict(self.model.named_parameters())
        dev = self.device
        fdt, idt = self.storage_dtype, self.inv_dtype
        factors, inverses = {}, {}
        for name, spec in self.specs.items():
            dims = dict(zip('AG', L.factor_shapes(
                spec, self._layer_params(name, params))))
            if spec.kind == CONV2D_GROUPED:
                factors[name], inverses[name] = grouped_init(
                    spec, dims['A'], dims['G'], fdt, idt, dev)
                continue
            methods = dict(zip('AG', self._side_methods(dims['A'],
                                                        dims['G'], name)))
            for side, dim in dims.items():
                if methods[side] == 'lowrank' \
                        and self.inv_lowrank_rank >= dim:
                    # Fail closed: never fall back to the exact path.
                    raise ValueError(
                        f'inv_lowrank_rank={self.inv_lowrank_rank} must be '
                        f'< the engaged factor dim {dim} (layer {name!r} '
                        f'side {side}; dims >= inv_lowrank_dim_threshold='
                        f'{self.inv_lowrank_dim_threshold} run the '
                        'randomized low-rank path): lower the rank or '
                        'raise the threshold')
            mixed = self._is_mixed(methods.values())
            factors[name], entry = {}, {}
            for side, dim in dims.items():
                if methods[side] is None:
                    factors[name][side] = torch.ones(dim, dtype=fdt,
                                                     device=dev)
                    entry[f'{side}_inv'] = torch.zeros(dim, dtype=idt,
                                                       device=dev)
                    continue
                factors[name][side] = torch.eye(dim, dtype=fdt, device=dev)
                if eigen_family(methods[side]):
                    r = (self.inv_lowrank_rank
                         if methods[side] == 'lowrank' else dim)
                    entry[f'Q{side}'] = torch.eye(dim, r, dtype=idt,
                                                  device=dev)
                    entry[f'd{side}'] = torch.ones(r, dtype=idt,
                                                   device=dev)
                if mixed or not eigen_family(methods[side]):
                    entry[f'{side}_inv'] = torch.zeros(
                        (dim, dim), dtype=idt, device=dev)
            inverses[name] = entry
        state = {'step': 0, 'factors': factors, 'inverses': inverses,
                 'inv_chunk_phase': 0}
        return self._seed_metrics(self._seed_overlap_state(state))

    def metric_bucket_keys(self) -> list[str]:
        """The shape-bucket keys of the metrics (``observability.metrics.
        shape_key`` of each registered layer's gradient matrix, in
        registration order), from the parameter shapes alone."""
        params = {n: torch.empty(p.shape, device='meta')
                  for n, p in self.model.named_parameters()}
        keys: list[str] = []
        for name, spec in self.specs.items():
            key = obs_metrics.shape_key(L.grads_to_matrix(
                spec, self._layer_params(name, params)).shape)
            if key not in keys:
                keys.append(key)
        return keys

    def _seed_metrics(self, state: dict) -> dict:
        """Add fresh ``metrics`` under ``collect_metrics``."""
        if self.collect_metrics:
            state['metrics'] = obs_metrics.init_metrics(
                self.metric_bucket_keys(), self.device)
        return state

    def _seed_overlap_state(self, state: dict) -> dict:
        """Add the fresh state of the firing-schedule knobs: under
        ``deferred_factor_reduction`` (or ``hierarchical_reduce``) a zero
        accumulator of the factors' layout and dtype (``factor_accum``) and
        its decay product ``accum_decay`` (an fp32 device scalar, 1); under
        ``inv_staleness=1`` the snapshot ``frozen_factors`` (the factors
        themselves). With chunks, the plan is checked here, once."""
        factors = state['factors']
        if self.window_reduce:
            state['factor_accum'] = _zeros_like(factors)
            state['accum_decay'] = torch.ones((), dtype=torch.float32,
                                              device=self.device)
        if self.inv_staleness:
            state['frozen_factors'] = {n: dict(f)
                                       for n, f in factors.items()}
        if self.pipelined_firing:
            self.inverse_chunk_plan(factors)
        return state

    # ------------------------------------------------------------------
    # Factor update
    # ------------------------------------------------------------------

    def fused_factor_inputs(self, spec, entry: dict) -> dict:
        """``{side: (x, scale, has_bias)}`` for the sides of one layer that
        the factor contraction + EMA kernel computes: single-call dense A
        and G (under 'reduce' their ``(B, d)`` reduced rows), single-call
        conv G (read in place as ``(B*H*W, C)``; a patch-embedding conv
        under 'reduce': its reduced A and G rows) and an untied
        embedding's single-call G. Conv A has its own patch-covariance
        kernel; an embedding's A, a tied embedding's G, grouped convs and
        multi-call layers run the stock sum of per-call factors."""
        out = {}
        if spec.kind == LINEAR:
            reduced = spec.kfac_approx == KFAC_REDUCE
            if len(entry['a']) == 1:
                a = entry['a'][0]
                out['A'] = (F._reduce_shared_axes(a, mean=True) if reduced
                            else F.collapse_batch_dims(a), None,
                            spec.has_bias)
            if len(entry['g']) == 1:
                g = entry['g'][0]
                out['G'] = (F._reduce_shared_axes(g, mean=False) if reduced
                            else F.collapse_batch_dims(g), None, False)
        elif spec.kind == EMBEDDING:
            if len(entry['g']) == 1 and not entry.get('g_tied'):
                out['G'] = (F.collapse_batch_dims(entry['g'][0]), None,
                            False)
        elif spec.kind == CONV2D and spec.kfac_approx == KFAC_REDUCE:
            # A patch-embedding conv under 'reduce': its (B, d) mean
            # patch rows and (B, C) summed output-grad rows, as a reduced
            # Linear's.
            if len(entry['a']) == 1:
                a = entry['a'][0]
                rows = kernels.extract_conv2d_patches(
                    a, spec.kernel_size, spec.strides, spec.padding)
                out['A'] = (F._reduce_shared_axes(
                    rows.reshape(a.shape[0], -1, rows.shape[-1]),
                    mean=True), None, spec.has_bias)
            if len(entry['g']) == 1:
                g = entry['g'][0]
                out['G'] = (g.float().flatten(2).sum(-1), None, False)
        elif spec.kind == CONV2D and len(entry['g']) == 1:
            g = entry['g'][0]
            b, _, h, w = g.shape
            out['G'] = (g, float(b * h * w) * (h * w) ** 2, False)
        return out

    @profiling.scope('kfac/factors')
    def update_factors(self, state: dict, captures: dict | None,
                       factor_decay=None, *,
                       contribs: dict | None = None) -> dict:
        """EWMA-update every factor from one batch's captures
        (:meth:`blend_factors` into ``state['factors']``), or from
        precomputed ``contribs`` (:meth:`blend_contribs`)."""
        alpha = self.factor_decay if factor_decay is None else factor_decay
        if contribs is not None:
            return self.blend_contribs(state['factors'], contribs, alpha)
        return self.blend_factors(state['factors'], captures, alpha)

    @profiling.scope('kfac/factors')
    def local_factor_contribs(self, captures: dict) -> dict:
        """One batch's covariance contributions ``{layer: {'A', 'G'}}``,
        the contraction without the EMA: the sides
        :meth:`fused_factor_inputs` names through K1 in its
        contraction-only form (no old factor, decay 0; under 'reduce' the
        reduced rows), conv A through K2, multi-call layers, an
        embedding's A and a tied embedding's G as the stock sum of
        per-call factors; a tied embedding also gets its attend-site parts
        ``A_g2`` and ``G_a`` (``layers.compute_tied_factor_extras``), kept
        apart until they are scaled (:meth:`blend_contribs`). The specs
        are resolved first (:meth:`observe_specs`) and the captures thinned
        to ``factor_batch_fraction``. Under ``parallel.DistributedKFAC``
        they are a rank's own; an accumulated step sums them over its
        micro-batches (``training.engine.accumulate_pass``)."""
        missing = [n for n in self.specs if n not in captures]
        if missing:
            raise ValueError(f'no captures for registered layers {missing} '
                             '(capture with intercept=True on factor '
                             'steps)')
        self.observe_specs()
        captures = subsample_captures(captures, self.factor_batch_fraction)
        cdt = self.factor_compute_dtype
        out = {}
        for name, spec in self.specs.items():
            entry = captures[name]
            fused = (self.fused_factor_inputs(spec, entry)
                     if self.fused_factor_contraction else {})
            contrib = {}
            for side, compute, calls in (
                    ('A', L.compute_a_factor, entry['a']),
                    ('G', L.compute_g_factor, entry['g'])):
                with profiling.annotate(factor_scope(spec, side)):
                    if side in fused:
                        x, scale, has_bias = fused[side]
                        contrib[side] = kernels.factor_ema(
                            x, None, 0.0, scale=scale, has_bias=has_bias,
                            compute_dtype=cdt)
                    else:
                        contrib[side] = compute(spec, calls,
                                                compute_dtype=cdt)
            extras = L.compute_tied_factor_extras(spec, entry,
                                                  compute_dtype=cdt)
            if extras is not None:
                contrib.update(extras)
            out[name] = contrib
        return out

    def blend_contribs(self, old_factors: dict, contribs: dict, alpha,
                       quad_scale: float = 1.0) -> dict:
        """``alpha * old + (1 - alpha) * c`` for precomputed contributions
        (:meth:`local_factor_contribs`, or an accumulated step's micro-batch
        mean): the output-grad-quadratic parts (``layers.
        GRAD_QUADRATIC_KEYS``) times ``quad_scale``, a tied embedding's
        ``A_g2`` folded into its A and ``G_a`` into its G, then the fp32
        blend of the widened ``old`` rounded once to its dtype
        (:func:`kernels.ema_blend`)."""
        out = {}
        for name in self.specs:
            c, old = contribs[name], old_factors[name]
            a = c['A']
            g = c['G'] if quad_scale == 1.0 else quad_scale * c['G']
            if 'A_g2' in c:
                a = a + (c['A_g2'] if quad_scale == 1.0
                         else quad_scale * c['A_g2'])
                g = g + c['G_a']
            out[name] = {'A': kernels.ema_blend(old['A'], a, alpha),
                         'G': kernels.ema_blend(old['G'], g, alpha)}
        return out

    def blend_factors(self, old_factors: dict, captures: dict,
                      alpha, quad_scale: float = 1.0) -> dict:
        """``alpha * old + (1 - alpha) * contribution`` of one batch for
        every factor of ``old_factors`` (the running factors, or the
        deferred accumulator): the captures are thinned to
        ``factor_batch_fraction`` first; the sides
        :meth:`fused_factor_inputs` names run the factor contraction + EMA
        kernel (with ``fused_factor_contraction``), the rest the stock
        per-call factors (a tied embedding's attend-site terms added) +
        :func:`F.update_running_avg`. Both keep ``old``'s dtype: the fp32
        blend of the widened value, rounded once. ``quad_scale``
        multiplies the output-grad-quadratic parts (``G``, a tied
        embedding's ``A_g2``; ``parallel.DistributedKFAC`` folds a rank's
        contribution with ``1/W^2``)."""
        missing = [n for n in self.specs if n not in captures]
        if missing:
            raise ValueError(f'no captures for registered layers {missing} '
                             '(capture with intercept=True on factor '
                             'steps)')
        self.observe_specs()
        captures = subsample_captures(captures, self.factor_batch_fraction)
        cdt = self.factor_compute_dtype
        new_factors = {}
        for name, spec in self.specs.items():
            entry, old = captures[name], old_factors[name]
            fused = (self.fused_factor_inputs(spec, entry)
                     if self.fused_factor_contraction else {})
            res = {}
            for side, new in self.stock_contribs(spec, entry, fused,
                                                 quad_scale).items():
                res[side] = F.update_running_avg(new, old[side], alpha)
            for side, (x, scale, has_bias) in fused.items():
                if side == 'G' and quad_scale != 1.0:
                    scale = (x.shape[0] if scale is None
                             else scale) / quad_scale
                with profiling.annotate(factor_scope(spec, side)):
                    res[side] = kernels.factor_ema(
                        x, old[side], alpha, scale=scale,
                        has_bias=has_bias, compute_dtype=cdt)
            new_factors[name] = {side: res[side] for side in 'AG'}
        return new_factors

    @profiling.scope('kfac/factors')
    def accumulate_factors(self, state: dict, captures: dict | None,
                           factor_decay=None, *,
                           contribs: dict | None = None
                           ) -> tuple[dict, Any]:
        """Deferred-reduction factor step: ``acc <- alpha acc + (1 -
        alpha) c`` (:meth:`blend_factors` into ``state['factor_accum']``,
        K1's fused blend with the accumulator as ``old``; with ``contribs``,
        :meth:`blend_contribs`) and ``decay <- alpha decay``; the running
        factors are left alone. Returns ``(new_accum, new_decay)``."""
        alpha = self.factor_decay if factor_decay is None else factor_decay
        acc = (self.blend_contribs(state['factor_accum'], contribs, alpha)
               if contribs is not None else
               self.blend_factors(state['factor_accum'], captures, alpha))
        return acc, alpha * state['accum_decay']

    @profiling.scope('kfac/factors')
    def reduce_factors(self, state: dict, acc: dict, decay) -> dict:
        """Deferred-reduction window head: ``F <- decay F + acc``, in fp32
        and rounded once to the storage dtype (by EMA linearity the eager
        recursion's value, up to the order of the fp32 sums)."""
        return {name: {side: (decay * old[side].float()
                              + acc[name][side].float()).to(old[side].dtype)
                       for side in 'AG'}
                for name, old in state['factors'].items()}

    def stock_contribs(self, spec, entry: dict, skip=(),
                       quad_scale: float = 1.0) -> dict:
        """One batch's contribution to each side of one layer not in
        ``skip``: the per-call factors summed, plus a tied embedding's
        attend-site terms (``layers.compute_tied_factor_extras``); the
        output-grad-quadratic parts (``G``, ``A_g2``) times
        ``quad_scale``."""
        cdt = self.factor_compute_dtype
        extras = L.compute_tied_factor_extras(spec, entry, compute_dtype=cdt)
        if extras is not None and quad_scale != 1.0:
            extras = {**extras, 'A_g2': quad_scale * extras['A_g2']}
        out = {}
        for side, compute, calls, extra in (
                ('A', L.compute_a_factor, entry['a'], 'A_g2'),
                ('G', L.compute_g_factor, entry['g'], 'G_a')):
            if side in skip:
                continue
            with profiling.annotate(factor_scope(spec, side)):
                new = compute(spec, calls, compute_dtype=cdt)
            if side == 'G' and quad_scale != 1.0:
                new = quad_scale * new
            out[side] = new if extras is None else new + extras[extra]
        return out

    # ------------------------------------------------------------------
    # Inverse update (monolithic firing)
    # ------------------------------------------------------------------

    def _bucketed_eigh(self, mats: dict, prev: dict | None = None) -> dict:
        """Eigendecompose a dict of SPD matrices, one batched call per
        size; with ``prev`` bases (and eigh_method 'auto'/'warm') the warm
        polish, under 'jacobi' the Jacobi kernel (``prev`` unused), else
        the library eigh."""
        method = linalg.resolve_eigh_method(self.eigh_method)
        out = {}
        for names, stack in _size_buckets(mats):
            q_prev = None
            if prev is not None and method == 'auto':
                q_prev = torch.stack([prev[n].float() for n in names])
            qs, ds = linalg.batched_eigh(stack, method, clip=0.0,
                                         q_prev=q_prev,
                                         polish_iters=self.eigh_polish_iters)
            for i, n in enumerate(names):
                out[n] = (qs[i], ds[i])
        return out

    def _bucketed_lowrank(self, mats: dict, prev: dict | None = None
                          ) -> dict:
        """Truncated-eigendecompose a dict of SPD matrices, one batched
        :func:`linalg.batched_lowrank_eigh` per size: warm from the
        carried ``(dim, r)`` bases in ``prev`` whatever ``eigh_method``
        says (the carried basis is the low-rank state), cold from the
        seeded sketch without them (a rebuild)."""
        out = {}
        for names, stack in _size_buckets(mats):
            q_prev = (torch.stack([prev[n].float() for n in names])
                      if prev is not None else None)
            qs, ds = linalg.batched_lowrank_eigh(
                stack, self.inv_lowrank_rank, q_prev=q_prev,
                polish_iters=self.eigh_polish_iters)
            for i, n in enumerate(names):
                out[n] = (qs[i], ds[i])
        return out

    def _bucketed_inverse(self, mats: dict, damping) -> dict:
        """Damped-inverse a dict of SPD matrices, one batched call per
        size (:func:`kernels.damped_inverse_stack` with the size's
        method: the Newton--Schulz kernel or the Cholesky inverse)."""
        out = {}
        for names, stack in _size_buckets(mats):
            invs = kernels.damped_inverse_stack(
                stack, damping, self.method_for_dim(stack.shape[-1]),
                iters=self.newton_iters)
            for i, n in enumerate(names):
                out[n] = invs[i]
        return out

    @profiling.scope('kfac/inverses')
    def update_inverses(self, state: dict, damping=None, *,
                        warm: bool = True, chunk: int | None = None) -> dict:
        """Recompute the inverse slots from the factors at ``damping``
        (default: the constructor's): every slot (a monolithic firing),
        or with ``chunk`` only the items :meth:`inverse_chunk_plan` gives
        that chunk, every other slot passing through from
        ``state['inverses']`` as it is.

        Eigen sides are decomposed per size bucket; ``warm`` seeds the
        polish from the bases stored in ``state['inverses']``, and
        ``warm=False`` (a rebuild from checkpointed factors) runs the
        library eigh instead (a low-rank side: the seeded sketch). The
        other sides get damped inverses per size bucket. A mixed layer's eigen side is also baked into
        ``{side}_inv`` at this damping, so both of its sides carry the
        damping of the firing that computed them (under chunks, each
        side's own chunk). Every decomposition runs in fp32 on the
        widened factors (the polish seeded from the stored basis
        widened); the results are stored in ``inv_dtype``.

        While firings are pipelined even a monolithic firing decomposes
        chunk by chunk, each chunk's size buckets stacked as that chunk's
        own firing stacks them: a window of chunk firings over frozen
        factors then gives the monolithic firing's bits by construction,
        whatever the batched kernels do with another batch count.
        """
        damping = self.damping if damping is None else damping
        plan = (self.inverse_chunk_plan(state['factors'])
                if self.pipelined_firing else None)
        if chunk is not None and plan is None:
            raise ValueError('inv_chunk requires inv_pipeline_chunks > 1 '
                             'or inv_staleness=1')

        def fires(key: tuple) -> bool:
            return chunk is None or plan[key] == chunk

        eigen_mats, lowrank_mats, inv_mats = {}, {}, {}
        prev, sides = {}, {}
        for name, spec in self.specs.items():
            f = state['factors'][name]
            sides[name] = self._side_methods(f['A'].shape[-1],
                                             f['G'].shape[-1], name)
            if spec.kind == CONV2D_GROUPED:
                continue
            for side, method in zip('AG', sides[name]):
                if method is None or not fires(('mat', name, side)):
                    continue
                key = f'{name}/{side}'
                if eigen_family(method):
                    (lowrank_mats if method == 'lowrank'
                     else eigen_mats)[key] = f[side]
                    prev[key] = state['inverses'][name][f'Q{side}']
                else:
                    inv_mats[key] = f[side]
        prev = prev if warm else None
        eigs, invs = {}, {}
        for mats in _by_chunk(eigen_mats, plan):
            eigs.update(self._bucketed_eigh(mats, prev))
        for mats in _by_chunk(lowrank_mats, plan):
            eigs.update(self._bucketed_lowrank(mats, prev))
        for mats in _by_chunk(inv_mats, plan):
            invs.update(self._bucketed_inverse(mats, damping))
        idt = self.inv_dtype
        new_inv = {}
        for name, spec in self.specs.items():
            if spec.kind == CONV2D_GROUPED:
                new_inv[name] = (
                    grouped_block_inverses(state['factors'][name], damping,
                                           idt)
                    if fires(('grouped', name))
                    else state['inverses'][name])
                continue
            mixed = self._is_mixed(sides[name])
            entry = dict(state['inverses'][name]) if chunk is not None \
                else {}
            for side, method in zip('AG', sides[name]):
                key = f'{name}/{side}'
                if method is None:
                    if fires(('diag', name)):
                        entry[f'{side}_inv'] = \
                            linalg.get_elementwise_inverse(
                                state['factors'][name][side].float(),
                                damping).to(idt)
                elif not fires(('mat', name, side)):
                    continue
                elif eigen_family(method):
                    q, d = eigs[key]
                    entry[f'Q{side}'] = q.to(idt)
                    entry[f'd{side}'] = d.to(idt)
                    if mixed:
                        entry[f'{side}_inv'] = linalg.eigen_side_inverse(
                            q, d, damping).to(idt)
                else:
                    entry[f'{side}_inv'] = invs[key].to(idt)
            new_inv[name] = entry
        return new_inv

    # ------------------------------------------------------------------
    # Preconditioning + KL clip
    # ------------------------------------------------------------------

    def _bucketed_precond_mats(self, inverses: dict, grad_mats: dict,
                               damping) -> tuple[dict, dict]:
        """Precondition same-shape layers as one stack each (with
        ``precond_bucketing=False``, each layer as a stack of one).

        A shape group is wholly eigen (``QA/dA/QG/dG``) or wholly baked
        (``A_inv/G_inv``; mixed layers precondition through their baked
        inverses): the per-dim method depends on the factor dims alone.
        An eigen group with a truncated basis (a low-rank side) runs the
        stock :func:`linalg.precondition_dispatch`, never the kernel.
        Returns ``(mats, vg)``: the preconditioned matrix per layer and,
        for the stacks the kernel ran, its per-layer ``sum(v * g)``.
        Embeddings (a diagonal A) and grouped convs (block stacks) are
        left to the caller.
        """
        groups: dict[tuple, list[str]] = {}
        for name, mat in grad_mats.items():
            if self.specs[name].kind not in (EMBEDDING, CONV2D_GROUPED):
                key = tuple(mat.shape) if self.precond_bucketing else name
                groups.setdefault(key, []).append(name)
        mats, vg = {}, {}
        for members in groups.values():
            gstack = torch.stack([grad_mats[n].float() for n in members])
            e0 = inverses[members[0]]
            keys = (('A_inv', 'G_inv') if 'A_inv' in e0 or 'G_inv' in e0
                    else ('QA', 'dA', 'QG', 'dG'))
            entry = {k: torch.stack([inverses[n][k] for n in members])
                     for k in keys}
            cdt = self.precond_compute_dtype
            if self.fused_precondition and not truncated_entry(entry):
                with profiling.annotate(precond_scope(entry)):
                    vs, vgs = kernels.bucket_precond(gstack, entry, damping,
                                                     compute_dtype=cdt)
                for i, n in enumerate(members):
                    vg[n] = vgs[i]
            else:
                vs = linalg.precondition_dispatch(gstack, entry, damping,
                                                  compute_dtype=cdt)
            for i, n in enumerate(members):
                mats[n] = vs[i]
        return mats, vg

    @profiling.scope('kfac/precond')
    def precondition(self, state: dict, grads: dict, damping, lr,
                     with_stats: bool = False, gates: dict | None = None):
        """Precondition the registered layers' grads and apply the KL-clip
        scale ``nu = min(1, sqrt(kl_clip / |sum lr^2 v.g|))`` (a device
        tensor); unregistered grads pass through. ``with_stats`` returns
        ``(out, observability.metrics.precond_stats(...))``: ``nu``, the
        gradient and preconditioned norms and the per-shape-bucket norms,
        read from the matrices the step computed.

        ``gates`` (the self-healing quarantine): shape-bucket key
        (``observability.metrics.shape_key`` of the gradient matrix) ->
        0-dim 0/1 device tensor. A gated-off bucket's layers take the raw
        gradient, blended by :func:`gate_blend` (a select: a NaN or
        infinity of the unselected preconditioned branch does not reach
        the output) before the KL clip, so the clip and the stats see the
        blended directions. With gates the ``v.g`` sum is the full-tensor
        reduction for every layer (K3 still runs; its fused partial would
        be stale after the blend). None is the plain path, bit for bit.
        """
        grad_mats = {
            name: L.grads_to_matrix(spec, self._layer_params(name, grads))
            for name, spec in self.specs.items()}
        precond_mats, fused_vg = self._bucketed_precond_mats(
            state['inverses'], grad_mats, damping)
        for name, spec in self.specs.items():
            if spec.kind in (EMBEDDING, CONV2D_GROUPED):
                # A diagonal A inverse, or a grouped conv's block stacks
                # (G_inv @ V @ A_inv batched over the groups).
                inv = state['inverses'][name]
                precond_mats[name] = linalg.precondition_dispatch(
                    grad_mats[name], inv, damping,
                    diag_a=inv['A_inv'] if spec.kind == EMBEDDING else None,
                    compute_dtype=self.precond_compute_dtype)
        if gates is not None:
            precond_mats = gate_blend(precond_mats, grad_mats, gates)
        if self.kl_clip is not None:
            # Registration order, like the JAX package's summation.
            vg_sum = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
            for name in self.specs:
                if gates is None and name in fused_vg:
                    vg_sum = vg_sum + fused_vg[name] * lr ** 2
                else:
                    vg_sum = vg_sum + torch.sum(
                        precond_mats[name] * grad_mats[name].float()
                        * lr ** 2)
            nu = torch.clamp(torch.sqrt(
                self.kl_clip / (vg_sum.abs() + 1e-30)), max=1.0)
        else:
            nu = torch.ones((), dtype=torch.float32, device=self.device)
        self.last_nu = nu
        out = dict(grads)
        for name, spec in self.specs.items():
            like = self._layer_params(name, grads)
            new = L.matrix_to_grads(spec, nu * precond_mats[name], like)
            for key, t in new.items():
                out[f'{name}.{key}'] = t.to(like[key].dtype)
        if with_stats:
            return out, obs_metrics.precond_stats(grad_mats, precond_mats,
                                                  nu, self.stats_cache)
        return out

    # ------------------------------------------------------------------
    # The full step
    # ------------------------------------------------------------------

    def step(self, state: dict, grads: dict, captures: dict | None = None,
             *, contribs: dict | None = None,
             damping=None, lr=None, factor_decay=None,
             factor_update_freq=None, inv_update_freq=None,
             factor_update: bool | None = None,
             inv_update: bool | None = None,
             inv_chunk: int | None = None,
             factor_reduce: bool = False,
             factor_snapshot: bool = False,
             gates: dict | None = None) -> tuple[dict, dict]:
        """One K-FAC update: ``(preconditioned_grads, new_state)``.

        The factor step reads ``captures`` (one batch's) or, in their
        place, precomputed ``contribs`` (:meth:`local_factor_contribs`,
        e.g. the scaled micro-batch mean of an accumulated step); one of
        the two must be passed.

        ``factor_update`` / ``inv_update`` are the cadence flags (the
        caller's schedule, ``training.engine.cadence_flags``); left None
        they follow ``state['step']`` modulo the update frequencies.
        ``inv_chunk=j`` fires chunk ``j`` of a pipelined firing (not with
        ``inv_update=True``). ``factor_reduce`` (with
        ``deferred_factor_reduction``) applies the accumulator to the
        factors this step; ``factor_snapshot`` (with ``inv_staleness=1``)
        refreshes ``frozen_factors`` from this step's factors, which the
        chunk firings decompose (a monolithic firing snapshots, then
        fires). The deferred and stale schedules need explicit flags.
        Under ``collect_metrics`` the new state's ``metrics`` are the
        step's (:func:`observability.metrics.update_metrics`). ``gates``:
        the self-healing quarantine mask (:meth:`precondition`).
        """
        damping = self.damping if damping is None else damping
        lr = self.lr if lr is None else lr
        f_freq = (self.factor_update_freq if factor_update_freq is None
                  else factor_update_freq)
        i_freq = (self.inv_update_freq if inv_update_freq is None
                  else inv_update_freq)
        step = state['step']
        if captures is None and contribs is None:
            raise ValueError('pass captures or contribs')
        if self.hierarchical_reduce:
            raise ValueError(
                'hierarchical_reduce needs a multi-slice world (it reduces '
                'within and across slices): use parallel.DistributedKFAC '
                'with num_slices > 1')
        if self.deferred_factor_reduction:
            if factor_update is None:
                raise ValueError(
                    'deferred_factor_reduction requires static cadence '
                    'flags (Python-bool factor_update/factor_reduce) — '
                    'the window-boundary reduce is static program '
                    'structure, like inv_chunk')
            acc, decay = state['factor_accum'], state['accum_decay']
            if factor_update:
                acc, decay = self.accumulate_factors(
                    state, captures, factor_decay, contribs=contribs)
            finite = None
            if factor_reduce:
                factors, finite = self.guard_factors(
                    self.reduce_factors(state, acc, decay), state['factors'])
                acc = _zeros_like(acc)
                decay = torch.ones((), dtype=torch.float32,
                                   device=self.device)
            else:
                factors = state['factors']
            state_f = {**state, 'factors': factors, 'factor_accum': acc,
                       'accum_decay': decay}
        else:
            if factor_reduce:
                raise ValueError('factor_reduce requires '
                                 'deferred_factor_reduction=True')
            if factor_update is None:
                factor_update = step % f_freq == 0
            factors, finite = (self.guard_factors(
                self.update_factors(state, captures, factor_decay,
                                    contribs=contribs), state['factors'])
                               if factor_update else (state['factors'], None))
            state_f = {**state, 'factors': factors}
        if self.inv_staleness:
            if inv_update is None:
                raise ValueError(
                    'inv_staleness=1 requires static cadence flags '
                    '(the frozen-snapshot firing schedule is static '
                    'program structure, like inv_chunk)')
            frozen = (state_f['factors'] if factor_snapshot or inv_update
                      else state['frozen_factors'])
            state_f = {**state_f, 'frozen_factors': frozen}
            fire_state = {**state_f, 'factors': frozen}
        else:
            if factor_snapshot:
                raise ValueError('factor_snapshot requires inv_staleness=1')
            fire_state = state_f
        if inv_chunk is not None:
            k = self.inv_pipeline_chunks
            if inv_update:
                raise ValueError(
                    'inv_chunk is mutually exclusive with '
                    'inv_update=True (a monolithic firing already '
                    'covers every chunk)')
            if not 0 <= inv_chunk < k:
                raise ValueError(f'{inv_chunk=} out of range for '
                                 f'inv_pipeline_chunks={k}')
            with profiling.annotate(f'kfac/inverse/chunk{inv_chunk}'):
                inverses = self.update_inverses(fire_state, damping,
                                                chunk=inv_chunk)
            chunk_phase = (inv_chunk + 1) % k
        else:
            if inv_update is None:
                inv_update = step % i_freq == 0
            inverses = (self.update_inverses(fire_state, damping)
                        if inv_update else state['inverses'])
            chunk_phase = 0 if inv_update else state['inv_chunk_phase']
        state_i = {**state_f, 'inverses': inverses,
                   'inv_chunk_phase': chunk_phase}
        if not self.collect_metrics:
            precond = self.precondition(state_i, grads, damping, lr,
                                        gates=gates)
            return precond, {**state_i, 'step': step + 1}
        precond, stats = self.precondition(state_i, grads, damping, lr,
                                           with_stats=True, gates=gates)
        metrics = obs_metrics.update_metrics(
            state['metrics'], damping=damping, stats=stats,
            did_factor=bool(factor_update),
            did_inv=inv_chunk is None and bool(inv_update),
            did_chunk=inv_chunk is not None, factor_finite=finite,
            eig_clipped=obs_metrics.count_clipped_eigvals(inverses,
                                                          self.device))
        return precond, {**state_i, 'step': step + 1, 'metrics': metrics}

    def guard_factors(self, candidate: dict, old: dict
                      ) -> tuple[dict, torch.Tensor | None]:
        """``(factors, finite)`` of a factor step: the candidate factors
        through :func:`guard_nonfinite_factors`, and the finiteness flag
        the metrics count (None with neither the guard nor the metrics on,
        where the step computes none). The guard's flag is exact; the
        metrics alone take ``observability.metrics.factors_finite``, one
        ``torch._foreach_norm`` over the factors."""
        finite = None
        if self.nonfinite_guard:
            finite = fp16.tree_all_finite(candidate)
        elif self.collect_metrics:
            finite = obs_metrics.factors_finite(candidate)
        return (guard_nonfinite_factors(candidate, old, self.nonfinite_guard,
                                        finite), finite)

    # ------------------------------------------------------------------
    # Introspection and checkpoint helpers
    # ------------------------------------------------------------------

    def memory_usage(self, state: dict) -> dict[str, int]:
        """Bytes held by the factors and by the inverses of ``state``
        (the JAX ``KFAC.memory_usage``)."""
        return {'factors': _nbytes(state['factors']),
                'inverses': _nbytes(state['inverses'])}

    def state_dict(self, state: dict, include_inverses: bool = False
                   ) -> dict:
        """Checkpointable dict: factors + step, the firing-schedule state
        where its knob is on (``factor_accum`` with ``accum_decay``,
        ``frozen_factors``), inverses optional (they are recomputed on
        load otherwise, as in the JAX package)."""
        out = {'step': state['step'], 'factors': state['factors'],
               'inv_chunk_phase': state.get('inv_chunk_phase', 0)}
        for key in OVERLAP_KEYS:
            if key in state:
                out[key] = state[key]
        if include_inverses:
            out['inverses'] = state['inverses']
        return out

    def load_state_dict(self, sd: dict,
                        compute_inverses: bool = True) -> dict:
        """Rebuild the full state from :meth:`state_dict` output: layer
        sets must match; stored inverses are used when their layout
        (slot keys and shapes) matches, else they are recomputed from the
        factors (library eigh for eigen sides, damped inverses at the
        constructor's damping for the others). Factors and inverses take
        this ``KFAC``'s storage dtypes (a bf16 state round-trips as it
        is). The firing-schedule state is restored by
        :func:`overlay_overlap_state`: a bundle without it loads with the
        JAX package's defaults."""
        state = self.init_state()
        if set(sd['factors']) != set(state['factors']):
            raise ValueError(
                'checkpoint layers do not match registered layers: '
                f'{sorted(sd["factors"])} vs {sorted(state["factors"])}')
        factors = {n: {k: t.to(self.device, self.storage_dtype)
                       for k, t in f.items()}
                   for n, f in sd['factors'].items()}
        state = {**state, 'step': int(sd['step']), 'factors': factors,
                 'inv_chunk_phase': int(sd.get('inv_chunk_phase', 0))}
        state = overlay_overlap_state(state, sd)
        saved = sd.get('inverses')
        compatible = saved is not None and all(
            set(saved.get(n, ())) == set(state['inverses'][n])
            and all(tuple(saved[n][k].shape)
                    == tuple(state['inverses'][n][k].shape)
                    for k in state['inverses'][n])
            for n in state['inverses'])
        if compatible:
            state['inverses'] = {n: {k: t.to(self.device, self.inv_dtype)
                                     for k, t in e.items()}
                                 for n, e in saved.items()}
        elif compute_inverses:
            state['inverses'] = self.update_inverses(state, warm=False)
        return state


#: State keys of the firing-schedule knobs, present only with their knob
#: on (``deferred_factor_reduction``: the first two; ``inv_staleness``:
#: the last).
OVERLAP_KEYS = ('factor_accum', 'accum_decay', 'frozen_factors')


def _same_layout(saved, fresh: dict) -> bool:
    """Whether a saved ``{layer: {side: tensor}}`` dict has the layers,
    sides and shapes of ``fresh``."""
    return (isinstance(saved, dict) and set(saved) == set(fresh)
            and all(set(saved[n]) == set(fresh[n])
                    and all(tuple(saved[n][k].shape)
                            == tuple(fresh[n][k].shape) for k in fresh[n])
                    for n in fresh))


def overlay_overlap_state(state: dict, sd: dict) -> dict:
    """Restore ``factor_accum`` / ``accum_decay`` and ``frozen_factors``
    from a checkpoint into a rebuilt ``state`` that carries them (the
    JAX ``_overlay_overlap_state``). Each is taken when the checkpoint
    has it in the same layout, the accumulator only together with its
    decay product; otherwise the fresh seeds stand: a zero accumulator
    with decay 1, and a snapshot of the restored factors. Tensors take
    the state's devices and dtypes."""
    out = dict(state)

    def like(saved: dict, fresh: dict) -> dict:
        return {n: {k: t.to(fresh[n][k].device, fresh[n][k].dtype)
                    for k, t in e.items()} for n, e in saved.items()}

    if 'frozen_factors' in state:
        frozen = sd.get('frozen_factors')
        out['frozen_factors'] = (
            like(frozen, state['factors'])
            if _same_layout(frozen, state['factors'])
            else {n: dict(f) for n, f in out['factors'].items()})
    if 'factor_accum' in state:
        acc = sd.get('factor_accum')
        if 'accum_decay' in sd and _same_layout(acc, state['factor_accum']):
            out['factor_accum'] = like(acc, state['factor_accum'])
            out['accum_decay'] = torch.as_tensor(
                sd['accum_decay'], dtype=torch.float32,
                device=state['accum_decay'].device).reshape(())
    return out


def _nbytes(tree: dict) -> int:
    """Bytes of every tensor in a ``{layer: {key: tensor}}`` dict."""
    return sum(t.numel() * t.element_size()
               for e in tree.values() for t in e.values())


def grouped_init(spec, a_dim: int, g_dim: int, fdt, idt, device
                 ) -> tuple[dict, dict]:
    """A grouped conv's fresh ``({'A', 'G'}, {'A_inv', 'G_inv'})``:
    ``(G, d, d)`` stacks of identity factors in ``fdt`` and of zero
    inverses in ``idt`` (computed at step 0 before first use)."""
    n = spec.feature_group_count
    factors = {side: torch.eye(dim, dtype=fdt, device=device).repeat(n, 1, 1)
               for side, dim in (('A', a_dim), ('G', g_dim))}
    inverses = {f'{side}_inv': torch.zeros((n, dim, dim), dtype=idt,
                                           device=device)
                for side, dim in (('A', a_dim), ('G', g_dim))}
    return factors, inverses


def grouped_cost(spec, a_dim: int, g_dim: int) -> float:
    """The ``dim^3`` proxy cost of a grouped conv's firing, ``G (da^3 +
    dg^3)``: its work item in a chunk plan."""
    n = spec.feature_group_count
    return (n * linalg.decomposition_cost(a_dim)
            + n * linalg.decomposition_cost(g_dim))


def factor_scope(spec, side: str) -> str:
    """The profiler scope of one side's factor contraction, with the JAX
    package's names: ``kfac/factors/<kind>_<a|g>`` (``_reduced`` under
    'reduce'; an embedding's G is a Linear's)."""
    kind = 'linear' if spec.kind == EMBEDDING and side == 'G' else spec.kind
    reduced = (spec.kind in (LINEAR, CONV2D)
               and spec.kfac_approx == KFAC_REDUCE)
    return (f'kfac/factors/{kind}_{side.lower()}'
            + ('_reduced' if reduced else ''))


def precond_scope(entry: dict) -> str:
    """The profiler scope of a bucket's preconditioning: eigen slots or
    baked inverses."""
    return 'kfac/precond/eigen' if 'QA' in entry else 'kfac/precond/inv'


def gate_blend(mats: dict, grad_mats: dict, gates: dict) -> dict:
    """The quarantine blend: each layer of ``mats`` whose gradient
    matrix's shape bucket has a gate in ``gates`` becomes
    ``torch.where(gate >= 0.5, mat, g)``, ``g`` its raw gradient matrix;
    a select, so a NaN of the unselected branch does not propagate.
    Layers without a gate pass through."""
    out = dict(mats)
    for name, pm in mats.items():
        g = gates.get(obs_metrics.shape_key(grad_mats[name].shape))
        if g is None:
            continue
        keep = torch.as_tensor(g, device=pm.device) >= 0.5
        out[name] = torch.where(keep, pm, grad_mats[name].to(pm.dtype))
    return out


def guard_nonfinite_factors(new_factors: dict, old_factors: dict,
                            guard: bool, finite=None) -> dict:
    """The non-finite factor guard (the JAX ``guard_nonfinite_factors``),
    shared by ``KFAC`` and ``parallel.DistributedKFAC``: with ``guard``,
    ``new_factors`` if every element of every candidate factor is finite,
    else ``old_factors``, selected on the device from one finiteness flag
    (no host sync); without, ``new_factors``. The candidates are the
    post-average factors under ``DistributedKFAC``, the same on every
    rank, so every rank takes the same branch. ``finite``: the flag, when
    the caller computed it already."""
    if not guard:
        return new_factors
    if finite is None:
        finite = fp16.tree_all_finite(new_factors)
    return {name: {side: torch.where(finite, t, old_factors[name][side])
                   for side, t in entry.items()}
            for name, entry in new_factors.items()}


def grouped_block_inverses(factors: dict, damping, inv_dtype) -> dict:
    """A grouped conv's per-group damped block inverses, ``{'A_inv',
    'G_inv'}``: one batched damped Cholesky per side over its ``(G, d,
    d)`` factor stacks, in fp32, cast to ``inv_dtype``, whatever
    ``inverse_method`` says (the blocks are tiny: eigen bookkeeping would
    cost more than it saves). The single-device and the distributed
    firings share it (the JAX ``grouped_block_inverses``)."""
    return {f'{side}_inv': kernels.damped_inverse_stack(
                factors[side].float(), damping, 'cholesky').to(inv_dtype)
            for side in 'AG'}


def eigen_family(method: str) -> bool:
    """True for methods whose inverse slots are an eigenpair ``(Q, d)``
    read through the eigen precondition path: the exact ``'eigen'`` and
    the truncated ``'lowrank'``. A layer is *mixed* when exactly one side
    is eigen-family."""
    return method in ('eigen', 'lowrank')


def truncated_entry(entry: dict) -> bool:
    """Whether a precondition entry holds a truncated (low-rank) basis:
    such a bucket runs the stock precondition path, not the kernel (the
    JAX dispatch sites' ``_truncated_side`` check)."""
    return any(linalg.truncated_side(entry[k]) for k in ('QA', 'QG')
               if k in entry)


def _by_chunk(mats: dict, plan: dict | None) -> list[dict]:
    """``mats`` (keyed ``layer/side``) split by the chunk each matrix's
    item falls in, in chunk order; ``[mats]`` without a plan."""
    if plan is None:
        return [mats]
    out: dict[int, dict] = {}
    for key, m in mats.items():
        name, side = key.rsplit('/', 1)
        out.setdefault(plan[('mat', name, side)], {})[key] = m
    return [out[j] for j in sorted(out)]


def _zeros_like(factors: dict) -> dict:
    return {n: {k: torch.zeros_like(t) for k, t in f.items()}
            for n, f in factors.items()}


def measured_unit_scale(measured: dict, dim_counts: dict[int, int],
                        scope: str) -> float:
    """The ms-per-``dim^3`` factor of a measured chunk-cost dict
    (``{dim: whole-bucket ms}``; ``dim_counts``: the work units of each
    dim), which converts the remaining proxy costs (diagonal items) into
    the measured unit; 1.0 when nothing is measured. Measured ms and the
    proxy are different units, so the measurement must cover every dim of
    ``dim_counts`` (raises otherwise). Shared by the single-device and
    the distributed planner."""
    if not measured:
        return 1.0
    missing = sorted(d for d in dim_counts if d not in measured)
    if missing:
        raise ValueError(
            f'inv_pipeline_costs must cover every {scope} (missing '
            f'{missing}): measured ms and the dim^3 proxy are '
            'different units and cannot be mixed in one chunk packing '
            '— pass the full bucket_parts of a firing leg')
    proxy_total = sum(linalg.decomposition_cost(d, c)
                      for d, c in dim_counts.items())
    ms_total = sum(float(measured[d]) for d in dim_counts)
    return ms_total / proxy_total if ms_total > 0 else 1.0


def plan_inverse_chunks(items: Sequence[tuple[Any, float]],
                        k: int) -> dict[Any, int]:
    """``{key: chunk}`` of ``(key, cost)`` items packed onto ``k`` chunks
    by greedy LPT (``parallel.placement.load_balance``, the balancer of
    the KAISA work placement); the single-device and distributed planners
    share it."""
    assignment = load_balance(k, [cost for _, cost in items])
    return {key: chunk for (key, _), chunk in zip(items, assignment)}


def _size_buckets(mats: dict):
    """Group square matrices by size: yields ``(names, fp32 stack)`` in
    insertion order."""
    buckets: dict[int, list[str]] = {}
    for name, m in mats.items():
        buckets.setdefault(m.shape[-1], []).append(name)
    for names in buckets.values():
        yield names, torch.stack([mats[n].float() for n in names])
