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
time, by damped Cholesky or Newton--Schulz). A *mixed* layer (one side
of each kind) also bakes its eigen side at the firing's damping, and is
preconditioned through its baked inverses.

Embedding layers carry a diagonal A (a vector over the vocabulary, its
inverse the elementwise one, damping baked at the firing) and a dense G
under the per-dim dispatch; they are preconditioned one by one outside
the buckets, their ``v.g`` inside the KL clip. ``kfac_approx`` (the
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
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.capture import CONV2D, EMBEDDING, \
    KFAC_REDUCE, LINEAR, KFACCapture, subsample_captures
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


#: Constructor knobs of the JAX ``KFAC`` that this port does not
#: implement yet, with the value that means "off". Passing any other
#: value raises ``NotImplementedError`` naming the knob.
NOT_PORTED = {
    'inv_lowrank_rank': 0,
    'inv_lowrank_dim_threshold': 2048,
    'hierarchical_reduce': False,
    'collect_metrics': False,
    'nonfinite_guard': False,
}


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


def _check_not_ported(knobs: dict) -> None:
    for key, value in knobs.items():
        if key not in NOT_PORTED:
            raise TypeError(f'KFAC got an unexpected keyword argument '
                            f'{key!r}')
        if value != NOT_PORTED[key]:
            raise NotImplementedError(
                f'KFAC({key}={value!r}) is not ported to torch yet (only '
                f'{key}={NOT_PORTED[key]!r} is)')


class KFAC:
    """K-FAC gradient preconditioner over a torch model (single device).

    Hyperparameters follow the JAX ``KFAC`` (see its docstring); the ones
    this port has not implemented are listed in :data:`NOT_PORTED`.

    Args:
      model: the ``nn.Module`` to precondition; its ``nn.Linear``,
        ``nn.Conv2d`` (groups=1) and ``nn.Embedding`` layers are
        registered at construction.
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
        buckets, in place of the ``dim^3`` proxy; it must cover every
        dense factor dim.
      deferred_factor_reduction: factor steps fold into a local
        accumulator; the window head (``step(factor_reduce=True)``)
        applies it to the factors, one collective per window under
        ``parallel.DistributedKFAC``.
      inv_staleness: 0, or 1: window heads snapshot the factors
        (``step(factor_snapshot=True)``) and the chunks fire from that
        snapshot one step after their phase.
      symmetry_aware_comm: average only each factor's packed triangle
        across ranks (``ops.factors.pack_symmetric``), about half the
        bytes; read by ``parallel.DistributedKFAC``.
      assignment_strategy: ``'compute'`` (``n^3``) or ``'memory'``
        (``n^2``): the cost model of the distributed work placement.
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
                 deferred_factor_reduction: bool = False,
                 inv_staleness: int = 0,
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
                 device='cuda',
                 **not_ported):
        _check_not_ported(not_ported)
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
        self.deferred_factor_reduction = bool(deferred_factor_reduction)
        self.inv_staleness = int(inv_staleness)
        self.fused_factor_contraction = bool(fused_factor_contraction)
        self.fused_precondition = bool(fused_precondition)
        self.symmetry_aware_comm = bool(symmetry_aware_comm)
        self.assignment_strategy = assignment_strategy
        self.comm_method = comm_method_of(comm_method)
        self.grad_worker_fraction = grad_worker_fraction
        #: The KL-clip scale of the last :meth:`precondition` (a device
        #: scalar).
        self.last_nu = None

    def __repr__(self) -> str:
        """Hyperparameter dump (the JAX ``KFAC.__repr__`` for the knobs
        the port has)."""
        fields = ('damping', 'factor_decay', 'factor_update_freq',
                  'inv_update_freq', 'kl_clip', 'lr', 'use_eigen_decomp',
                  'inverse_method',
                  'auto_eigen_max_dim', 'auto_large_method', 'eigh_method',
                  'eigh_polish_iters', 'newton_iters',
                  'factor_batch_fraction', 'factor_dtype',
                  'factor_compute_dtype', 'inv_dtype', 'capture_dtype',
                  'precond_compute_dtype', 'precond_bucketing',
                  'inv_pipeline_chunks',
                  'deferred_factor_reduction', 'inv_staleness',
                  'kfac_approx', 'tied_embeddings',
                  'symmetry_aware_comm', 'assignment_strategy',
                  'comm_method', 'grad_worker_fraction',
                  'fused_factor_contraction', 'fused_precondition')
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
        """Inverse method of a factor of this dimension: ``'auto'``
        dispatches per dim (eigen up to ``auto_eigen_max_dim``,
        ``auto_large_method`` above); the global modes return
        themselves."""
        if self.inverse_method == 'auto':
            return ('eigen' if dim <= self.auto_eigen_max_dim
                    else self.auto_large_method)
        return self.inverse_method

    def _side_methods(self, a_dim: int, g_dim: int, name: str
                      ) -> tuple[str | None, str]:
        """(A-side, G-side) inverse methods of layer ``name``; an
        embedding's diagonal A has none."""
        ma = (None if self.specs[name].kind == EMBEDDING
              else self.method_for_dim(a_dim))
        return ma, self.method_for_dim(g_dim)

    def _is_mixed(self, methods) -> bool:
        """One side eigen and the other baked (a diagonal A is neither)."""
        ma, mg = methods
        return ma is not None and eigen_family(ma) != eigen_family(mg)

    # ------------------------------------------------------------------
    # Pipelined inverse firing: the chunk plan
    # ------------------------------------------------------------------

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
        'A'|'G')``, and one per embedding's diagonal A, ``('diag',
        layer)``. A matrix costs the ``dim^3`` proxy
        (``linalg.decomposition_cost``), or with ``inv_pipeline_costs``
        its bucket's measured ms split evenly over the bucket's matrices;
        a diagonal A costs its dim, rescaled into the measured unit
        (:func:`measured_unit_scale`, which requires the measurement to
        cover every dense factor dim)."""
        dense_count: dict[int, int] = {}
        for name, spec in self.specs.items():
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
            return linalg.decomposition_cost(dim)

        items: list[tuple[tuple, float]] = []
        for name, spec in self.specs.items():
            f = factors[name]
            a_dim = int(f['A'].shape[-1])
            g_dim = int(f['G'].shape[-1])
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
        """Fresh state: identity factors (an embedding's diagonal A: ones)
        in the storage dtype; eigen slots seeded with their exact
        eigendecomposition (``Q = I, d = 1``) so the warm polish has a
        basis from step 0; baked slots (non-eigen sides, the eigen side of
        a mixed layer, an embedding's diagonal ``A_inv``) zero, computed
        at step 0 before first use; every inverse slot in ``inv_dtype``."""
        params = dict(self.model.named_parameters())
        dev = self.device
        fdt, idt = self.storage_dtype, self.inv_dtype
        factors, inverses = {}, {}
        for name, spec in self.specs.items():
            dims = dict(zip('AG', L.factor_shapes(
                spec, self._layer_params(name, params))))
            methods = dict(zip('AG', self._side_methods(dims['A'],
                                                        dims['G'], name)))
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
                    entry[f'Q{side}'] = torch.eye(dim, dtype=idt,
                                                  device=dev)
                    entry[f'd{side}'] = torch.ones(dim, dtype=idt,
                                                   device=dev)
                if mixed or not eigen_family(methods[side]):
                    entry[f'{side}_inv'] = torch.zeros(
                        (dim, dim), dtype=idt, device=dev)
            inverses[name] = entry
        state = {'step': 0, 'factors': factors, 'inverses': inverses,
                 'inv_chunk_phase': 0}
        return self._seed_overlap_state(state)

    def _seed_overlap_state(self, state: dict) -> dict:
        """Add the fresh state of the firing-schedule knobs: under
        ``deferred_factor_reduction`` a zero accumulator of the factors'
        layout and dtype (``factor_accum``) and its decay product
        ``accum_decay`` (an fp32 device scalar, 1); under
        ``inv_staleness=1`` the snapshot ``frozen_factors`` (the factors
        themselves). With chunks, the plan is checked here, once."""
        factors = state['factors']
        if self.deferred_factor_reduction:
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
        conv G (read in place as ``(B*H*W, C)``) and an untied embedding's
        single-call G. Conv A has its own patch-covariance kernel; a
        reduced conv, an embedding's A, a tied embedding's G and
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
        elif spec.kind == CONV2D and len(entry['g']) == 1 \
                and spec.kfac_approx != KFAC_REDUCE:
            g = entry['g'][0]
            b, _, h, w = g.shape
            out['G'] = (g, float(b * h * w) * (h * w) ** 2, False)
        return out

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
                if side in fused:
                    x, scale, has_bias = fused[side]
                    contrib[side] = kernels.factor_ema(
                        x, None, 0.0, scale=scale, has_bias=has_bias,
                        compute_dtype=cdt)
                else:
                    contrib[side] = compute(spec, calls, compute_dtype=cdt)
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
                res[side] = kernels.factor_ema(
                    x, old[side], alpha, scale=scale, has_bias=has_bias,
                    compute_dtype=cdt)
            new_factors[name] = {side: res[side] for side in 'AG'}
        return new_factors

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
        library eigh instead. The other sides get damped inverses per
        size bucket. A mixed layer's eigen side is also baked into
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

        eigen_mats, inv_mats, prev, sides = {}, {}, {}, {}
        for name in self.specs:
            f = state['factors'][name]
            sides[name] = self._side_methods(f['A'].shape[-1],
                                             f['G'].shape[-1], name)
            for side, method in zip('AG', sides[name]):
                if method is None or not fires(('mat', name, side)):
                    continue
                key = f'{name}/{side}'
                if eigen_family(method):
                    eigen_mats[key] = f[side]
                    prev[key] = state['inverses'][name][f'Q{side}']
                else:
                    inv_mats[key] = f[side]
        prev = prev if warm else None
        eigs, invs = {}, {}
        for mats in _by_chunk(eigen_mats, plan):
            eigs.update(self._bucketed_eigh(mats, prev))
        for mats in _by_chunk(inv_mats, plan):
            invs.update(self._bucketed_inverse(mats, damping))
        idt = self.inv_dtype
        new_inv = {}
        for name in self.specs:
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
        Returns ``(mats, vg)``: the preconditioned matrix per layer and,
        for the stacks the kernel ran, its per-layer ``sum(v * g)``.
        Embeddings (a diagonal A) are left to the caller.
        """
        groups: dict[tuple, list[str]] = {}
        for name, mat in grad_mats.items():
            if self.specs[name].kind != EMBEDDING:
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
            if self.fused_precondition:
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

    def precondition(self, state: dict, grads: dict, damping, lr) -> dict:
        """Precondition the registered layers' grads and apply the KL-clip
        scale ``nu = min(1, sqrt(kl_clip / |sum lr^2 v.g|))`` (a device
        tensor); unregistered grads pass through."""
        grad_mats = {
            name: L.grads_to_matrix(spec, self._layer_params(name, grads))
            for name, spec in self.specs.items()}
        precond_mats, fused_vg = self._bucketed_precond_mats(
            state['inverses'], grad_mats, damping)
        for name, spec in self.specs.items():
            if spec.kind == EMBEDDING:
                inv = state['inverses'][name]
                precond_mats[name] = linalg.precondition_dispatch(
                    grad_mats[name], inv, damping, diag_a=inv['A_inv'],
                    compute_dtype=self.precond_compute_dtype)
        if self.kl_clip is not None:
            # Registration order, like the JAX package's summation.
            vg_sum = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
            for name in self.specs:
                if name in fused_vg:
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
             factor_snapshot: bool = False) -> tuple[dict, dict]:
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
            if factor_reduce:
                factors = self.reduce_factors(state, acc, decay)
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
            factors = (self.update_factors(state, captures, factor_decay,
                                           contribs=contribs)
                       if factor_update else state['factors'])
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
        precond = self.precondition(state_i, grads, damping, lr)
        return precond, {**state_i, 'step': step + 1}

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


def eigen_family(method: str) -> bool:
    """True for methods whose inverse slots are an eigenpair ``(Q, d)``
    read through the eigen precondition path (in the port, ``'eigen'``;
    the JAX package's low-rank method is not ported). A layer is *mixed*
    when exactly one side is eigen-family."""
    return method == 'eigen'


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
