"""Optimizer factory: SGD + single-device K-FAC + schedulers (PyTorch port
of ``distributed_kfac_pytorch_tpu/training/optimizers.py``).

``torch.optim.SGD`` with momentum and weight decay applies the decay
before the momentum (``g += wd*p; buf = m*buf + g; p -= lr*buf``), the
same order as the JAX package's optax chain (``add_decayed_weights`` ->
``trace`` -> ``scale_by_learning_rate``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC, \
    CommMethod
from distributed_kfac_pytorch_tpu_torch.scheduler import KFACParamScheduler
from distributed_kfac_pytorch_tpu_torch.training.utils import \
    create_lr_schedule


# CLI string -> CommMethod.
COMM_METHODS = {
    'comm-opt': CommMethod.COMM_OPT,
    'mem-opt': CommMethod.MEM_OPT,
    'hybrid-opt': CommMethod.HYBRID_OPT,
    'hybrid_opt': CommMethod.HYBRID_OPT,
    'comm_opt': CommMethod.COMM_OPT,
    'mem_opt': CommMethod.MEM_OPT,
}


@dataclasses.dataclass
class OptimConfig:
    """The subset of the JAX ``OptimConfig`` this port implements."""
    base_lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_epochs: float = 5.0
    lr_decay: Sequence[int] = (35, 75, 90)
    workers: int = 1                  # world size for the LR scaling
    # K-FAC (0 inverse update freq disables it: plain SGD)
    kfac_inv_update_freq: int = 10
    kfac_cov_update_freq: int = 1
    damping: float = 0.003
    factor_decay: float = 0.95
    kl_clip: float = 0.001
    inverse_method: str = 'auto'
    auto_eigen_max_dim: int = 640
    auto_large_method: str = 'cholesky'
    newton_iters: int = 100
    eigh_method: str = 'auto'
    eigh_polish_iters: int = 8
    # The port's hot-path kernels are on by default (see KFAC).
    fused_factor_contraction: bool = True
    fused_precondition: bool = True
    kfac_approx: Any = 'expand'       # 'expand' | 'reduce' | {pattern: ..}
    # Reduced precision, mapped onto the KFAC knobs as the JAX
    # OptimConfig maps them: bf16 factor storage and bf16 covariance
    # multiplicands (fp32 accumulation, fp32 blend rounded once); bf16
    # inverse storage (decompositions stay fp32); bf16 precondition
    # operands (fp32 accumulation). All False: the fp32 path, bit for bit.
    bf16_factors: bool = False
    bf16_inverses: bool = False
    bf16_precond: bool = False
    # The firing schedule (KFAC's knobs of the same names): the fraction
    # of the batch the factor statistics read, inverse firings in k
    # chunks over the window, the window-head factor reduction, and
    # one-window-stale inverses. The defaults are the classic schedule.
    factor_batch_fraction: float = 1.0
    inv_pipeline_chunks: int = 1
    deferred_factor_reduction: bool = False
    inv_staleness: int = 0
    # The randomized low-rank inverse and the two-level factor reduction
    # of a multi-slice world (KFAC's knobs of the same names).
    inv_lowrank_rank: int = 0
    inv_lowrank_dim_threshold: int = 2048
    hierarchical_reduce: bool = False
    # Observability: the on-device step metrics (KFAC collect_metrics,
    # the CLIs' --kfac-metrics) and the non-finite factor guard
    # (--health-action skip / raise arm it).
    kfac_metrics: bool = False
    nonfinite_guard: bool = False
    skip_layers: Sequence[str] = ()
    # Distribution (read by parallel.DistributedKFAC).
    comm_method: str = 'comm-opt'
    grad_worker_fraction: float = 0.25
    symmetry_aware_comm: bool = False
    damping_alpha: float = 1.0
    damping_schedule: Sequence[int] = ()
    kfac_update_freq_alpha: float = 1.0
    kfac_update_freq_schedule: Sequence[int] = ()


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group['lr'] = lr


def get_optimizer(model: torch.nn.Module, cfg: OptimConfig, device='cuda'):
    """``(optimizer, lr_schedule, kfac | None, kfac_scheduler | None)``.

    ``lr_schedule(epoch) -> lr`` is ``base_lr`` times the warm-up /
    decay factor (warm-up to ``workers`` times ``base_lr``); the caller
    feeds the same value to the optimizer and to the KL clip. K-FAC is on
    when ``kfac_inv_update_freq > 0``.
    """
    optimizer = torch.optim.SGD(model.parameters(), lr=cfg.base_lr,
                                momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay)
    factor = create_lr_schedule(cfg.workers, cfg.warmup_epochs,
                                cfg.lr_decay)
    lr_schedule = lambda epoch: cfg.base_lr * factor(epoch)  # noqa: E731
    kfac = kfac_scheduler = None
    if cfg.kfac_inv_update_freq > 0:
        kfac = KFAC(
            model,
            damping=cfg.damping,
            factor_decay=cfg.factor_decay,
            factor_update_freq=cfg.kfac_cov_update_freq,
            inv_update_freq=cfg.kfac_inv_update_freq,
            kl_clip=cfg.kl_clip,
            lr=cfg.base_lr,
            inverse_method=cfg.inverse_method,
            auto_eigen_max_dim=cfg.auto_eigen_max_dim,
            auto_large_method=cfg.auto_large_method,
            newton_iters=cfg.newton_iters,
            factor_dtype=torch.bfloat16 if cfg.bf16_factors else None,
            factor_compute_dtype=(torch.bfloat16 if cfg.bf16_factors
                                  else None),
            inv_dtype=(torch.bfloat16 if cfg.bf16_inverses
                       else torch.float32),
            precond_compute_dtype=(torch.bfloat16 if cfg.bf16_precond
                                   else None),
            factor_batch_fraction=cfg.factor_batch_fraction,
            inv_pipeline_chunks=cfg.inv_pipeline_chunks,
            deferred_factor_reduction=cfg.deferred_factor_reduction,
            inv_staleness=cfg.inv_staleness,
            inv_lowrank_rank=cfg.inv_lowrank_rank,
            inv_lowrank_dim_threshold=cfg.inv_lowrank_dim_threshold,
            hierarchical_reduce=cfg.hierarchical_reduce,
            eigh_method=cfg.eigh_method,
            eigh_polish_iters=cfg.eigh_polish_iters,
            kfac_approx=cfg.kfac_approx,
            skip_layers=list(cfg.skip_layers) or None,
            fused_factor_contraction=cfg.fused_factor_contraction,
            fused_precondition=cfg.fused_precondition,
            symmetry_aware_comm=cfg.symmetry_aware_comm,
            comm_method=COMM_METHODS[cfg.comm_method.lower()],
            grad_worker_fraction=cfg.grad_worker_fraction,
            collect_metrics=cfg.kfac_metrics,
            nonfinite_guard=cfg.nonfinite_guard,
            device=device)
        kfac_scheduler = KFACParamScheduler(
            kfac,
            damping_alpha=cfg.damping_alpha,
            damping_schedule=list(cfg.damping_schedule) or None,
            update_freq_alpha=cfg.kfac_update_freq_alpha,
            update_freq_schedule=(
                list(cfg.kfac_update_freq_schedule) or None))
    return optimizer, lr_schedule, kfac, kfac_scheduler
