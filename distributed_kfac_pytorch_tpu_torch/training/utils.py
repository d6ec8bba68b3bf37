"""Training utilities: metrics, the label-smoothed loss and the LR
schedule (PyTorch port of ``distributed_kfac_pytorch_tpu/training/
utils.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


class Metric:
    """Weighted running average of a scalar (loss, accuracy).

    Values may be device tensors: they are summed on the device and read
    back once, when :attr:`avg` is read, so updates do not sync the host.
    """

    def __init__(self, name: str):
        self.name = name
        self._sum = 0.0
        self._n = 0.0

    def update(self, value, n: float = 1.0):
        self._sum = self._sum + value * n
        self._n += n

    @property
    def avg(self) -> float:
        return float(self._sum) / max(self._n, 1e-12)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy of logits vs integer labels (a device scalar)."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def label_smooth_loss(logits: torch.Tensor, labels: torch.Tensor,
                      smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross entropy against labels smoothed as ``one_hot * (1 -
    smoothing) + smoothing / n``; plain cross entropy at ``smoothing <=
    0``."""
    if smoothing <= 0.0:
        return F.cross_entropy(logits, labels)
    n = logits.shape[-1]
    target = torch.full_like(logits, smoothing / n)
    target.scatter_(-1, labels[:, None], 1.0 - smoothing + smoothing / n)
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def create_lr_schedule(workers: int, warmup_epochs: float,
                       decay_schedule: Sequence[int], alpha: float = 0.1):
    """LR *factor* schedule over epochs: linear warm-up, then step decay.

    Over ``warmup_epochs`` the factor rises from 1 (the base, per-worker
    lr) to ``workers``; after it, ``workers`` times ``alpha`` per epoch
    of ``decay_schedule`` passed. Returns ``f(epoch) -> factor``. One
    worker makes the warm-up flat.
    """
    decay_schedule = sorted(decay_schedule)

    def schedule(epoch: float) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return 1.0 + (workers - 1.0) * (epoch / warmup_epochs)
        factor = float(workers)
        for e in decay_schedule:
            if epoch >= e:
                factor *= alpha
        return factor

    return schedule
