"""CIFAR-10 ResNet family (He et al. arXiv:1512.03385), NCHW (PyTorch port
of ``distributed_kfac_pytorch_tpu/models/cifar_resnet.py``).

Submodule names mirror the flax model (``conv1``, ``bn1``,
``layer{stage}_block{i}.conv1``, ..., ``linear``) so parameters convert
name for name (``convert.py``). Option-A shortcut: a stride-2 subsample
and a zero channel pad, no parameters. ReLU is never in place, so the
K-FAC output-grad hooks see the tensors the layers produced.

A ``gn`` suffix (``'resnet20gn'``) swaps every BatchNorm for a GroupNorm
of 8 groups (the JAX package's stateless-normalization control), under
the same names, with flax's epsilon ``1e-6`` (torch's default is
``1e-5``). ``dtype`` is the compute dtype, as the JAX model's
(``torch.float16`` under the CLI's ``--fp16``): convs and the head
compute in it with fp32 parameters, the norms' statistics stay fp32
(``modules.precision.set_compute_dtype``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)


def _norm(planes: int, norm: str, bn_momentum: float) -> nn.Module:
    """BatchNorm (``norm='batch'``) or GroupNorm of 8 groups
    (``'group'``)."""
    if norm == 'group':
        return nn.GroupNorm(8, planes, eps=1e-6)
    # flax momentum m (new = m*old + (1-m)*batch) is torch momentum 1-m.
    return nn.BatchNorm2d(planes, eps=1e-5, momentum=1.0 - bn_momentum)


class BasicBlock(nn.Module):
    """3x3 conv -> BN -> relu -> 3x3 conv -> BN + shortcut -> relu."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 bn_momentum: float = 0.9, norm: str = 'batch'):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = _norm(planes, norm, bn_momentum)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _norm(planes, norm, bn_momentum)
        self.pad = (planes // 4 if stride != 1 or in_planes != planes
                    else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.pad is not None:
            sc = F.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, self.pad, self.pad))
        else:
            sc = x
        return F.relu(y + sc)


class CifarResNet(nn.Module):
    """Stacked BasicBlocks over 16/32/64 planes + global-pool Linear head."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int = 10,
                 bn_momentum: float = 0.9, norm: str = 'batch',
                 dtype=torch.float32):
        super().__init__()
        dtype = check_compute_dtype(dtype)
        self.num_blocks = tuple(num_blocks)
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn1 = _norm(16, norm, bn_momentum)
        self.block_names = []
        in_planes = 16
        for stage, (planes, stride) in enumerate(
                zip((16, 32, 64), (1, 2, 2)), start=1):
            for i in range(self.num_blocks[stage - 1]):
                name = f'layer{stage}_block{i}'
                self.add_module(name, BasicBlock(
                    in_planes, planes, stride if i == 0 else 1,
                    bn_momentum, norm))
                self.block_names.append(name)
                in_planes = planes
        self.linear = nn.Linear(64, num_classes)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        for name in self.block_names:
            y = getattr(self, name)(y)
        return self.linear(y.mean(dim=(2, 3)))


_DEPTHS = {20: (3, 3, 3), 32: (5, 5, 5), 44: (7, 7, 7), 56: (9, 9, 9),
           110: (18, 18, 18), 1202: (200, 200, 200)}


def resnet(depth: int, num_classes: int = 10, bn_momentum: float = 0.9,
           norm: str = 'batch', dtype=torch.float32) -> CifarResNet:
    """CIFAR ResNet by depth (20/32/44/56/110/1202)."""
    if depth not in _DEPTHS:
        raise ValueError(f'unsupported CIFAR ResNet depth {depth}; '
                         f'choose from {sorted(_DEPTHS)}')
    return CifarResNet(_DEPTHS[depth], num_classes, bn_momentum, norm,
                       dtype)


def get_model(name: str, num_classes: int = 10,
              bn_momentum: float = 0.9, dtype=torch.float32
              ) -> CifarResNet:
    """Model by name, e.g. ``'resnet32'``; a ``gn`` suffix
    (``'resnet20gn'``) swaps BatchNorm for GroupNorm."""
    name = name.lower()
    if not name.startswith('resnet'):
        raise ValueError(f'unknown CIFAR model {name!r}')
    norm = 'batch'
    if name.endswith('gn'):
        norm, name = 'group', name[:-2]
    return resnet(int(name[len('resnet'):]), num_classes, bn_momentum,
                  norm, dtype)
