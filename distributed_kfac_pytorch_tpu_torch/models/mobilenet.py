"""MobileNetV1 (Howard et al. 2017), NCHW (PyTorch port of
``distributed_kfac_pytorch_tpu/models/mobilenet.py``): the depthwise
workload.

A 3x3/2 stem conv, then 13 depthwise-separable blocks (a 3x3 depthwise
conv and a 1x1 pointwise conv, each BatchNorm + ReLU), global average
pool and a Linear head; widths scaled by ``width_mult`` as in the paper
(``max(8, int(planes * width_mult))``). Every depthwise conv is an
``nn.Conv2d`` with ``groups`` equal to its channels, which the K-FAC
capture registers as ``conv2d_grouped`` (per-group block-diagonal
factors); the stem, the pointwise convs and the head are dense layers.
Submodule names mirror the flax model (``conv1``, ``bn1``,
``block{i}.dw`` / ``bn_dw`` / ``pw`` / ``bn_pw``, ``fc``) so parameters
convert name for name (``convert.py``). ``dtype`` is the compute dtype,
as the JAX model's (its bench runs ``bfloat16`` activations): the convs
and the head compute in it with fp32 parameters, the BatchNorm
statistics stay fp32 (``modules.precision.set_compute_dtype``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)

# (pointwise out-planes, depthwise stride) per separable block: the
# paper's 13-block body (Table 1): 64, 128x2, 256x2, 512x6, 1024x2.
BODY = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1))


def _bn(planes: int, bn_momentum: float) -> nn.BatchNorm2d:
    # flax momentum m (new = m*old + (1-m)*batch) is torch momentum 1-m.
    return nn.BatchNorm2d(planes, eps=1e-5, momentum=1.0 - bn_momentum)


class SeparableBlock(nn.Module):
    """3x3 depthwise conv + 1x1 pointwise conv, each BatchNorm + ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.dw = nn.Conv2d(in_planes, in_planes, 3, stride=stride,
                            padding=1, groups=in_planes, bias=False)
        self.bn_dw = _bn(in_planes, bn_momentum)
        self.pw = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn_pw = _bn(planes, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_dw(self.dw(x)))
        return F.relu(self.bn_pw(self.pw(y)))


class MobileNetV1(nn.Module):
    """Stem + 13 separable blocks + pooled Linear head."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype=torch.float32, bn_momentum: float = 0.9):
        super().__init__()
        dtype = check_compute_dtype(dtype)

        def w(planes: int) -> int:
            return max(8, int(planes * width_mult))

        self.conv1 = nn.Conv2d(3, w(32), 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = _bn(w(32), bn_momentum)
        self.num_blocks = len(BODY)
        in_planes = w(32)
        for i, (planes, stride) in enumerate(BODY):
            self.add_module(f'block{i}', SeparableBlock(
                in_planes, w(planes), stride, bn_momentum))
            in_planes = w(planes)
        self.fc = nn.Linear(in_planes, num_classes)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        for i in range(self.num_blocks):
            y = getattr(self, f'block{i}')(y)
        return self.fc(y.mean(dim=(2, 3)))


def get_model(num_classes: int = 1000, width_mult: float = 1.0,
              bn_momentum: float = 0.9, dtype=torch.float32
              ) -> MobileNetV1:
    return MobileNetV1(num_classes=num_classes, width_mult=width_mult,
                       dtype=dtype, bn_momentum=bn_momentum)
