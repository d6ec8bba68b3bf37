"""ImageNet ResNet-18/34/50/101/152 (He et al.), NCHW (PyTorch port of
``distributed_kfac_pytorch_tpu/models/imagenet_resnet.py``).

7x7/2 stem, 3x3/2 max-pool, [Basic|Bottleneck] stages, global average
pool, Linear head; option-B (projection) shortcuts, as torchvision's.
Submodule names mirror the flax model (``conv1``, ``bn1``,
``layer{stage}_block{i}.conv1..3`` / ``bn1..3`` / ``downsample_conv`` /
``downsample_bn``, ``fc``) so parameters convert name for name
(``convert.py``). ReLU is never in place, so the K-FAC output-grad hooks
see the tensors the layers produced. fp32 only: the JAX model's ``dtype``
(bf16 / fp16 activations) and ``remat`` (block rematerialization) are not
ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _bn(planes: int, bn_momentum: float) -> nn.BatchNorm2d:
    # flax momentum m (new = m*old + (1-m)*batch) is torch momentum 1-m.
    return nn.BatchNorm2d(planes, eps=1e-5, momentum=1.0 - bn_momentum)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlockV1(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.bn1 = _bn(planes, bn_momentum)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes, bn_momentum)
        self.projection = stride != 1 or in_planes != planes
        if self.projection:
            self.downsample_conv = _conv(in_planes, planes, 1, stride)
            self.downsample_bn = _bn(planes, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = (self.downsample_bn(self.downsample_conv(x)) if self.projection
              else x)
        return F.relu(y + sc)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck, expansion 4
    (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 bn_momentum: float = 0.9):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = _bn(planes, bn_momentum)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes, bn_momentum)
        self.conv3 = _conv(planes, out_planes, 1)
        self.bn3 = _bn(out_planes, bn_momentum)
        self.projection = stride != 1 or in_planes != out_planes
        if self.projection:
            self.downsample_conv = _conv(in_planes, out_planes, 1, stride)
            self.downsample_bn = _bn(out_planes, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = (self.downsample_bn(self.downsample_conv(x)) if self.projection
              else x)
        return F.relu(y + sc)


class ImageNetResNet(nn.Module):
    """Stem + 4 stages + pooled Linear head. Stage ``s`` uses ``width *
    2**(s-1)`` planes (64 is the paper network; narrow widths keep the
    topology at test sizes)."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True,
                 num_classes: int = 1000, dtype=torch.float32,
                 width: int = 64, bn_momentum: float = 0.9,
                 remat: bool = False):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                f'ImageNetResNet(dtype={dtype}) is not ported yet (fp32 '
                'only)')
        if remat:
            raise NotImplementedError(
                'ImageNetResNet(remat=True) (block rematerialization) is '
                'not ported yet')
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(width, bn_momentum)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        block = Bottleneck if bottleneck else BasicBlockV1
        self.block_names = []
        in_planes = width
        for stage, n_blocks in enumerate(self.stage_sizes, start=1):
            planes = width * 2 ** (stage - 1)
            for i in range(n_blocks):
                stride = 2 if (stage > 1 and i == 0) else 1
                name = f'layer{stage}_block{i}'
                self.add_module(name, block(in_planes, planes, stride,
                                            bn_momentum))
                self.block_names.append(name)
                in_planes = planes * block.expansion
        self.fc = nn.Linear(in_planes, num_classes)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pool(F.relu(self.bn1(self.conv1(x))))
        for name in self.block_names:
            y = getattr(self, name)(y)
        return self.fc(y.mean(dim=(2, 3)))


_CONFIGS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}


def resnet(depth: int, num_classes: int = 1000, dtype=torch.float32,
           bn_momentum: float = 0.9, remat: bool = False) -> ImageNetResNet:
    """ImageNet ResNet by depth (18/34/50/101/152)."""
    if depth not in _CONFIGS:
        raise ValueError(f'unsupported ImageNet ResNet depth {depth}; '
                         f'choose from {sorted(_CONFIGS)}')
    sizes, bottleneck = _CONFIGS[depth]
    return ImageNetResNet(sizes, bottleneck=bottleneck,
                          num_classes=num_classes, dtype=dtype,
                          bn_momentum=bn_momentum, remat=remat)


def get_model(name: str, num_classes: int = 1000, dtype=torch.float32,
              bn_momentum: float = 0.9, remat: bool = False
              ) -> ImageNetResNet:
    """Model by name, e.g. ``'resnet50'``."""
    name = name.lower()
    if not name.startswith('resnet'):
        raise ValueError(f'unknown ImageNet model {name!r}')
    return resnet(int(name[len('resnet'):]), num_classes, dtype,
                  bn_momentum, remat)
