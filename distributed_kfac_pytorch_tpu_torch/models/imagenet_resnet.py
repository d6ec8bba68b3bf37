"""ImageNet ResNet-18/34/50/101/152 (He et al.), NCHW (PyTorch port of
``distributed_kfac_pytorch_tpu/models/imagenet_resnet.py``).

7x7/2 stem, 3x3/2 max-pool, [Basic|Bottleneck] stages, global average
pool, Linear head; option-B (projection) shortcuts, as torchvision's.
Submodule names mirror the flax model (``conv1``, ``bn1``,
``layer{stage}_block{i}.conv1..3`` / ``bn1..3`` / ``downsample_conv`` /
``downsample_bn``, ``fc``) so parameters convert name for name
(``convert.py``). ReLU is never in place, so the K-FAC output-grad hooks
see the tensors the layers produced. ``dtype`` is the compute dtype, as
the JAX model's (``torch.float16`` under the CLI's ``--fp16``,
``torch.bfloat16``): convs and the head compute in it with fp32
parameters, the BatchNorm statistics stay fp32
(``modules.precision.set_compute_dtype``).

``remat=True`` rematerializes each residual block in training (the JAX
model's ``nn.remat``): ``torch.utils.checkpoint`` (non-reentrant) keeps
the block's input only and recomputes its activations in the backward
pass (:func:`remat_block`). The recomputation runs under
``capture.recomputation`` (the K-FAC capture keeps the forward pass's
records only) and leaves the block's BatchNorm running statistics as the
forward pass left them, as flax discards a remat's mutations: a remat
step updates them once, as the plain step does.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_kfac_pytorch_tpu_torch.capture import recomputation
from distributed_kfac_pytorch_tpu_torch.modules.precision import (
    check_compute_dtype,
    set_compute_dtype,
)


def _bn(planes: int, bn_momentum: float) -> nn.BatchNorm2d:
    # flax momentum m (new = m*old + (1-m)*batch) is torch momentum 1-m.
    return nn.BatchNorm2d(planes, eps=1e-5, momentum=1.0 - bn_momentum)


@contextlib.contextmanager
def _recompute(block: nn.Module):
    """A block's recomputation: no capture records, and its buffers (the
    BatchNorm running statistics and counters) back as they were when it
    ends, early stop included."""
    saved = [b.clone() for b in block.buffers()]
    try:
        with recomputation():
            yield
    finally:
        with torch.no_grad():
            for b, v in zip(block.buffers(), saved):
                b.copy_(v)


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward pass
    instead of kept (non-reentrant ``torch.utils.checkpoint``, recomputed
    under :func:`_recompute`)."""
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute(block)))


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
    topology at test sizes). ``remat``: each residual block is
    rematerialized (:func:`remat_block`) in training mode with grad on."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True,
                 num_classes: int = 1000, dtype=torch.float32,
                 width: int = 64, bn_momentum: float = 0.9,
                 remat: bool = False):
        super().__init__()
        dtype = check_compute_dtype(dtype)
        self.remat = bool(remat)
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
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pool(F.relu(self.bn1(self.conv1(x))))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            y = remat_block(block, y) if remat else block(y)
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
