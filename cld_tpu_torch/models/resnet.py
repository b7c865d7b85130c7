"""ResNet-18 map encoder with the avg-pool head (port of
`cld_tpu/models/resnet.py:26-137`), written out by hand.

The public boundary takes NHWC rasters [B, H, W, C] like the JAX module;
inside, the convolutions run NCHW. Keys follow torchvision's layout
(``layer{s}.{b}.conv1`` ...), which the converted weights use.

Train or eval is an argument (`train=`), as in the JAX package, not the
module's `.training` flag: with `train=False` BatchNorm normalizes with its
running statistics (epsilon 1e-5); with `train=True` it normalizes with the
batch's and moves the running ones as flax's BatchNorm does, momentum 0.99
and the biased batch variance (`torch.nn.BatchNorm2d` would store the unbiased
one at momentum 0.1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's running-statistics rule (see the module
    docstring). State-dict keys are `torch.nn.BatchNorm2d`'s."""

    RUNNING_DECAY = 0.99

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            d = self.RUNNING_DECAY
            self.running_mean.mul_(d).add_(mean, alpha=1.0 - d)
            self.running_var.mul_(d).add_(var, alpha=1.0 - d)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class _Downsample(nn.Sequential):
    """1x1 projection + BatchNorm (keys ``0.*`` and ``1.*``)."""

    def forward(self, x, train: bool = False):
        return self[1](self[0](x), train)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity or 1x1 projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = _Downsample(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                BatchNorm2d(planes),
            )

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + residual)


class ResNet18Encoder(nn.Module):
    """ResNet-18 backbone -> global average pool -> Linear(feature_dim).

    Input [B, H, W, C] (NHWC); output [B, feature_dim]. The fc output has no
    activation, as in the JAX module."""

    def __init__(self, in_channels: int = 34, feature_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        planes = 64
        for stage in range(4):
            width = 64 * 2**stage
            stride = 1 if stage == 0 else 2
            blocks = [BasicBlock(planes, width, stride), BasicBlock(width, width)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes = width
        self.fc = nn.Linear(planes, feature_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, train)
        return self.fc(torch.mean(x, dim=(2, 3)))
