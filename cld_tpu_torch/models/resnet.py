"""ResNet-18 map encoder with the avg-pool head (port of
`cld_tpu/models/resnet.py:26-137`), written out by hand.

The public boundary takes NHWC rasters [B, H, W, C] like the JAX module;
inside, the convolutions run NCHW. BatchNorm runs in eval mode on its
running statistics (epsilon 1e-5). Keys follow torchvision's layout
(``layer{s}.{b}.conv1`` ...), which the converted weights use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity or 1x1 projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18Encoder(nn.Module):
    """ResNet-18 backbone -> global average pool -> Linear(feature_dim).

    Input [B, H, W, C] (NHWC); output [B, feature_dim]. The fc output has no
    activation, as in the JAX module."""

    def __init__(self, in_channels: int = 34, feature_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        planes = 64
        for stage in range(4):
            width = 64 * 2**stage
            stride = 1 if stage == 0 else 2
            blocks = [BasicBlock(planes, width, stride), BasicBlock(width, width)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes = width
        self.fc = nn.Linear(planes, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.mean(x, dim=(2, 3)))
