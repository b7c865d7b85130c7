"""ResNet-18 / 34 / 50 map encoders with an average-pool or spatial-softmax
head (port of `cld_tpu/models/resnet.py`), written out by hand.

The public boundary takes NHWC rasters [B, H, W, C] like the JAX module;
inside, the convolutions run NCHW. Keys follow torchvision's layout
(``layer{s}.{b}.conv1`` ...), which the converted weights use.

Train or eval is an argument (`train=`), as in the JAX package, not the
module's `.training` flag: with `train=False` BatchNorm normalizes with its
running statistics (epsilon 1e-5); with `train=True` it normalizes with the
batch's and moves the running ones as flax's BatchNorm does, momentum 0.99
and the biased batch variance (`torch.nn.BatchNorm2d` would store the unbiased
one at momentum 0.1). Under bf16 compute (autocast, `ops.precision`) the
convolutions run in bf16 and BatchNorm takes its batch statistics in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cld_tpu_torch.models.spatial_softmax import SpatialSoftmax


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's running-statistics rule (see the module
    docstring). State-dict keys are `torch.nn.BatchNorm2d`'s."""

    RUNNING_DECAY = 0.99

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        y, mean, var = self.normalize_batch(x)
        with torch.no_grad():
            d = self.RUNNING_DECAY
            self.running_mean.mul_(d).add_(mean.detach(), alpha=1.0 - d)
            self.running_var.mul_(d).add_(var.detach(), alpha=1.0 - d)
            self.num_batches_tracked += 1
        return y

    def normalize_batch(self, x: torch.Tensor):
        """(x normalized by the batch's statistics, their mean, their biased
        variance): the train-mode normalization, which data parallelism
        overrides (`parallel.mesh.GlobalBatchNorm2d`)."""
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)),
                                       dim=(0, 2, 3), unbiased=False)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps), mean, var


class _Downsample(nn.Sequential):
    """1x1 projection + BatchNorm (keys ``0.*`` and ``1.*``)."""

    def forward(self, x, train: bool = False):
        return self[1](self[0](x), train)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity or 1x1 projection shortcut."""

    expansion = 1

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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 convs with 4x expansion, + identity or
    1x1 projection shortcut (the JAX `Bottleneck`, v1: stride on the 3x3)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or in_planes != out:
            self.downsample = _Downsample(
                nn.Conv2d(in_planes, out, 1, stride=stride, bias=False), BatchNorm2d(out),
            )

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + residual)


# arch -> (block, blocks per stage, trunk output channels)
ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 512),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 512),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 2048),
}


def check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"unknown map encoder arch {arch!r}; known: {sorted(ARCHS)}")


class ResNetTrunk(nn.Module):
    """The stem (7x7 stride-2 conv, BatchNorm, ReLU, 3x3 stride-2 max pool)
    and the four stages of `arch`, over NCHW. `forward` returns the four
    stages' outputs (1/4 .. 1/32 of the input's size)."""

    def __init__(self, arch: str = "resnet18", in_channels: int = 34):
        super().__init__()
        check_arch(arch)
        block, stage_sizes, self.out_channels = ARCHS[arch]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        planes = 64
        for stage, num_blocks in enumerate(stage_sizes):
            width = 64 * 2**stage
            blocks = []
            for b in range(num_blocks):
                blocks.append(block(planes, width, 2 if stage > 0 and b == 0 else 1))
                planes = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, train)
            feats.append(x)
        return feats


class ResNetEncoder(ResNetTrunk):
    """ResNet backbone -> global average pool or spatial-softmax keypoints
    -> Linear(feature_dim).

    Input [B, H, W, C] (NHWC); output [B, feature_dim]. The fc output has no
    activation, as in the JAX module. `pool="spatial_softmax"` puts
    `num_kp` expected keypoints (a 1x1 conv mixes the trunk's channels
    first) in place of the average."""

    def __init__(self, arch: str = "resnet18", in_channels: int = 34, feature_dim: int = 256,
                 pool: str = "avg", num_kp: int = 32):
        super().__init__(arch, in_channels)
        if pool not in ("avg", "spatial_softmax"):
            raise ValueError(f"unknown pool {pool!r}; known: 'avg', 'spatial_softmax'")
        self.spatial_softmax = None
        head_in = self.out_channels
        if pool == "spatial_softmax":
            self.spatial_softmax = SpatialSoftmax(self.out_channels, num_kp)
            head_in = 2 * self.spatial_softmax.num_kp
        self.fc = nn.Linear(head_in, feature_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = super().forward(x.permute(0, 3, 1, 2), train)[-1]  # NHWC -> NCHW
        if self.spatial_softmax is not None:
            return self.fc(self.spatial_softmax(x))
        return self.fc(torch.mean(x, dim=(2, 3)))


class ResNet18Encoder(ResNetEncoder):
    """The ResNet-18 encoder with the average-pool head."""

    def __init__(self, in_channels: int = 34, feature_dim: int = 256):
        super().__init__("resnet18", in_channels, feature_dim)
