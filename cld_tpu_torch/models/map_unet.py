"""Rasterized map UNet: dense spatial prediction over the scene raster (port
of `cld_tpu/models/map_unet.py`). A ResNet trunk over the raster feeds a
decoder with skips from its stages and two plain upsampling steps, giving a
full-resolution [B, H, W, output_channels] map (the spatial planner's 4
channels, the occupancy metric's one channel per future frame).

Each decoder step upsamples by nearest x2, crops to the skip's size when the
trunk rounded a stage up (rasters not a multiple of 32), concatenates the
skip, and applies two 3x3 conv + BatchNorm + ReLU; the output is cropped to
H x W and projected by a 1x1 conv. The trunk keeps torchvision's keys
(`conv1`, `layer1.0.conv1`, ...); the decoder the flax names (`up0`,
`up_final0`, `head`).

At `compute_dtype` bf16 (`ops.precision`) the trunk and the decoder run
under bf16 autocast over float32 parameters; the 1x1 head leaves autocast
and projects a float32 copy of its input, so the logits are float32, as the
JAX module's head is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cld_tpu_torch.models.resnet import ARCHS, BatchNorm2d, ResNetTrunk
from cld_tpu_torch.ops.precision import autocast, no_autocast

FINAL_WIDTHS = (64, 32)  # the two upsampling steps past the last skip (H/4 -> H)


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(filters)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor], train: bool = False):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            if skip.shape[2] != x.shape[2]:
                x = x[:, :, : skip.shape[2], : skip.shape[3]]
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn1(self.conv1(x), train))
        return F.relu(self.bn2(self.conv2(x), train))


class RasterizedMapUNet(ResNetTrunk):
    """Raster [B, H, W, C] -> logits [B, H, W, output_channels]."""

    compute_dtype = torch.float32

    def __init__(self, arch: str = "resnet18", in_channels: int = 34, output_channels: int = 4):
        super().__init__(arch, in_channels)
        block = ARCHS[arch][0]
        stage_ch = [64 * 2**s * block.expansion for s in range(4)]  # layer1..layer4
        d = stage_ch[-1]
        for i, skip_ch in enumerate(reversed(stage_ch[:-1])):
            setattr(self, f"up{i}", _UpBlock(d + skip_ch, skip_ch))
            d = skip_ch
        for i, f in enumerate(FINAL_WIDTHS):
            setattr(self, f"up_final{i}", _UpBlock(d, f))
            d = f
        self.head = nn.Conv2d(d, output_channels, 1)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        H, W = image.shape[1:3]
        dev = image.device.type
        with autocast(self.compute_dtype, dev):
            skips = super().forward(image.permute(0, 3, 1, 2), train)
            x = skips[-1]
            for i, skip in enumerate(reversed(skips[:-1])):
                x = getattr(self, f"up{i}")(x, skip, train)
            for i in range(len(FINAL_WIDTHS)):
                x = getattr(self, f"up_final{i}")(x, None, train)
        x = x[:, :, :H, :W]
        with no_autocast(dev):
            out = self.head(x.to(torch.promote_types(x.dtype, torch.float32)))
        return out.permute(0, 2, 3, 1)
