"""Spatial-softmax keypoint pooling (port of
`cld_tpu/models/spatial_softmax.py`): a per-channel softmax over the spatial
grid gives expected (x, y) keypoints in [-1, 1], the optional pooling head
of the ResNet map encoder.

It has no compute dtype of its own: it runs in the region it is called in
(the map encoder's, bf16 autocast under bf16 compute). As in the JAX module,
the keypoint conv and the softmax follow that region, while the pixel grid
is float32 and the expectation over it runs in at least float32 outside
autocast, so keypoints come out float32 from bf16 attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from cld_tpu_torch.ops.precision import no_autocast


class SpatialSoftmax(nn.Module):
    """[B, C, H, W] feature map (NCHW, the port's convolution layout; the JAX
    module takes NHWC) -> [B, K * 2] expected keypoints, (x, y) per channel.

    `num_kp` None keeps one keypoint per input channel; otherwise a 1x1
    conv (`kp_conv`) mixes the channels into `num_kp` first. The softmax
    temperature is learnable (`log_temperature`) when
    `learnable_temperature`."""

    def __init__(self, in_channels: int, num_kp: Optional[int] = None,
                 temperature: float = 1.0, learnable_temperature: bool = False):
        super().__init__()
        self.kp_conv = None
        self.num_kp = in_channels
        if num_kp is not None and num_kp != in_channels:
            self.kp_conv = nn.Conv2d(in_channels, num_kp, 1)
            self.num_kp = num_kp
        self.temperature = temperature
        self.log_temperature = (
            nn.Parameter(torch.tensor(math.log(temperature))) if learnable_temperature else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kp_conv is not None:
            x = self.kp_conv(x)
        B, C, H, W = x.shape
        feat = x.reshape(B, C, H * W)
        if self.log_temperature is not None:  # a float32 parameter promotes, as in JAX
            temperature = torch.exp(self.log_temperature)
            feat = feat.to(torch.promote_types(feat.dtype, temperature.dtype))
        else:
            temperature = self.temperature
        attn = torch.softmax(feat / temperature, dim=-1)
        wide = torch.promote_types(x.dtype, torch.float32)
        pos_x = torch.linspace(-1.0, 1.0, W, device=x.device, dtype=wide)
        pos_y = torch.linspace(-1.0, 1.0, H, device=x.device, dtype=wide)
        grid = torch.stack([pos_x[None, :].expand(H, W).reshape(-1),
                            pos_y[:, None].expand(H, W).reshape(-1)], dim=-1)  # [H*W, 2]
        with no_autocast(x.device.type):
            kp = torch.einsum("bcn,nd->bcd", attn.to(grid.dtype), grid)
        return kp.reshape(B, C * 2)
