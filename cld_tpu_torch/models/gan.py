"""Trajectory GAN baseline (port of `cld_tpu/models/gan.py`): a
context-conditioned generator (noise -> scaled actions -> unicycle
trajectory) and an MLP discriminator over (scaled trajectory, context),
trained with the least-squares GAN objective (`training.gan`).

The generator is an MLP (the rasterized GAN of record) or, with
`generator_arch="transformer"`, a per-timestep token transformer. The noise
z [B * num_samp, noise_dim] is an argument. Submodules carry the flax names
(`context_encoder`, `generator`, `discriminator`; in the transformer
`seed`, `ln_a<i>`, `attn<i>`, `ln_m<i>`, `ff0_<i>`, `ff1_<i>`, `head`), so
`utils.weights.load_flax` loads the JAX package's variables. LayerNorm takes
flax's epsilon (1e-6) and GELU flax's tanh approximation.

At `compute_dtype` bf16 (`ops.precision`) the context encoder, the
generator and the discriminator run under bf16 autocast over float32
parameters (the transformer's sinusoidal positions are cast to the seed's
dtype, as the JAX module casts them); the unicycle integration stays outside
it, and the discriminator's logits are float32 before the LSGAN losses.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.nets import MLP, MultiHeadDotProductAttention
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast


class TransformerGenerator(nn.Module):
    """Noise + condition seed every timestep token, sinusoidal positions,
    pre-LayerNorm self-attention and GELU MLP blocks, a linear head to
    scaled actions [B, horizon * 2]."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, horizon: int, width: int = 64, layers: int = 2,
                 heads: int = 4):
        super().__init__()
        self.horizon, self.width, self.layers = horizon, width, layers
        self.seed = nn.Linear(in_features, width)
        for i in range(layers):
            setattr(self, f"ln_a{i}", nn.LayerNorm(width, eps=1e-6))
            setattr(self, f"attn{i}", MultiHeadDotProductAttention(width, heads))
            setattr(self, f"ln_m{i}", nn.LayerNorm(width, eps=1e-6))
            setattr(self, f"ff0_{i}", nn.Linear(width, width * 4))
            setattr(self, f"ff1_{i}", nn.Linear(width * 4, width))
        self.head = nn.Linear(width, 2)

    def positions(self, device) -> torch.Tensor:
        """[T, W] sin / cos positions, computed as the JAX module does."""
        half = self.width // 2
        t = torch.arange(self.horizon, dtype=torch.float32, device=device)
        k = torch.arange(half, dtype=torch.float32, device=device)
        freqs = torch.exp(-math.log(10000.0) * k / half)
        ang = t[:, None] * freqs[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def forward(self, zc: torch.Tensor) -> torch.Tensor:
        with autocast(self.compute_dtype, zc.device.type):
            seed = self.seed(zc)
            h = seed[:, None] + self.positions(zc.device).to(seed.dtype)[None]  # [B, T, W]
            for i in range(self.layers):
                a = getattr(self, f"ln_a{i}")(h)
                h = h + getattr(self, f"attn{i}")(a)
                m = getattr(self, f"ff0_{i}")(getattr(self, f"ln_m{i}")(h))
                h = h + getattr(self, f"ff1_{i}")(F.gelu(m, approximate="tanh"))
            return self.head(h).reshape(zc.shape[0], self.horizon * 2)


class TrajectoryGAN(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, horizon: int = 52, noise_dim: int = 16,
                 cond_feat_dim: int = 256, map_arch: str = "resnet18",
                 generator_arch: str = "mlp", dyn: UnicycleParams = RECORD_DYNAMICS,
                 dt: float = 0.1):
        super().__init__()
        self.horizon, self.noise_dim, self.dyn, self.dt = horizon, noise_dim, dyn, dt
        # the JAX module's ContextEncoder defaults: state features 64, map 256
        self.context_encoder = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                              map_arch=map_arch)
        if generator_arch == "transformer":
            self.generator = TransformerGenerator(noise_dim + cond_feat_dim, horizon)
        elif generator_arch == "mlp":
            self.generator = MLP(noise_dim + cond_feat_dim, horizon * 2, (256, 256),
                                 normalization=True)
        else:
            raise ValueError(f"unknown generator_arch {generator_arch!r}; known: 'mlp', "
                             "'transformer'")
        self.discriminator = MLP(horizon * 6 + cond_feat_dim, 1, (256, 256), normalization=True)

    def generate(self, batch: TrafficBatch, z: torch.Tensor, num_samp: int = 1,
                 train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Noise z [B * num_samp, noise_dim] + context -> descaled
        trajectories [B, num_samp, T, 6] and the context encoder's output."""
        with autocast(self.compute_dtype, z.device.type):
            aux = self.context_encoder(batch, train)
            B = aux["cond_feat"].shape[0]
            cond = torch.repeat_interleave(aux["cond_feat"], num_samp, dim=0)
            curr = torch.repeat_interleave(aux["curr_states"], num_samp, dim=0)
            actions_scaled = self.generator(torch.cat([z, cond], dim=-1)).reshape(
                -1, self.horizon, 2)
        actions = TrajNormalizer().descale(actions_scaled, [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr, actions, self.dt)
        traj = torch.cat([states, actions], dim=-1)
        return traj.reshape(B, num_samp, self.horizon, 6), aux

    def discriminate(self, traj_scaled: torch.Tensor, cond_feat: torch.Tensor) -> torch.Tensor:
        """[B, T, 6] scaled + [B, C] -> logits [B]."""
        flat = traj_scaled.reshape(traj_scaled.shape[0], -1)
        with autocast(self.compute_dtype, flat.device.type):
            return self.discriminator(torch.cat([flat, cond_feat], dim=-1))[:, 0]

    def forward(self, batch: TrafficBatch, z: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """The LSGAN losses of one batch, both views; z [B, noise_dim]. The
        trainer routes each loss's gradient to its side."""
        fake, aux = self.generate(batch, z, 1, train)
        fake = fake[:, 0]
        normalizer = TrajNormalizer()
        gt = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        d_real = self.discriminate(normalizer.scale(gt), aux["cond_feat"]).to(torch.float32)
        d_fake = self.discriminate(normalizer.scale(fake), aux["cond_feat"]).to(torch.float32)
        return {
            "d_loss": 0.5 * torch.mean((d_real - 1.0) ** 2) + 0.5 * torch.mean(d_fake ** 2),
            "g_loss": 0.5 * torch.mean((d_fake - 1.0) ** 2),
            "trajectories": fake,
            "d_real_mean": torch.mean(d_real),
            "d_fake_mean": torch.mean(d_fake),
        }
