"""Single-latent trajectory CVAE, the classic zoo baseline (port of
`cld_tpu/models/cvae.py`): a learned posterior q(z | trajectory, context)
over one latent per trajectory, a standard-normal prior, and an MLP action
decoder integrated through the unicycle.

The reparametrization noise is explicit: `noise` [B, latent_dim], zeros
(z = mean) when not given, as the JAX module without a "sample" RNG.

At `compute_dtype` bf16 (`ops.precision`) the context encoder, posterior and
decoder MLPs run under bf16 autocast over float32 parameters; the
reparametrization, the unicycle integration and the losses run outside it
on what they give (the KL term in bf16 from bf16 statistics, the
reconstruction in float32), as in the JAX module.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast


class TrajectoryCVAE(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, horizon: int = 52, latent_dim: int = 16,
                 cond_feat_dim: int = 256, map_arch: str = "resnet18",
                 dyn: UnicycleParams = RECORD_DYNAMICS, dt: float = 0.1):
        super().__init__()
        self.horizon, self.latent_dim, self.dyn, self.dt = horizon, latent_dim, dyn, dt
        self.context_encoder = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                              map_arch=map_arch)
        self.posterior = MLP(horizon * 6 + cond_feat_dim, 2 * latent_dim, (256, 256),
                             normalization=True)
        self.decoder = MLP(latent_dim + cond_feat_dim, horizon * 2, (256, 256),
                           normalization=True)

    def _decode(self, z, cond_feat, curr_states):
        with autocast(self.compute_dtype, z.device.type):
            actions_scaled = self.decoder(torch.cat([z, cond_feat], dim=-1)).reshape(
                -1, self.horizon, 2)
        actions = TrajNormalizer().descale(actions_scaled, [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr_states, actions, self.dt)
        return torch.cat([states, actions], dim=-1)

    def forward(self, batch: TrafficBatch, beta: float = 0.1, train: bool = False,
                noise: Optional[torch.Tensor] = None) -> Dict:
        gt = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        flat = TrajNormalizer().scale(gt).reshape(gt.shape[0], -1)
        with autocast(self.compute_dtype, batch.image.device.type):
            aux = self.context_encoder(batch, train)
            stats = self.posterior(torch.cat([flat, aux["cond_feat"]], dim=-1))
        mu, logvar = stats.chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar)
        z = mu if noise is None else mu + noise * std
        traj = self._decode(z, aux["cond_feat"], aux["curr_states"])
        avail = batch.target_availabilities[..., None]
        recon = torch.mean(avail * (traj[..., :2] - gt[..., :2]) ** 2)
        kld = -0.5 * torch.mean(torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=-1))
        return {"loss": recon + beta * kld, "recon": recon, "kld": kld,
                "trajectories": traj, "aux_info": aux}

    def sample(self, batch: TrafficBatch, num_samp: int = 1, train: bool = False,
               z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prior samples -> trajectories [B, N, T, 6]. `z` [B * N,
        latent_dim] (sample-minor) is drawn from `generator` if not given."""
        with autocast(self.compute_dtype, batch.image.device.type):
            aux = self.context_encoder(batch, train)
        B = aux["cond_feat"].shape[0]
        if z is None:
            z = torch.randn((B * num_samp, self.latent_dim), generator=generator,
                            device=aux["cond_feat"].device)
        cond = torch.repeat_interleave(aux["cond_feat"], num_samp, dim=0)
        curr = torch.repeat_interleave(aux["curr_states"], num_samp, dim=0)
        return self._decode(z, cond, curr).reshape(B, num_samp, self.horizon, 6)
