"""Discrete-latent trajectory CVAE (port of `cld_tpu/models/discrete_cvae.py`):
a categorical latent over K behavior modes with a Gumbel-softmax relaxation
in training, a learned conditional prior p(z | context), and per-mode
decoding.

The Gumbel noise is explicit: `uniform` [B, K], uniforms in [1e-9, 1) (the
JAX module's draw), turned into -log(-log(u)). Without it, or with
`train=False`, z is the posterior's argmax one-hot.

At `compute_dtype` bf16 (`ops.precision`) the context encoder and the three
MLPs run under bf16 autocast over float32 parameters; the Gumbel relaxation,
the unicycle integration and the losses run outside it on their bf16
logits and actions, as in the JAX module.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast

GUMBEL_UNIFORM_LOW = 1e-9


class DiscreteTrajectoryCVAE(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, horizon: int = 52, num_modes: int = 8,
                 cond_feat_dim: int = 256, map_arch: str = "resnet18",
                 temperature: float = 1.0, dyn: UnicycleParams = RECORD_DYNAMICS,
                 dt: float = 0.1):
        super().__init__()
        self.horizon, self.num_modes, self.temperature = horizon, num_modes, temperature
        self.dyn, self.dt = dyn, dt
        self.context_encoder = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                              map_arch=map_arch)
        self.posterior = MLP(horizon * 6 + cond_feat_dim, num_modes, (256,), normalization=True)
        self.prior = MLP(cond_feat_dim, num_modes, (128,), normalization=True)
        self.decoder = MLP(num_modes + cond_feat_dim, horizon * 2, (256, 256),
                           normalization=True)

    def _decode(self, z_onehot, cond_feat, curr_states):
        with autocast(self.compute_dtype, z_onehot.device.type):
            actions_scaled = self.decoder(torch.cat([z_onehot, cond_feat], dim=-1)).reshape(
                -1, self.horizon, 2)
        actions = TrajNormalizer().descale(actions_scaled, [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr_states, actions, self.dt)
        return torch.cat([states, actions], dim=-1)

    def forward(self, batch: TrafficBatch, beta: float = 1.0, train: bool = False,
                uniform: Optional[torch.Tensor] = None) -> Dict:
        gt = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        flat = TrajNormalizer().scale(gt).reshape(gt.shape[0], -1)
        with autocast(self.compute_dtype, batch.image.device.type):
            aux = self.context_encoder(batch, train)
            q_logits = self.posterior(torch.cat([flat, aux["cond_feat"]], dim=-1))
            p_logits = self.prior(aux["cond_feat"])
        if train and uniform is not None:
            g = -torch.log(-torch.log(uniform))
            z = torch.softmax((q_logits + g) / self.temperature, dim=-1)
        else:
            z = F.one_hot(torch.argmax(q_logits, dim=-1), self.num_modes).to(q_logits.dtype)
        traj = self._decode(z, aux["cond_feat"], aux["curr_states"])
        avail = batch.target_availabilities[..., None]
        recon = torch.mean(avail * (traj[..., :2] - gt[..., :2]) ** 2)
        q = torch.softmax(q_logits, dim=-1)
        kld = torch.mean(torch.sum(
            q * (torch.log_softmax(q_logits, -1) - torch.log_softmax(p_logits, -1)), dim=-1))
        return {"loss": recon + beta * kld, "recon": recon, "kld": kld,
                "trajectories": traj, "q_logits": q_logits, "p_logits": p_logits}

    def sample_modes(self, batch: TrafficBatch, train: bool = False) -> torch.Tensor:
        """Decode every mode -> [B, K, T, 6] multimodal futures."""
        with autocast(self.compute_dtype, batch.image.device.type):
            aux = self.context_encoder(batch, train)
        B, K = aux["cond_feat"].shape[0], self.num_modes
        z = torch.eye(K, device=aux["cond_feat"].device).repeat(B, 1)  # [B*K, K]
        cond = torch.repeat_interleave(aux["cond_feat"], K, dim=0)
        curr = torch.repeat_interleave(aux["curr_states"], K, dim=0)
        return self._decode(z, cond, curr).reshape(B, K, self.horizon, 6)
