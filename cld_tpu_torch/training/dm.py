"""DM stage trainer: latent diffusion on frozen-VAE latents (port of
`cld_tpu/training/dm.py`). The VAE (context encoder + LSTM-VAE) is frozen;
each step encodes the batch to a stochastic latent sequence z0 and minimizes
the epsilon-prediction MSE of the temporal UNet. Only the UNet's parameters
are in the optimizer. The VAE and the denoiser compute at
`train.training.precision` (bf16 under "auto" on the card); the diffusion
math, the loss and the parameters stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cld_tpu_torch.algos.dm import dm_loss, sample_traj, transition_log_prob
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.dm_mlp import MLPResDenoiser
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.models.vae import VaeModel
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import (
    TrainState,
    ema_update,
    make_optimizer,
    resolve_compute_dtype,
    warmup_cosine_by_epoch,
)


class DMTrainer:
    """Holds the frozen VAE and builds / updates the trainable denoiser. The
    VAE it is given is moved to `device`, frozen and set to the compute dtype
    in place."""

    def __init__(self, config, vae: VaeModel, device="cuda"):
        algo = config.algo
        tr = config.train.training
        self.arch = algo.get("diffuser_model_arch", "TemporalMapUnet")
        if self.arch not in ("TemporalMapUnet", "MLPResNetwork"):
            raise ValueError(f"unknown diffuser_model_arch {self.arch!r}")
        self.algo = algo
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(tr.get("precision", "auto"), self.device)
        self.vae = set_compute_dtype(vae.to(self.device).requires_grad_(False),
                                     self.compute_dtype)
        self.ema_decay = algo.get("ema_decay", None)
        self.schedule = make_schedule(algo.n_diffusion_steps, device=self.device)
        opt_cfg = algo.optim_params.dm
        self.lr_schedule = warmup_cosine_by_epoch(
            base_lr=opt_cfg.learning_rate.initial,
            total_epochs=tr.epochs,
            steps_per_epoch=tr.get("steps_per_epoch", tr.num_steps),
        )
        self.weight_decay = opt_cfg.regularization.L2

    # -- state ---------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh denoiser (torch's default initializers under `seed`) with
        its optimizer at step 0, and an EMA copy when `algo.ema_decay` is set.
        `algo.diffuser_model_arch` picks the temporal UNet or the residual
        MLP (`MLPResNetwork`)."""
        algo = self.algo
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if self.arch == "TemporalMapUnet":
                unet = TemporalMapUnet(algo.vae.latent_size, algo.vae.latent_size,
                                       algo.cond_feat_dim, algo.base_dim, tuple(algo.dim_mults))
            else:
                unet = MLPResDenoiser(algo.horizon, algo.vae.latent_size, algo.cond_feat_dim)
            unet = set_compute_dtype(unet.to(self.device), self.compute_dtype)
        ema = [p.detach().clone() for p in unet.parameters()] if self.ema_decay else None
        return TrainState(unet, make_optimizer(unet.parameters(), self.weight_decay),
                          self.lr_schedule, ema_params=ema)

    # -- helpers -------------------------------------------------------
    @torch.no_grad()
    def encode(self, batch: TrafficBatch, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Frozen-VAE latents + conditioning -> (z, aux_info). `noise`
        [B, T, L] is the reparametrization noise, drawn from `generator` (the
        default generator when None) if not given."""
        if noise is None:
            noise = torch.randn((batch.batch_size, self.algo.horizon, self.algo.vae.latent_size),
                                generator=generator, device=self.device)
        z, _, _, aux = self.vae.encode(batch, train=False, noise=noise)
        return z, aux

    @staticmethod
    def denoise_fn(unet):
        """The (x, cond, t) -> eps_hat function of a denoiser module (or of a
        train state's)."""
        return unet.model if isinstance(unet, TrainState) else unet

    # -- steps ----------------------------------------------------------
    def train_step(
        self,
        state: TrainState,
        batch: TrafficBatch,
        enc_noise: Optional[torch.Tensor] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, object]]:
        """One update in place. `enc_noise` is the encoder's
        reparametrization noise, `t` [B] and `noise` [B, T, L] the loss's
        timesteps and Gaussian; what is not given is drawn from `generator`.
        A non-finite loss skips the update (parameters, moments, EMA and step
        untouched) and reports `skipped_nonfinite` 1: one scalar read on the
        host per step."""
        z0, aux = self.encode(batch, enc_noise, generator)
        lr = self.lr_schedule(state.step)
        loss = dm_loss(state.model, self.schedule, z0, aux["cond_feat"], t, noise, generator)
        loss.backward()
        ok = state.loss_is_finite(loss)
        if ok:
            state.apply_gradients()
            if self.ema_decay and state.ema_params is not None:
                ema_update(state.ema_params, state.model.parameters(), self.ema_decay)
        else:
            state.optimizer.zero_grad(set_to_none=True)
        return state, {"loss": loss.detach(), "lr": lr, "skipped_nonfinite": float(not ok)}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: TrafficBatch,
                  enc_noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        z0, aux = self.encode(batch, enc_noise, generator)
        return {"loss": dm_loss(state.model, self.schedule, z0, aux["cond_feat"], t, noise,
                                generator)}

    def sample(self, state: TrainState, batch: TrafficBatch, num_samp: int = 1,
               guidance_fn=None, x_init: Optional[torch.Tensor] = None,
               step_noises: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Conditioned ancestral sampling: `algos.dm.sample_traj`'s outputs
        plus `aux_info` (cond_feat and curr_states of the unrepeated batch).
        The conditioning does not depend on the encoder's noise, so none is
        drawn."""
        with torch.no_grad():
            aux = self.vae.context_encoder(batch, train=False)
        out = sample_traj(
            state.model, self.schedule, aux["cond_feat"], self.algo.horizon,
            self.algo.vae.latent_size, num_samp=num_samp, guidance_fn=guidance_fn,
            x_init=x_init, step_noises=step_noises, generator=generator,
        )
        out["aux_info"] = aux
        return out

    def log_prob(self, unet, x_t, x_tm1, cond_feat, t):
        return transition_log_prob(self.denoise_fn(unet), self.schedule, x_t, x_tm1, cond_feat, t)
