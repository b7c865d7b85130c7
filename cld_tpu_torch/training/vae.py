"""VAE stage trainer (port of `cld_tpu/training/vae.py`): Adam(1e-4, L2 1e-5),
10-epoch warmup + cosine rate (epoch-granular), beta annealed 0.05 -> 0.3 over
9000 steps. A step is context encoding in train mode (BatchNorm on batch
statistics), the VAE forward with dropout and reparametrization noise, the
loss, backward and one optimizer update. The networks compute at
`train.training.precision` (`state.resolve_compute_dtype`: bf16 under "auto"
on the card, float32 on the CPU); parameters, optimizer state and the loss
stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.context import parse_map_arch
from cld_tpu_torch.models.resnet import check_arch
from cld_tpu_torch.models.vae import VaeModel
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import (
    BetaSchedule,
    TrainState,
    make_optimizer,
    resolve_compute_dtype,
    warmup_cosine_by_epoch,
)


def raster_channels(config) -> int:
    """Channels of the raster stack: one history layer per frame (the current
    one included) plus the semantic layers."""
    return config.algo.history_num_frames + 1 + config.env.rasterizer.num_sem_layers


def build_vae_model(config, device, compute_dtype: torch.dtype = torch.float32) -> VaeModel:
    algo = config.algo
    model = VaeModel(
        raster_channels=raster_channels(config),
        curr_state_feat_dim=algo.curr_state_feat_dim,
        map_feature_dim=algo.map_feature_dim,
        cond_feat_dim=algo.cond_feat_dim,
        vae_hidden_size=algo.vae.hidden_size,
        vae_latent_size=algo.vae.latent_size,
        horizon=algo.horizon,
        dt=algo.step_time,
        map_arch=algo.map_encoder_model_arch,
    ).to(device)
    return set_compute_dtype(model, compute_dtype)


class VAETrainer:
    def __init__(self, config, device="cuda"):
        algo = config.algo
        tr = config.train.training
        check_arch(parse_map_arch(algo.map_encoder_model_arch)[0])
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(tr.get("precision", "auto"), self.device)
        opt_cfg = algo.optim_params.vae
        self.lr_schedule = warmup_cosine_by_epoch(
            base_lr=opt_cfg.learning_rate.initial,
            total_epochs=tr.epochs,
            steps_per_epoch=tr.get("steps_per_epoch", tr.num_steps),
        )
        self.weight_decay = opt_cfg.regularization.L2
        self.beta_schedule = BetaSchedule()

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh model (torch's default initializers under `seed`) with its
        optimizer at step 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_vae_model(self.config, self.device, self.compute_dtype)
        return TrainState(model, make_optimizer(model.parameters(), self.weight_decay),
                          self.lr_schedule)

    def train_step(
        self,
        state: TrainState,
        batch: TrafficBatch,
        noise: Optional[torch.Tensor] = None,
        keep_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, object]]:
        """One update in place. `noise` [B, T, L] and `keep_masks` (encoder,
        decoder; each [B, T, H]) are the step's randomness; what is not given
        is drawn from `generator` (the default generator when None).

        A non-finite loss skips the update: parameters, optimizer moments,
        BatchNorm statistics and the step count stay as they were, and
        `skipped_nonfinite` is 1. Deciding that reads one scalar on the host
        per step."""
        model = state.model
        beta = self.beta_schedule(state.step)
        lr = self.lr_schedule(state.step)
        if noise is None:
            L = self.config.algo.vae.latent_size
            noise = torch.randn((batch.batch_size, self.config.algo.horizon, L),
                                generator=generator, device=self.device)
        buffers = [b.clone() for b in model.buffers()]
        out = model(batch, beta, train=True, noise=noise, keep_masks=keep_masks,
                    generator=generator)
        out["loss"].backward()
        ok = state.loss_is_finite(out["loss"])
        if ok:
            state.apply_gradients()
        else:
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, old in zip(model.buffers(), buffers):
                    b.copy_(old)
        metrics = {
            "skipped_nonfinite": float(not ok),
            "loss": out["loss"].detach(),
            "recon": out["recon"].detach(),
            "kld": out["kld"].detach(),
            "beta": beta,
            "lr": lr,
        }
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: TrafficBatch) -> Dict[str, torch.Tensor]:
        """Deterministic losses (z = mean, no dropout, running BatchNorm
        statistics); the decoder runs through the fused LSTM core."""
        out = state.model(batch, self.beta_schedule(state.step), train=False)
        return {"loss": out["loss"], "recon": out["recon"], "kld": out["kld"]}
