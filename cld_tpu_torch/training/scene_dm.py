"""Scene-centric diffusion trainer, the CTG++ family (port of
`cld_tpu/training/scene_dm.py`): joint diffusion of every agent's raw
state+action trajectory in a scene, conditioned per agent on its encoded
vector history and its scene-frame pose, denoised by the factorized
time / agent transformer. Adam with the DM stage's coupled L2 and its
warmup + cosine rate by epoch; a step that gives a non-finite loss is
skipped. The denoiser computes at `train.training.precision`
(`state.resolve_compute_dtype`: bf16 under "auto" on the card, float32 on
the CPU), with its `time_pos_emb` stored in that dtype as the JAX module
stores it; the conditioning encoder, every other parameter, the Adam moments
of float32 parameters, the loss and the sampler stay float32, as in the JAX
package.

Submodules carry the flax names (`cond_encoder.hist_encoder`,
`cond_encoder.pose_proj`, `denoiser`) for `utils.weights.load_flax`. The
history length and the horizon are construction arguments (the JAX module
reads them off its first batch).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from cld_tpu_torch.algos.scene_dm import (
    draw_scene_loss_noise,
    draw_scene_sample_noise,
    scene_dm_loss,
    scene_sample,
)
from cld_tpu_torch.data.scene_batch import SceneBatch
from cld_tpu_torch.models.history_encoders import AgentHistoryEncoder
from cld_tpu_torch.models.scene_transformer import SceneTransformerDenoiser
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.ops.dynamics import convert_state_to_state_and_action
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import (
    TrainState,
    make_optimizer,
    resolve_compute_dtype,
    warmup_cosine_by_epoch,
)


class SceneCondEncoder(nn.Module):
    """Per-agent conditioning: the encoded local history of `hist_steps`
    steps plus a projection of the scene-frame pose (x, y, cos, sin)."""

    def __init__(self, hist_steps: int, cond_dim: int = 64):
        super().__init__()
        self.hist_encoder = AgentHistoryEncoder(hist_steps, cond_dim)
        self.pose_proj = nn.Linear(4, cond_dim)

    def forward(self, batch: SceneBatch) -> torch.Tensor:
        B, A, Th, _ = batch.hist_positions.shape
        hist = self.hist_encoder(
            batch.hist_positions.reshape(B * A, Th, 2), batch.hist_yaws.reshape(B * A, Th, 1),
            batch.hist_speeds.reshape(B * A, Th), batch.extent.reshape(B * A, 3),
            batch.hist_avail.reshape(B * A, Th)).reshape(B, A, -1)
        pose = torch.cat([batch.agent_pos_scene, torch.cos(batch.agent_yaw_scene)[..., None],
                          torch.sin(batch.agent_yaw_scene)[..., None]], dim=-1)
        return hist + self.pose_proj(pose)


class SceneDMModel(nn.Module):
    """The conditioning encoder and the scene transformer denoiser."""

    def __init__(self, hist_steps: int, horizon: int, transition_dim: int = 6,
                 cond_dim: int = 64, width: int = 128, num_layers: int = 4):
        super().__init__()
        self.cond_encoder = SceneCondEncoder(hist_steps, cond_dim)
        self.denoiser = SceneTransformerDenoiser(horizon, cond_dim, transition_dim,
                                                 transition_dim, width, num_layers)

    def encode_cond(self, batch: SceneBatch) -> torch.Tensor:
        return self.cond_encoder(batch)

    def denoise(self, x, cond, t, agent_mask) -> torch.Tensor:
        return self.denoiser(x, cond, t, agent_mask)

    def forward(self, batch: SceneBatch, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.denoise(x, self.encode_cond(batch), t, batch.agent_mask)


def scene_gt_trajectories(batch: SceneBatch, dt: float = 0.1) -> torch.Tensor:
    """Ground-truth [B, A, T, 6] state+action, scaled, by per-agent inverse
    dynamics."""
    traj_state = torch.cat([batch.fut_positions, batch.fut_yaws], dim=-1)
    return TrajNormalizer().scale(convert_state_to_state_and_action(traj_state, batch.curr_speed,
                                                                    dt))


class SceneDMTrainer:
    def __init__(self, config, device="cuda"):
        algo = config.algo
        tr = config.train.training
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(tr.get("precision", "auto"), self.device)
        self.dt = algo.step_time
        self.schedule = make_schedule(algo.n_diffusion_steps, device=self.device)
        opt = algo.optim_params.dm
        self.lr_schedule = warmup_cosine_by_epoch(
            opt.learning_rate.initial, tr.epochs, tr.get("steps_per_epoch", tr.num_steps))
        self.weight_decay = opt.regularization.L2

    def build(self) -> SceneDMModel:
        """The model at the config's widths, its denoiser at the trainer's
        compute dtype."""
        algo = self.config.algo
        model = SceneDMModel(algo.history_num_frames + 1, algo.future_num_frames,
                             cond_dim=algo.get("scene_cond_dim", 64),
                             width=algo.get("scene_width", 128),
                             num_layers=algo.get("scene_layers", 4))
        set_compute_dtype(model.denoiser, self.compute_dtype)
        return model

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh model (torch's default initializers under `seed`) with its
        optimizer at step 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = self.build().to(self.device)
        return TrainState(model, make_optimizer(model.parameters(), self.weight_decay),
                          self.lr_schedule)

    def train_step(self, state: TrainState, batch: SceneBatch,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, object]]:
        """One update in place. `noise` is (t [B], noise [B, A, T, 6]),
        drawn from `generator` when not given. A non-finite loss skips the
        update (parameters, moments and the step stay; one scalar read on
        the host); `skipped_nonfinite` is then 1."""
        x0 = scene_gt_trajectories(batch, self.dt)
        if noise is None:
            noise = draw_scene_loss_noise(self.schedule.n_timesteps, x0.shape, generator,
                                          self.device)
        t, eps = noise
        model = state.model
        cond = model.encode_cond(batch)
        loss = scene_dm_loss(model.denoise, self.schedule, x0, cond, batch.agent_mask, t, eps)
        loss.backward()
        ok = state.loss_is_finite(loss)
        if ok:
            state.apply_gradients()
        else:
            state.optimizer.zero_grad(set_to_none=True)
        return state, {"loss": loss.detach(), "skipped_nonfinite": float(not ok)}

    @torch.no_grad()
    def sample(self, state: TrainState, batch: SceneBatch,
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               guidance_fn: Optional[Callable] = None) -> torch.Tensor:
        """Joint scene sampling -> descaled [B, A, T, 6] trajectories.
        `noise` is (x_init [B, A, T, 6], step_noises [n, B, A, T, 6]), drawn
        from `generator` when not given. Runs without autograd: a
        `guidance_fn` that takes gradients enables them itself."""
        model = state.model
        cond = model.encode_cond(batch)
        B, A, T = batch.fut_positions.shape[:3]
        if noise is None:
            noise = draw_scene_sample_noise(self.schedule.n_timesteps, (B, A, T, 6), generator,
                                            self.device)
        out = scene_sample(model.denoise, self.schedule, cond, batch.agent_mask, *noise,
                           guidance_fn=guidance_fn)
        return TrajNormalizer().descale(out["pred_traj"])
