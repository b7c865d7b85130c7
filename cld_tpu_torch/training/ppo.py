"""PPO fine-tuning of the denoiser on safety rewards (port of
`cld_tpu/training/ppo.py`).

* Collection runs the full reverse diffusion, decodes through the frozen VAE
  decoder (the fused LSTM core) and the unicycle, and scores off-road /
  collision / jerk rewards; the off-road count is the `offroad_count` kernel.
* The replay buffer is a fixed-capacity ring of device tensors; its write
  position and fill are Python ints, so nothing is read back from the device
  to use it.
* The update phase is `ppo_epochs * ppo_update_times` clipped-surrogate steps
  in a Python loop, each on a minibatch drawn uniformly with replacement
  below the buffer's fill. Log-prob is taken at t = 0, where sigma is clipped
  to 1e-10, as in the JAX package and its reference.
* The networks compute at the DM trainer's dtype (bf16 under "auto" on the
  card); the buffer, the log-probabilities, the ratio and the loss are
  float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from cld_tpu_torch.algos.dm import transition_log_prob
from cld_tpu_torch.algos.reward import compute_reward, failure_rate
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.vae import (
    convert_action_to_state_and_action,
    decode_actions,
    get_state_and_action_from_batch,
)
from cld_tpu_torch.ops.dynamics import UnicycleParams
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.parallel.mesh import broadcast_from_main, gather_rows, max_over_ranks
from cld_tpu_torch.training.dm import DMTrainer
from cld_tpu_torch.training.state import TrainState


@dataclasses.dataclass
class ReplayBuffer:
    """Ring buffer of PPO transitions, resident in device memory."""

    x0: torch.Tensor  # [C, T, D]
    x1: torch.Tensor  # [C, T, D]
    log_p: torch.Tensor  # [C]
    reward: torch.Tensor  # [C]
    cond_feat: torch.Tensor  # [C, F]
    baseline: torch.Tensor  # scalar f32: EMA reward baseline
    ptr: int = 0  # next write slot
    size: int = 0  # filled slots
    initialized: bool = False

    @property
    def capacity(self) -> int:
        return self.x0.shape[0]


def buffer_init(capacity: int, horizon: int, latent: int, cond_dim: int,
                device="cuda") -> ReplayBuffer:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return ReplayBuffer(x0=z(capacity, horizon, latent), x1=z(capacity, horizon, latent),
                        log_p=z(capacity), reward=z(capacity), cond_feat=z(capacity, cond_dim),
                        baseline=z())


@torch.no_grad()
def buffer_add(buf: ReplayBuffer, x0, x1, log_p, reward, cond_feat,
               alpha: float = 0.9) -> ReplayBuffer:
    """Batch insert at the write position (wrapping) + EMA baseline update,
    in place; returns `buf`. The first insert sets the baseline to the batch's
    mean reward."""
    n = x0.shape[0]
    if n > buf.capacity:
        # a wrapped batch would write some slots twice, in no defined order
        raise ValueError(
            f"batch of {n} transitions exceeds buffer capacity {buf.capacity}; "
            "raise algo.buffer_max or shrink batch*num_samp"
        )
    idx = (buf.ptr + torch.arange(n, device=buf.x0.device)) % buf.capacity
    for dst, src in ((buf.x0, x0), (buf.x1, x1), (buf.log_p, log_p), (buf.reward, reward),
                     (buf.cond_feat, cond_feat)):
        dst.index_copy_(0, idx, src.to(dst.dtype))
    mean_r = reward.mean()
    buf.baseline = alpha * buf.baseline + (1 - alpha) * mean_r if buf.initialized else mean_r
    buf.ptr = (buf.ptr + n) % buf.capacity
    buf.size = min(buf.size + n, buf.capacity)
    buf.initialized = True
    return buf


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """minimum(maximum(x, lo), hi): at an exact tie with a bound the gradient
    splits evenly, as `jnp.clip`'s does (`torch.clamp` would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def surrogate_loss(logp_new, logp_old, adv, clip_eps: float):
    """Clipped surrogate -> (loss, stats): the mean / max importance ratio,
    the share of samples past the clip bound, and mean logp_old - logp_new."""
    diff = logp_new - logp_old
    ratio = torch.exp(diff)
    surr1 = ratio * adv
    surr2 = _clip(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    loss = -torch.mean(torch.minimum(surr1, surr2))
    stats = {
        "ratio_mean": ratio.mean(),
        "ratio_max": ratio.max(),
        "clip_fraction": torch.mean((torch.abs(ratio - 1.0) > clip_eps).to(torch.float32)),
        "approx_kl": -diff.mean(),
    }
    return loss, stats


class PPOTrainer:
    """Drives collection + clipped-surrogate updates on top of a DMTrainer."""

    def __init__(self, config, dm_trainer: DMTrainer):
        self.config = config
        self.dm = dm_trainer
        algo = config.algo
        self.num_samp = algo.num_samp
        self.mini_batch = algo.ppo_mini_batch
        self.update_times = algo.ppo_update_times
        self.ppo_epochs = algo.get("ppo_epochs", 10)
        self.clip_eps = algo.get("ppo_clip_eps", 0.2)
        self.dyn_params = UnicycleParams.from_config(algo.dynamics)
        self.normalizer = TrajNormalizer()
        self.dt = algo.step_time
        # (descaled [B, N, T, 6], batch, scaled) -> flat reward [B * N]
        self.reward_fn: Callable = compute_reward

    # -- experience collection -------------------------------------------
    @torch.no_grad()
    def decode_samples(self, x0: torch.Tensor, aux_info, batch_size: int,
                       num_samp: Optional[int] = None):
        """Latents [B * N, T, D] -> (descaled, scaled) [B, N, T, 6]
        trajectories, through the fused LSTM decoder core. `aux_info` holds
        cond_feat and curr_states already repeated to B * N rows; `num_samp`
        defaults to the config's collection count."""
        if num_samp is None:
            num_samp = self.num_samp
        actions = decode_actions(self.dm.vae.lstmvae.lstm_dec, x0, aux_info["cond_feat"])
        descaled = convert_action_to_state_and_action(
            actions, aux_info["curr_states"], self.dyn_params, self.normalizer,
            self.dt, scaled_input=True, descaled_output=True,
        )
        descaled = descaled.reshape(batch_size, num_samp, *descaled.shape[1:])
        return descaled, self.normalizer.scale(descaled)

    @torch.no_grad()
    def collect_step(self, dm_state: TrainState, buf: ReplayBuffer, batch: TrafficBatch,
                     x_init: Optional[torch.Tensor] = None,
                     step_noises: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     ) -> Tuple[ReplayBuffer, Dict[str, torch.Tensor]]:
        """Sample `num_samp` latents per agent, decode, score, and add the
        (x0, x1, log-prob, reward, cond) transitions to `buf` in place. The
        sampler's noise is explicit or drawn from `generator`. Also returns
        the decoded trajectories `traj` [B, N, T, 6]. Under data parallelism
        (`dm_state.mesh`) a rank collects its rows and `buf` is the global
        buffer, the same on every rank: every rank's transitions go into it
        in the order of the global batch, and its baseline follows the
        global batch's mean reward; `reward` is the rank's rows' mean."""
        B = batch.batch_size
        out = self.dm.sample(dm_state, batch, num_samp=self.num_samp, x_init=x_init,
                             step_noises=step_noises, generator=generator)
        curr = out["aux_info"]["curr_states"]
        aux_rep = {
            "cond_feat": out["cond_feat"],
            "curr_states": curr.repeat_interleave(self.num_samp, dim=0)
            if self.num_samp > 1 else curr,
        }
        descaled, scaled = self.decode_samples(out["pred_traj"], aux_rep, B)
        reward = self.reward_fn(descaled, batch, scaled, dt=self.dt)
        rows = lambda x: gather_rows(x, dm_state.mesh)
        buf = buffer_add(buf, rows(out["pred_traj"]), rows(out["x1"]),
                         rows(out["log_prob_final"]), rows(reward), rows(out["cond_feat"]))
        return buf, {"reward": reward.mean(), "traj": descaled}

    # -- clipped-surrogate updates ---------------------------------------
    def ppo_update(self, dm_state: TrainState, buf: ReplayBuffer,
                   indices: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update phase in place, iteration k on the minibatch
        `indices[k]` ([n_iters, mini_batch] int64). When None, `ppo_epochs *
        ppo_update_times` minibatches are drawn from `generator`, uniformly
        with replacement below the buffer's fill.
        Returns (state, metrics): the mean surrogate `loss`, `ratio_mean`,
        `clip_fraction`, `approx_kl` over the phase and the phase's
        `ratio_max`. An empty buffer raises: its all-zero transitions at
        t = 0 (sigma clipped to 1e-10) would give astronomically scaled
        gradients.

        Under data parallelism (`dm_state.mesh`, a global buffer from
        `collect_step`) the minibatches are the global ones, rank 0's draw,
        and a rank takes its equal share of each minibatch's columns; the
        gradients are averaged over the ranks, so an iteration is the global
        minibatch's. `ratio_max` is the largest over the ranks; the other
        metrics are the rank's means, which the ranks' average makes the
        global ones."""
        if buf.size == 0:
            raise ValueError("ppo_update on an empty replay buffer — run collect_step first")
        dev = buf.x0.device
        mesh = dm_state.mesh
        if indices is None:
            indices = torch.randint(0, buf.size,
                                    (self.ppo_epochs * self.update_times, self.mini_batch),
                                    generator=generator, device=dev)
            indices = broadcast_from_main(indices, mesh)
        indices = indices.to(dev)
        if mesh is not None and mesh.active:
            m = indices.shape[1]
            if m % mesh.world_size:
                raise ValueError(f"a minibatch of {m} does not divide over {mesh.world_size} ranks")
            share = m // mesh.world_size
            indices = indices[:, mesh.rank * share:(mesh.rank + 1) * share]
        unet = dm_state.model
        t = torch.zeros((indices.shape[1],), dtype=torch.long, device=dev)
        seq = []
        for idx in indices:
            adv = buf.reward[idx] - buf.baseline
            logp_new = transition_log_prob(unet, self.dm.schedule, buf.x1[idx], buf.x0[idx],
                                           buf.cond_feat[idx], t)
            loss, stats = surrogate_loss(logp_new, buf.log_p[idx], adv, self.clip_eps)
            loss.backward()
            dm_state.apply_gradients()
            seq.append({"loss": loss.detach(), **{k: v.detach() for k, v in stats.items()}})
        metrics = {k: torch.stack([s[k] for s in seq]).mean() for k in seq[0]}
        metrics["ratio_max"] = max_over_ranks(torch.stack([s["ratio_max"] for s in seq]).max(),
                                              mesh)
        return dm_state, metrics

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def test_step(self, dm_state: TrainState, batch: TrafficBatch,
                  x_init: Optional[torch.Tensor] = None,
                  step_noises: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        """Failure rates + realism statistics for one batch, from one sampled
        trajectory per agent."""
        B = batch.batch_size
        out = self.dm.sample(dm_state, batch, num_samp=1, x_init=x_init,
                             step_noises=step_noises, generator=generator)
        aux_rep = {"cond_feat": out["cond_feat"],
                   "curr_states": out["aux_info"]["curr_states"]}
        descaled, scaled = self.decode_samples(out["pred_traj"], aux_rep, B, num_samp=1)
        scaled_flat = scaled[:, 0]
        rates = failure_rate(descaled[:, 0], batch)
        gt = get_state_and_action_from_batch(batch, self.dm.algo.horizon, self.dt)
        gt_scaled = self.normalizer.scale(gt)
        stats = {
            "long_acc_gt": gt_scaled[..., 4],
            "long_acc_pred": scaled_flat[..., 4],
            "lat_acc_gt": gt_scaled[..., 2] * gt_scaled[..., 5],
            "lat_acc_pred": scaled_flat[..., 2] * scaled_flat[..., 5],
            # per-agent jerk: finite difference along T
            "jerk_gt": torch.diff(gt_scaled[..., 4], dim=-1) / self.dt,
            "jerk_pred": torch.diff(scaled_flat[..., 4], dim=-1) / self.dt,
        }
        return rates, stats
