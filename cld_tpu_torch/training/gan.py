"""Trajectory-GAN trainer: alternating LSGAN updates (port of
`cld_tpu/training/gan.py`).

One step is a discriminator update, then a generator update, each with its
own Adam (the VAE stage's initial rate, constant, no weight decay). The
discriminator's side is the `discriminator` MLP; the generator's side is
everything else, the context encoder included. Per step:

1. the discriminator update, the generator's side frozen, on its own noise
   draw; the BatchNorm statistics that this forward moves are put back;
2. the generator update through the updated discriminator, which is frozen,
   on another draw, from the statistics before the step; it keeps the ones
   it moves.

Under data parallelism (`state.mesh`) each side's gradients are averaged
over the ranks before its update.

The networks compute at `train.training.precision`
(`state.resolve_compute_dtype`: bf16 under "auto" on the card, float32 on
the CPU) over float32 parameters and Adam moments; the losses are float32.
No non-finite guard, as in the JAX trainer. Randomness is explicit: the two
draws are arguments (float32; the JAX module draws them in its compute
dtype, and the first layer rounds them to it), else taken from a
`torch.Generator`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.gan import TrajectoryGAN
from cld_tpu_torch.parallel.mesh import average_gradients
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import make_optimizer, resolve_compute_dtype
from cld_tpu_torch.training.vae import raster_channels


@dataclasses.dataclass
class GANTrainState:
    """The GAN, one optimizer per side, the count of steps taken, and the
    data-parallel mesh of a run over several ranks (None: one process)."""

    model: TrajectoryGAN
    g_optimizer: torch.optim.Optimizer
    d_optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Optional[object] = None


def split_params(model: TrajectoryGAN) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """(generator side, discriminator side): the discriminator's parameters,
    and all the others."""
    d_ids = {id(p) for p in model.discriminator.parameters()}
    g = [p for p in model.parameters() if id(p) not in d_ids]
    return g, list(model.discriminator.parameters())


@contextlib.contextmanager
def _frozen(params):
    """The parameters take no gradient inside the block."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def draw_gan_noise(batch_size: int, noise_dim: int, generator: Optional[torch.Generator] = None,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's two noise draws (discriminator, generator), each
    [batch_size, noise_dim] standard normal."""
    return tuple(torch.randn((batch_size, noise_dim), generator=generator, device=device)
                 for _ in range(2))


class GANTrainer:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(
            config.train.training.get("precision", "auto"), self.device)
        self.lr = config.algo.optim_params.vae.learning_rate.initial

    def build(self) -> TrajectoryGAN:
        algo = self.config.algo
        return set_compute_dtype(
            TrajectoryGAN(raster_channels(self.config), horizon=algo.horizon,
                          cond_feat_dim=algo.cond_feat_dim,
                          map_arch=algo.map_encoder_model_arch,
                          generator_arch=algo.get("gan_generator_arch", "mlp")),
            self.compute_dtype)

    def init_state(self, seed: int = 0) -> GANTrainState:
        """A fresh GAN (torch's default initializers under `seed`) with both
        optimizers at step 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = self.build().to(self.device)
        g, d = split_params(model)
        opt = lambda params: make_optimizer(params, 0.0)
        state = GANTrainState(model, opt(g), opt(d))
        for o in (state.g_optimizer, state.d_optimizer):
            for group in o.param_groups:
                group["lr"] = self.lr
        return state

    def train_step(self, state: GANTrainState, batch: TrafficBatch,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One discriminator and one generator update in place. `noise` is
        (z_d, z_g), each [B, noise_dim], drawn from `generator` when not
        given."""
        model = state.model
        if noise is None:
            noise = draw_gan_noise(batch.batch_size, model.noise_dim, generator, self.device)
        z_d, z_g = noise
        g_params, d_params = split_params(model)
        buffers = [b.clone() for b in model.buffers()]

        with _frozen(g_params):
            d_out = model(batch, z_d, train=True)
        d_out["d_loss"].backward()
        average_gradients(d_params, state.mesh)
        state.d_optimizer.step()
        state.d_optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():  # the discriminator pass's statistics are dropped
            for b, old in zip(model.buffers(), buffers):
                b.copy_(old)

        with _frozen(d_params):
            g_out = model(batch, z_g, train=True)
        g_out["g_loss"].backward()
        average_gradients(g_params, state.mesh)
        state.g_optimizer.step()
        state.g_optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"d_loss": d_out["d_loss"].detach(), "g_loss": g_out["g_loss"].detach(),
                       "d_real_mean": d_out["d_real_mean"].detach(),
                       "d_fake_mean": d_out["d_fake_mean"].detach()}
