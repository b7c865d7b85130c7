"""STRIVE-style adversarial latent optimization (port of
`cld_tpu/algos/latent_attack.py`): given a trained generative trajectory
model (the latent DM's frozen VAE decoder, or a CVAE), optimize the latent,
not the trajectory, towards a safety-critical scenario while a prior
penalty keeps it plausible. Functional Adam on z; each step's gradient is
one `torch.autograd.grad` through `decode_fn` (through the decoder's
kernel-backed LSTM core on the card: one forward and one reverse sweep).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def latent_attack(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    objective_fn: Callable[[torch.Tensor], torch.Tensor],
    z_init: torch.Tensor,
    prior_weight: float = 0.1,
    lr: float = 0.1,
    steps: int = 50,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Minimize objective(decode(z)) + prior_weight * |z|^2 / 2 over z from
    `z_init` by `steps` Adam steps. The penalty is the standard-normal
    log-prior per sample (summed over the latent dimensions, averaged over
    the batch axis); `objective_fn` maps decoded trajectories [..., T, 6] to
    a scalar cost (the collision-attack rules of `guidance.losses` compose).
    Returns (z_opt, {"objective", "prior_penalty"} at z_opt)."""

    def total(z):
        obj = objective_fn(decode_fn(z))
        prior = torch.mean(0.5 * torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=-1))
        return obj + prior_weight * prior, obj, prior

    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    z = z_init.detach()
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for i in range(steps):
        zr = z.detach().requires_grad_(True)
        with torch.enable_grad():
            g = torch.autograd.grad(total(zr)[0], zr)[0]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g ** 2
        # bias corrections in float32, as the JAX package's traced step count gives them
        m_hat = m / (1 - f32(b1) ** f32(i + 1))
        v_hat = v / (1 - f32(b2) ** f32(i + 1))
        z = z - lr * m_hat / (torch.sqrt(v_hat) + eps)
    with torch.no_grad():
        _, obj, prior = total(z)
    return z, {"objective": obj, "prior_penalty": prior}
