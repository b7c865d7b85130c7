"""The legacy training-loss library (port of `cld_tpu/ops/losses.py`):
cosine / KLD family, Gaussian-mixture likelihoods, trajectory and goal
losses, the soft collision penalty and the GAN discriminator loss. Plain
torch; the zoo's models and trainers use them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def cosine_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """1 - cos(pred, label), meaned. The denominator is floored at 1e-8."""
    num = torch.sum(preds * labels, dim=-1)
    den = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(labels, dim=-1)
    return torch.mean(1.0 - num / torch.maximum(den, den.new_tensor(1e-8)))


def kld_0_1_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) averaged over the batch."""
    kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=-1)
    return torch.mean(kld)


def kld_gaussian_loss(mu_1, logvar_1, mu_2, logvar_2) -> torch.Tensor:
    """KL(N1 || N2) for diagonal Gaussians, averaged over the batch."""
    kld = 0.5 * torch.sum(
        logvar_2 - logvar_1
        + (torch.exp(logvar_1) + (mu_1 - mu_2) ** 2) / torch.exp(logvar_2)
        - 1.0,
        dim=-1,
    )
    return torch.mean(kld)


def kld_discrete(logp: torch.Tensor, logq: torch.Tensor) -> torch.Tensor:
    """KL between categorical distributions given log probs."""
    return torch.mean(torch.sum(torch.exp(logp) * (logp - logq), dim=-1))


def log_normal(x, m, v, avails: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal-Gaussian log prob summed over the last dim; `avails` masks
    the residual, not the log-variance term, as the reference does."""
    resid = (x - m) * avails if avails is not None else (x - m)
    element = -0.5 * (torch.log(v) + resid**2 / v + math.log(2 * math.pi))
    return torch.sum(element, dim=-1)


def log_normal_mixture(x, m, v, w=None, log_w=None) -> torch.Tensor:
    """Mixture-of-Gaussians log prob: uniform weights use log-mean-exp,
    explicit weights log-sum-exp."""
    lp = log_normal(x[:, None], m, v)  # [B, M]
    if w is not None or log_w is not None:
        if w is not None:
            log_w = torch.log(w)
        return torch.logsumexp(lp + log_w, dim=1)
    return torch.logsumexp(lp, dim=1) - math.log(lp.shape[1])


def nll_gmm_loss(x, m, v, pi, avails=None, detach: bool = True, mode: str = "sum") -> torch.Tensor:
    """GMM NLL with the best-mode gradient trick: in detach mode only the
    max-likelihood mode receives gradients, the others contribute detached."""
    if v is None:
        v = torch.ones_like(m)
    av = avails[:, None] if avails is not None else None
    lp = log_normal(x[:, None], m, v, avails=av)  # [B, M]
    max_flag = lp == lp.amax(dim=1, keepdim=True)
    if mode == "sum":
        if detach:
            return (
                torch.sum(-pi * lp * max_flag, dim=1).mean()
                + torch.sum(-pi * lp.detach() * (~max_flag), dim=1).mean()
            )
        return torch.sum(-pi * lp, dim=1).mean()
    if mode == "max":
        return torch.sum(-pi * lp * max_flag, dim=1).mean()
    raise ValueError(f"unknown mode {mode!r}")


def trajectory_loss(
    predictions: torch.Tensor,  # [B, T, D]
    targets: torch.Tensor,
    availabilities: torch.Tensor,  # [B, T]
    weights_scaling: Optional[torch.Tensor] = None,  # [D]
) -> torch.Tensor:
    """Availability-masked MSE."""
    err = (predictions - targets) ** 2
    if weights_scaling is not None:
        err = err * weights_scaling
    return torch.mean(err * availabilities[..., None])


def multimodal_trajectory_loss(
    predictions: torch.Tensor,  # [B, M, T, D]
    targets: torch.Tensor,  # [B, T, D]
    availabilities: torch.Tensor,  # [B, T]
    prob: torch.Tensor,  # [B, M]
    weights_scaling: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prob-weighted min-over-modes trajectory loss: the best mode's error
    carries the regression gradient, the others contribute their detached
    error; normalized by the available-step count."""
    err = (predictions - targets[:, None]) ** 2
    if weights_scaling is not None:
        err = err * weights_scaling
    err = err * availabilities[:, None, :, None]  # [B, M, T, D]
    per_mode = torch.sum(err, dim=(2, 3))  # [B, M]
    min_flag = per_mode == torch.amin(per_mode, dim=1, keepdim=True)
    w = prob * min_flag
    w_non = prob * ~min_flag
    total = torch.sum(err * w[:, :, None, None]) + torch.sum(err.detach() * w_non[:, :, None, None])
    avail_sum = torch.sum(availabilities)
    return total / torch.maximum(avail_sum, avail_sum.new_tensor(1.0))


def goal_reaching_loss(
    predictions: torch.Tensor,  # [B, T, D]
    targets: torch.Tensor,
    availabilities: torch.Tensor,  # [B, T]
    weights_scaling: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE at each trajectory's last available step: a one-hot goal mask at
    the final valid frame through `trajectory_loss`, so the normalization is
    the mean over B*T*D. The last valid index is an argmax over the reversed
    mask (the first True); a row with none takes index T - 1 and a zero mask,
    as the JAX package's does."""
    T = availabilities.shape[1]
    rev = (torch.flip(availabilities, dims=(1,)) > 0).to(torch.int32)
    idx = T - 1 - torch.argmax(rev, dim=1)
    has_any = torch.any(availabilities > 0, dim=1)
    goal_mask = F.one_hot(idx, T).to(predictions.dtype) * has_any[:, None].to(predictions.dtype)
    return trajectory_loss(predictions, targets, goal_mask, weights_scaling)


def collision_loss(
    ego_pos: torch.Tensor,  # [B, T, 2]
    other_pos: torch.Tensor,  # [B, S, T, 2]
    ego_extent: torch.Tensor,  # [B, 2]
    other_extent: torch.Tensor,  # [B, S, 2]
    other_avail: torch.Tensor,  # [B, S, T]
) -> torch.Tensor:
    """Soft edge-collision penalty, disk approximation: the largest
    sigmoid(-4 (d - r)) over partners and steps, meaned over the batch."""
    d = torch.linalg.vector_norm(ego_pos[:, None] - other_pos, dim=-1)  # [B, S, T]
    rad = (ego_extent[:, None, 0] + other_extent[..., 0]) / 2.0
    per = torch.sigmoid(-(d - rad[..., None]) * 4.0) * other_avail
    return torch.mean(torch.amax(per, dim=(1, 2)))


def likelihood_loss(likelihood: torch.Tensor) -> torch.Tensor:
    """1 - mean(likelihood): the reference's bounded linear form."""
    return 1.0 - torch.mean(likelihood)


def discriminator_loss(likelihood_pred: torch.Tensor, likelihood_gt: torch.Tensor) -> torch.Tensor:
    """GAN discriminator BCE in likelihood space."""
    return -torch.mean(torch.log(1.0 - likelihood_pred + 1e-8)) - torch.mean(
        torch.log(likelihood_gt + 1e-8)
    )


def compute_pred_loss(
    recon_loss_type: str,
    pred: torch.Tensor,  # [B, M, T, D] (or [B, T, D] for unimodal)
    target_traj: torch.Tensor,  # [B, T, D]
    avails: torch.Tensor,  # [B, T]
    prob: Optional[torch.Tensor] = None,  # [B, M]
    weights_scaling: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch on the reconstruction-loss type ("MSE" or "NLL")."""
    if pred.ndim == 3:
        return trajectory_loss(pred, target_traj, avails, weights_scaling)
    if recon_loss_type == "MSE":
        if prob is None:
            prob = torch.full(pred.shape[:2], 1.0 / pred.shape[1], device=pred.device)
        return multimodal_trajectory_loss(pred, target_traj, avails, prob, weights_scaling)
    if recon_loss_type == "NLL":
        B, M = pred.shape[:2]
        x = (target_traj * avails[..., None]).reshape(B, -1)
        m = (pred * avails[:, None, :, None]).reshape(B, M, -1)
        if prob is None:
            prob = torch.full((B, M), 1.0 / M, device=pred.device)
        return nll_gmm_loss(x, m, None, prob)
    raise ValueError(f"unknown recon loss {recon_loss_type!r}")
