"""Finite-time optimal control, the FTOCP family (port of
`cld_tpu/policies/mpc.py`).

The reference's casadi NLP (M contingency branches sharing the first
control, Euler unicycle dynamics, velocity-dependent steering limits,
elliptical obstacle keep-out with 1e6-cost slack, solved by IPOPT per
agent) as the JAX package re-designed it: a penalty-form cost over the
controls (u0 shared, one sequence per branch), minimized by a fixed number
of Adam iterations. Where the JAX package takes `jax.grad` inside a
`lax.scan` and vmaps over agents, here the agents are a leading batch
dimension and each iteration takes `torch.autograd.grad` of the summed
per-agent costs (the agents do not interact, so each gets its own
gradient). ReLU-squared kinks and clips follow the JAX gradients: clips are
`torch.minimum` / `torch.maximum`. Cost constants are the reference's
(cost_x 1, cost_y 5, cost_v 1, cost_acc 0.5, cost_ste 2, slack 1e6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.ops.dynamics import _clip
from cld_tpu_torch.policies.common import Action


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    N: int = 20  # horizon (planning steps)
    M: int = 1  # contingency branches (1 = plain MPC)
    dt: float = 0.1
    max_steer: float = 0.5
    max_yawvel: float = 8.0
    acce_bound: Tuple[float, float] = (-6.0, 4.0)
    vbound: Tuple[float, float] = (-5.0, 40.0)
    cost_x: float = 1.0
    cost_y: float = 5.0
    cost_v: float = 1.0
    cost_acc: float = 0.5
    cost_ste: float = 2.0
    cost_slack: float = 1e6
    # penalty weight of the hard bounds IPOPT enforces exactly
    cost_bound: float = 1e4
    iters: int = 100
    lr: float = 0.2


def _smoothmax(x: torch.Tensor, y: float, gamma: float = 10.0) -> torch.Tensor:
    """The reference's softmax(x, y): the softmax-weighted mean
    (e^{gx} x + e^{gy} y) / (e^{gx} + e^{gy}), <= max(x, y), stabilized by
    the larger exponent."""
    gx = gamma * x
    gy = torch.full_like(gx, gamma * y)
    m = torch.maximum(gx, gy)
    ex = torch.exp(gx - m)
    ey = torch.exp(gy - m)
    return (ex * x + ey * y) / (ex + ey)


def _rollout_branch(x0: torch.Tensor, u0: torch.Tensor, ubr: torch.Tensor, dt: float):
    """Euler unicycle rollout of the FTOCP's dynamics constraints,
    x_{k+1} = x_k + dt (v cos yaw, v sin yaw, a, yawvel): x0 [B, 4], u0
    [B, 2] the shared first control, ubr [B, N-1, 2] -> states [B, N, 4]."""
    u_all = torch.cat([u0[:, None], ubr], dim=1)
    x = x0
    xs = []
    for k in range(u_all.shape[1]):
        u = u_all[:, k]
        x = x + dt * torch.stack([x[:, 2] * torch.cos(x[:, 3]), x[:, 2] * torch.sin(x[:, 3]),
                                  u[:, 0], u[:, 1]], dim=-1)
        xs.append(x)
    return torch.stack(xs, dim=1)


def ftocp_solve(
    cfg: MPCConfig,
    x0: torch.Tensor,  # [B, 4] current (x, y, v, yaw)
    ypreds: torch.Tensor,  # [B, Nobs, M, N, 2] predicted obstacle positions
    obs_mask: torch.Tensor,  # [B, Nobs] bool: which obstacle rows are real
    agent_extent: torch.Tensor,  # [B, Nobs, 2] (length, width)
    ego_extent: torch.Tensor,  # [B, 2] (length L, width W)
    xdes: torch.Tensor,  # [B, N, 3+] desired (x, y, v[, yaw])
    mode_weights: torch.Tensor,  # [M] branch weights
    u_init: Optional[torch.Tensor] = None,  # [B, M, N, 2] warm start
) -> Dict[str, torch.Tensor]:
    """Solve each agent's contingency MPC (the JAX package's `ftocp_solve`,
    batched over a leading agent dimension). Returns xbr [B, M, N, 4], u0
    [B, 2], ubr [B, M, N-1, 2], cost [B], max_violation [B] (the worst
    per-step ellipse slack, 0 = feasible) and feasible [B]."""
    N, M = cfg.N, cfg.M
    B = x0.shape[0]
    dev = x0.device
    L, W = ego_extent[:, 0:1], ego_extent[:, 1:2]  # [B, 1]
    u_lb = torch.tensor([cfg.acce_bound[0], -cfg.max_steer * cfg.vbound[1]], device=dev)
    u_ub = torch.tensor([cfg.acce_bound[1], cfg.max_steer * cfg.vbound[1]], device=dev)
    mask = obs_mask.to(x0.dtype)

    def unpack(z):
        u0 = torch.minimum(torch.maximum(z[:, :2], u_lb), u_ub)
        ubr = torch.minimum(torch.maximum(z[:, 2:].reshape(B, M, N - 1, 2), u_lb), u_ub)
        return u0, ubr

    # semi-axes of the keep-out ellipse
    ax = (L / 1.414 + agent_extent[..., 0] / 1.414) ** 2  # [B, Nobs]
    ay = (W / 1.414 + agent_extent[..., 1] / 1.414) ** 2
    relu = torch.relu

    def penalties(xs, u_all):
        """Steering and yaw-rate limits and velocity bounds of one branch."""
        v = xs[..., 2]  # [B, N]
        steer_lim = _smoothmax(v, 1.0) * cfg.max_steer
        p_steer = torch.sum(relu(torch.abs(u_all[..., 1]) - steer_lim) ** 2, dim=-1)
        p_yawvel = torch.sum(relu(torch.abs(u_all[..., 1] * v) - cfg.max_yawvel) ** 2, dim=-1)
        p_v = torch.sum(relu(cfg.vbound[0] - v) ** 2 + relu(v - cfg.vbound[1]) ** 2, dim=-1)
        return cfg.cost_bound * (p_steer + p_yawvel + p_v)

    def obstacle_slack(xs, ypred_b):
        """relu(1 - e), the reference's optimal slack of the ellipse
        constraint e >= 1: (sum, max) per agent."""
        d = xs[:, None, :, :2] - ypred_b  # [B, Nobs, N, 2]
        e = d[..., 0] ** 2 / ax[..., None] + d[..., 1] ** 2 / ay[..., None]
        slack = relu(1.0 - e) * mask[..., None]
        return slack.sum(dim=(-1, -2)), slack.flatten(1).amax(dim=-1)

    Q = torch.tensor([cfg.cost_x, cfg.cost_y, cfg.cost_v], device=dev)
    R = torch.tensor([cfg.cost_acc, cfg.cost_ste], device=dev)

    def total_cost(z):
        u0, ubr = unpack(z)
        cost = torch.sum(u0 ** 2 * R, dim=-1)
        viol = torch.zeros((B,), device=dev)
        for i in range(M):
            xs = _rollout_branch(x0, u0, ubr[:, i], cfg.dt)
            u_all = torch.cat([u0[:, None], ubr[:, i]], dim=1)
            track = torch.sum((xs[..., :3] - xdes[..., :3]) ** 2 * Q, dim=(-1, -2))
            ctrl = torch.sum(ubr[:, i] ** 2 * R, dim=(-1, -2))
            slack, slack_max = obstacle_slack(xs, ypreds[:, :, i])
            cost = cost + mode_weights[i] * (track + ctrl + cfg.cost_slack * slack) \
                + penalties(xs, u_all)
            viol = torch.maximum(viol, slack_max)
        return cost, viol

    if u_init is None:
        z = torch.zeros((B, 2 + M * (N - 1) * 2), device=dev)
    else:
        z = torch.cat([u_init[:, 0, 0], u_init[:, :, 1:].reshape(B, -1)], dim=-1)

    # Adam, with the bias corrections in float32 as the JAX loop's carry is
    # (host scalars: no copy to the device per iteration)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    one, b1, b2 = np.float32(1.0), np.float32(0.9), np.float32(0.999)
    with torch.enable_grad():
        for it in range(cfg.iters):
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(total_cost(zz)[0].sum(), zz)
            t = np.float32(it + 1)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g ** 2
            mh = m / float(one - b1 ** t)
            vh = v / float(one - b2 ** t)
            z = z - cfg.lr * mh / (torch.sqrt(vh) + 1e-8)

    with torch.no_grad():
        u0, ubr = unpack(z)
        xbr = torch.stack([_rollout_branch(x0, u0, ubr[:, i], cfg.dt) for i in range(M)], dim=1)
        cost, viol = total_cost(z)
    return {"xbr": xbr, "u0": u0, "ubr": ubr, "cost": cost, "max_violation": viol,
            "feasible": viol < 1e-2}


def lane_ref(
    lane_points: torch.Tensor,  # [B, L, 3] agent-frame (x, y, yaw), masked
    lane_avail: torch.Tensor,  # [B, L] bool
    pos: torch.Tensor,  # [B, 2] current position
    vdes: torch.Tensor,  # [B] desired speed
    N: int,
    dt: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Desired trajectory along the lane (the reference's `obtain_ref`, in
    static shapes): for each step's arc target s_k = vdes k dt, the lane
    points soft-assigned by how well their chord distance from the nearest
    lane point matches s_k. Returns (ref [B, N, 3] (x, y, v), usable [B]):
    usable is False where no available lane point lies ahead, and callers
    fall back to the straight reference. Masked rows are zero-filled first
    (0 * NaN would poison the soft assignment)."""
    lane_points = torch.where(lane_avail[..., None], lane_points, torch.zeros_like(lane_points))
    d0 = torch.linalg.norm(lane_points[..., :2] - pos[:, None], dim=-1)
    d0 = torch.where(lane_avail, d0, torch.full_like(d0, float("inf")))
    i0 = torch.argmin(d0, dim=-1)  # [B]
    rows = torch.arange(lane_points.shape[0], device=lane_points.device)
    p0 = lane_points[rows, i0, :2]
    chord = torch.linalg.norm(lane_points[..., :2] - p0[:, None], dim=-1)  # [B, L]
    h0 = lane_points[rows, i0, 2]
    t_hat = torch.stack([torch.cos(h0), torch.sin(h0)], dim=-1)
    ahead = torch.einsum("bld,bd->bl", lane_points[..., :2] - p0[:, None], t_hat) >= 0
    ok = lane_avail & ahead
    s_tgt = vdes[:, None] * torch.arange(1, N + 1, device=vdes.device) * dt  # [B, N]
    err = torch.abs(chord[:, None, :] - s_tgt[..., None])  # [B, N, L]
    err = torch.where(ok[:, None], err, torch.full_like(err, 1e9))
    w = torch.softmax(-4.0 * err, dim=-1)
    xy = w @ lane_points[..., :2]  # [B, N, 2]
    ref = torch.cat([xy, vdes[:, None, None].expand(-1, N, 1)], dim=-1)
    return ref, ok.any(dim=-1)


def _cv_predict_neighbors(obs: TrafficBatch, N: int, dt: float):
    """Constant-velocity neighbor predictions from history (the stand-in
    for the reference's learned predictor): ([B, S, N, 2], mask [B, S])."""
    hist = obs.all_other_agents_history_positions  # [B, S, Th, 2]
    av = obs.all_other_agents_history_availability > 0  # [B, S, Th]
    last = hist[:, :, -1]
    prev = hist[:, :, -2]
    both = (av[:, :, -1] & av[:, :, -2])[..., None]
    vel = torch.where(both, (last - prev) / dt, torch.zeros_like(last))
    t = torch.arange(1, N + 1, dtype=torch.float32, device=hist.device) * dt
    pred = last[:, :, None] + vel[:, :, None] * t[None, None, :, None]
    return pred, av[:, :, -1]


def solve_from_observation(
    cfg: MPCConfig, obs: TrafficBatch, vdes_bounds: Tuple[float, float] = (2.0, 25.0),
) -> Dict[str, torch.Tensor]:
    """The MPC policy's `ftocp_solve` of one observation: the desired
    trajectory follows the ego lane where one is usable, else a straight
    constant-speed reference in the current heading; obstacles are
    constant-velocity neighbor predictions."""
    curr = get_current_states(obs)  # [B, 4]
    dev = curr.device
    N, dt = cfg.N, cfg.dt
    vdes = _clip(curr[:, 2], *vdes_bounds)

    s1 = vdes[:, None] * torch.arange(1, N + 1, device=dev)[None] * dt  # [B, N]
    xdes = torch.stack([
        curr[:, 0:1] + torch.cos(curr[:, 3:4]) * s1,
        curr[:, 1:2] + torch.sin(curr[:, 3:4]) * s1,
        vdes[:, None].expand_as(s1),
    ], dim=-1)
    if obs.lane_points is not None:
        la = (obs.lane_avail if obs.lane_avail is not None
              else torch.isfinite(obs.lane_points).all(-1))
        lane_xdes, usable = lane_ref(obs.lane_points, la, curr[:, :2], vdes, N, dt)
        xdes = torch.where(usable[:, None, None], lane_xdes, xdes)

    ypred, mask = _cv_predict_neighbors(obs, N, dt)  # [B, S, N, 2]
    ypred = ypred[:, :, None].expand(-1, -1, cfg.M, -1, -1)  # [B, S, M, N, 2]
    n_ext = torch.tensor([4.5, 2.0], device=dev).expand(*ypred.shape[:2], 2)
    w = torch.ones((cfg.M,), device=dev) / cfg.M
    return ftocp_solve(cfg, curr, ypred, mask, n_ext, obs.extent[:, :2], xdes, w)


def mpc_policy(cfg: MPCConfig = MPCConfig(), vdes_bounds: Tuple[float, float] = (2.0, 25.0)):
    """The MPC policy `(obs, rng) -> Action`: one `solve_from_observation`
    over all agents, branch 0's plan."""

    def policy(obs: TrafficBatch, rng=None) -> Action:
        sol = solve_from_observation(cfg, obs, vdes_bounds)
        xs = sol["xbr"][:, 0]  # branch 0's plan [B, N, 4]
        u_all = torch.cat([sol["u0"][:, None], sol["ubr"][:, 0]], dim=1)
        return Action(positions=xs[..., :2], yaws=xs[..., 3:4], controls=u_all)

    return policy
