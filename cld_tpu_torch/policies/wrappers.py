"""Policy wrappers: functional combinators over `(obs, rng) -> Action` (port
of `cld_tpu/policies/wrappers.py`).

Randomness: where the JAX package splits its key in two, a wrapper here
takes `rng` either as a pair (one entry per consumer, explicit noise
allowed) or as one `torch.Generator` (or None) that the consumers draw
from in order.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from cld_tpu_torch.guidance.losses import GuidanceContext
from cld_tpu_torch.guidance.perturbation import (
    GuidanceSpec,
    choose_best_sample,
    is_scene_level_spec,
)
from cld_tpu_torch.ops.dynamics import angle_diff, convert_state_to_state_and_action
from cld_tpu_torch.policies.common import Action

PolicyFn = Callable  # (obs, rng) -> Action


def _split_rng(rng):
    """A pair stays a pair; a generator (or None) serves both consumers."""
    if isinstance(rng, (tuple, list)):
        if len(rng) != 2:
            raise ValueError(f"expected a pair of rngs, got {len(rng)} entries")
        return rng[0], rng[1]
    return rng, rng


def with_kwargs(policy, **kwargs) -> PolicyFn:
    """Bind run-time keyword arguments."""
    return functools.partial(policy, **kwargs)


def masked_policy(mask: torch.Tensor, policy_true: PolicyFn, policy_false: PolicyFn) -> PolicyFn:
    """Per-agent policy selection: mask [B] picks policy_true's action where
    True. Policies may plan different horizons; the blend covers the common
    prefix."""

    def policy(obs, rng):
        r1, r2 = _split_rng(rng)
        a = policy_true(obs, r1)
        b = policy_false(obs, r2)
        T = min(a.positions.shape[-2], b.positions.shape[-2])
        cut = lambda x: None if x is None else x[..., :T, :]
        m = mask.reshape((-1, 1, 1))
        return Action(
            positions=torch.where(m, cut(a.positions), cut(b.positions)),
            yaws=torch.where(m, cut(a.yaws), cut(b.yaws)),
            controls=None
            if a.controls is None or b.controls is None
            else torch.where(m, cut(a.controls), cut(b.controls)),
        )

    return policy


def pos2yaw_policy(policy: PolicyFn, dt: float = 0.1, yaw_correction_speed: float = 1.0) -> PolicyFn:
    """Recompute yaws from positions: the heading of each displacement, the
    previous yaw held (0 before the first fast step) while the speed is
    below the correction threshold."""

    def wrapped(obs, rng):
        a = policy(obs, rng)
        pos = torch.cat([torch.zeros_like(a.positions[..., :1, :]), a.positions], dim=-2)
        delta = pos[..., 1:, :] - pos[..., :-1, :]
        speed = torch.linalg.norm(delta, dim=-1) / dt
        yaw = torch.atan2(delta[..., 1], delta[..., 0])  # [..., T]
        ok = speed > yaw_correction_speed
        T = yaw.shape[-1]
        # index of the latest fast step at or before t (-1: none yet)
        steps = torch.arange(T, device=yaw.device).expand_as(yaw)
        last = torch.cummax(torch.where(ok, steps, torch.full_like(steps, -1)), dim=-1).values
        held = torch.gather(yaw, -1, last.clamp(min=0))
        held = torch.where(last >= 0, held, torch.zeros_like(held))
        return a._replace(yaws=held[..., None])

    return wrapped


def guided_sampling_policy(
    sampler: Callable,  # (obs, rng) -> trajectories [B, N, T, 6] descaled
    specs: Sequence[GuidanceSpec],
    make_ctx: Callable[[object], GuidanceContext],
) -> PolicyFn:
    """Filtration policy: draw N samples, score each with the guidance
    losses, execute the best (one shared sample per scene when a
    scene-coupled rule is active)."""

    def policy(obs, rng):
        trajs = sampler(obs, rng)  # [B, N, T, 6]
        ctx = make_ctx(obs)
        with torch.no_grad():
            total = torch.zeros(trajs.shape[:2], dtype=trajs.dtype, device=trajs.device)
            for spec in specs:
                total = total + spec.weight * spec.loss(trajs, ctx, agt_mask=None)
        best, _ = choose_best_sample(
            trajs, total, scene_index=ctx.scene_index,
            scene_level=any(is_scene_level_spec(s) for s in specs),
        )
        return Action(positions=best[..., :2], yaws=best[..., 3:4], controls=best[..., 4:6])

    return policy


def ou_noise(rng, shape, theta: float = 0.8, sigma=(0.0, 0.1, 0.2), device=None) -> torch.Tensor:
    """Ornstein-Uhlenbeck noise over the time axis: shape [..., T, D], per-dim
    sigma. `rng` is the standard-normal draw itself (a tensor of `shape`) or
    a generator (or None) to draw it from on `device`."""
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != tuple(shape):
            raise ValueError(f"explicit OU noise has shape {tuple(rng.shape)}, expected {shape}")
        eps = rng
    else:
        eps = torch.randn(shape, generator=rng, device=device)
    sig = torch.as_tensor(sigma, dtype=eps.dtype, device=eps.device)[: shape[-1]]
    cur = torch.zeros_like(eps[..., 0, :])
    out = []
    for t in range(shape[-2]):
        cur = (1 - theta) * cur + eps[..., t, :]
        out.append(cur)
    return torch.stack(out, dim=-2) * sig


def hierarchical_policy(planner: PolicyFn, dt: float = 0.1) -> PolicyFn:
    """Planner + tracking-controller composition: a plan without controls
    gets them from inverse unicycle dynamics relative to the agent's current
    speed."""

    def policy(obs, rng):
        plan = planner(obs, rng)
        if plan.controls is not None:
            return plan
        traj_state = torch.cat([plan.positions, plan.yaws], dim=-1)
        sa = convert_state_to_state_and_action(traj_state, obs.curr_speed, dt)
        return plan._replace(controls=sa[..., 4:6])

    return policy


def ou_perturbation_policy(policy: PolicyFn, theta: float = 0.8, sigma=(0.0, 0.1, 0.2)) -> PolicyFn:
    """Perturb actions with OU noise on the (x, y, yaw) channels; the
    controls are dropped (they no longer match the plan). `rng`: a pair
    (inner policy's rng, OU draw or generator) or one generator for both."""

    def wrapped(obs, rng):
        a_rng, n_rng = _split_rng(rng)
        a = policy(obs, a_rng)
        noise = ou_noise(n_rng, tuple(a.positions.shape[:-1]) + (3,), theta, sigma,
                         device=a.positions.device)
        return a._replace(
            positions=a.positions + noise[..., :2],
            yaws=angle_diff(a.yaws + noise[..., 2:3], torch.zeros_like(a.yaws)),
            controls=None,
        )

    return wrapped
