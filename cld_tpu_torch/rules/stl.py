"""Differentiable signal temporal logic robustness for traffic rules (port
of `cld_tpu/rules/stl.py`, after `stl_traffic_rules.py:7-340`).

Robustness over [..., T] signals with soft (log-sum-exp) min and max, so
that it is differentiable and can feed the guidance: higher is more
satisfied; a rule's loss is relu(-robustness).
"""

from __future__ import annotations

import dataclasses

import torch

_BIG = 1e6


def _softmin(x: torch.Tensor, dim: int = -1, temp: float = 10.0) -> torch.Tensor:
    return -torch.logsumexp(-temp * x, dim=dim) / temp


def _softmax(x: torch.Tensor, dim: int = -1, temp: float = 10.0) -> torch.Tensor:
    return torch.logsumexp(temp * x, dim=dim) / temp


def _windows(robustness: torch.Tensor, interval, fill: float) -> torch.Tensor:
    """[..., T] -> [..., T, b - a + 1]: out[t] holds steps t + a .. t + b,
    past the trace's end filled with `fill`."""
    a, b = interval
    T = robustness.shape[-1]
    pad = torch.full((*robustness.shape[:-1], b), fill, dtype=robustness.dtype,
                     device=robustness.device)
    r = torch.cat([robustness, pad], dim=-1)
    return torch.stack([r[..., i:T + i] for i in range(a, b + 1)], dim=-1)


def always(robustness: torch.Tensor, temp: float = 10.0, interval=None) -> torch.Tensor:
    """G(phi): the soft min over time of the per-step robustness.

    Without `interval`, [..., T] -> [...]. With `interval=(a, b)` (inclusive
    offsets, `stlcg.Always(interval=[a, b])`) the time axis stays: out[t] is
    the min over steps t + a .. min(t + b, T - 1), windows truncated at the
    trace's end."""
    if interval is None:
        return _softmin(robustness, dim=-1, temp=temp)
    return _softmin(_windows(robustness, interval, _BIG), dim=-1, temp=temp)


def eventually(robustness: torch.Tensor, temp: float = 10.0, interval=None) -> torch.Tensor:
    """F(phi): the soft max over time (see `always` for `interval`)."""
    if interval is None:
        return _softmax(robustness, dim=-1, temp=temp)
    return _softmax(_windows(robustness, interval, -_BIG), dim=-1, temp=temp)


def stl_and(*rs, temp: float = 10.0) -> torch.Tensor:
    return _softmin(torch.stack(rs, dim=-1), dim=-1, temp=temp)


def stl_or(*rs, temp: float = 10.0) -> torch.Tensor:
    return _softmax(torch.stack(rs, dim=-1), dim=-1, temp=temp)


@dataclasses.dataclass(frozen=True)
class SpeedLimitRule:
    """G(|speed| <= limit): robustness = min_t (limit - |v_t|)."""

    speed_limit: float = 15.0
    temp: float = 10.0

    def robustness(self, traj: torch.Tensor) -> torch.Tensor:
        """traj [..., T, 6] -> [...]; positive iff the rule holds."""
        return always(self.speed_limit - torch.abs(traj[..., 2]), temp=self.temp)

    def loss(self, traj: torch.Tensor) -> torch.Tensor:
        return torch.relu(-self.robustness(traj))


@dataclasses.dataclass(frozen=True)
class StopSignRule:
    """F(G_[0,k](inside the stop box AND |speed| <= stop_speed)): the vehicle
    must at some time hold a (near) stop for `num_steps_to_stop` + 1
    consecutive frames inside the box (the stop core of
    `stl_traffic_rules.py:108-110`)."""

    box_center: tuple = (15.0, 0.0)
    box_half: tuple = (5.0, 3.0)
    stop_speed: float = 0.5
    num_steps_to_stop: int = 0
    temp: float = 10.0

    def robustness(self, traj: torch.Tensor) -> torch.Tensor:
        center = torch.tensor(self.box_center, dtype=traj.dtype, device=traj.device)
        half = torch.tensor(self.box_half, dtype=traj.dtype, device=traj.device)
        margins = half - torch.abs(traj[..., :2] - center)  # [..., T, 2]
        inside = _softmin(margins, dim=-1, temp=self.temp)  # [..., T]
        slow = self.stop_speed - torch.abs(traj[..., 2])
        both = stl_and(inside, slow, temp=self.temp)
        held = always(both, temp=self.temp, interval=(0, self.num_steps_to_stop))
        return eventually(held, temp=self.temp)

    def loss(self, traj: torch.Tensor) -> torch.Tensor:
        return torch.relu(-self.robustness(traj))
