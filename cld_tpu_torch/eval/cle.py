"""Closed-loop evaluator: validators, composite metrics and aggregation
(port of `cld_tpu/eval/cle.py`, after l5kit's CLE stack:
`closed_loop_evaluator.py:202`, `validators.py:50-276`,
`composite_metrics.py:40-137`).

Per-frame metric series [T, Na] are computed from the rollout log with
tensors (on the log's device), then reduced on the host in numpy to
pass / fail per validator with range and violation-duration semantics
(total or continuous), driven-miles composites, and counts across agents.
One controlled agent plays the part of an l5kit scene.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cld_tpu_torch.ops.geometry import obb_collision_matrix
from cld_tpu_torch.sim.env import SimConfig, drivable_at_world
from cld_tpu_torch.sim.scene import ScenePack


class ValidatorOutput(NamedTuple):
    """Per-scene validation result (`validators.py:13-18`)."""

    is_valid_scene: bool
    failed_frames: List[int]


def reset_cumsum(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Masked cumulative sum that restarts at every False of `mask`
    (`RangeValidator.cumsum_with_reset`, vectorized): r_t is the sum of x
    over the run of True ending at t. x, mask [..., T] -> [..., T]."""
    s = np.cumsum(np.where(mask, x, 0.0), axis=-1)
    neg = np.where(mask, -np.inf, s)  # s at the reset positions
    last_reset = np.maximum.accumulate(neg, axis=-1)
    r = np.where(np.isinf(last_reset), s, s - last_reset)
    return np.where(mask, r, 0.0)


@dataclasses.dataclass(frozen=True)
class RangeValidator:
    """A min / max range check with an optional allowance of violation
    duration (`validators.py:50-175`). `duration_mode` "total" sums a
    scene's violation durations, "continuous" asks one unbroken run of
    violation to exceed the allowance."""

    validator_name: str
    metric_name: str
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    violation_duration_s: float = 0.0
    duration_mode: str = "total"  # "total" | "continuous"

    def __post_init__(self):
        if self.min_value is None and self.max_value is None:
            raise ValueError("specify min_value and/or max_value")
        if (self.min_value is not None and self.max_value is not None
                and self.min_value >= self.max_value):
            raise ValueError("min_value must be < max_value")
        if self.duration_mode not in ("total", "continuous"):
            raise ValueError(f"unknown duration_mode {self.duration_mode!r}")

    def validate(self, series: np.ndarray, dt: float) -> ValidatorOutput:
        """series [T]: one scene's (agent's) per-frame metric values."""
        violated = np.zeros(series.shape, bool)
        if self.min_value is not None:
            violated |= series < self.min_value
        if self.max_value is not None:
            violated |= series > self.max_value
        if self.violation_duration_s <= 0.0:
            failed = np.nonzero(violated)[0]
            return ValidatorOutput(failed.size == 0, failed.tolist())
        ts_diff = np.full(series.shape, dt)
        if self.duration_mode == "total":
            cs = np.cumsum(ts_diff * violated) * violated
        else:
            cs = reset_cumsum(ts_diff, violated)
        failed = np.nonzero(cs > self.violation_duration_s)[0]
        return ValidatorOutput(failed.size == 0, failed.tolist())


# l5kit metrics.py:196-215 SimulatedDrivenMilesMetric conversion constant
METER_TO_MILES = 0.000621371


@dataclasses.dataclass(frozen=True)
class DrivenMilesCompositeMetric:
    """Total driven miles from per-frame displacements in meters
    (`composite_metrics.py:106-135`)."""

    composite_metric_name: str = "driven_miles"
    displacement_metric: str = "displacement"

    def compute(self, metric_results, validation_results) -> float:
        return float(np.sum(metric_results[self.displacement_metric]) * METER_TO_MILES)


@dataclasses.dataclass(frozen=True)
class PassedDrivenMilesCompositeMetric:
    """Driven miles up to the first failed frame of any of `validators`
    (`composite_metrics.py:40-104`)."""

    composite_metric_name: str = "passed_driven_miles"
    validators: Sequence[str] = ()
    displacement_metric: str = "displacement"

    def compute(self, metric_results, validation_results) -> float:
        disp = metric_results[self.displacement_metric]
        ok = np.ones(disp.shape, bool)
        for name in self.validators:
            out = validation_results[name]
            if out.failed_frames:
                ok[min(out.failed_frames):] = False
        return float(np.sum(disp * ok) * METER_TO_MILES)


@dataclasses.dataclass(frozen=True)
class EvaluationPlan:
    """Metrics, validators and composite metrics
    (`closed_loop_evaluator.py:11-51`). A metric maps a name to a per-frame
    series extractor (pack, traj, cfg) -> [T, Na]."""

    metrics: Dict[str, Callable]
    validators: Sequence[RangeValidator] = ()
    composite_metrics: Sequence[object] = ()

    def __post_init__(self):
        for v in self.validators:
            if v.metric_name not in self.metrics:
                raise ValueError(f"validator {v.validator_name!r} needs metric "
                                 f"{v.metric_name!r} which is not in the plan")


# per-frame series over the rollout log traj [T, Na, 4] (world x, y, v, yaw)
def displacement_series(pack: ScenePack, traj: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Per-frame driven distance (meters)."""
    pos = traj[..., :2]
    prev = torch.cat([pack.init_states[None, :, :2].to(pos), pos[:-1]], dim=0)
    return torch.linalg.vector_norm(pos - prev, dim=-1)


def offroad_series(pack: ScenePack, traj: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """1.0 where the agent's centre is off the drivable map (the simulator's
    lookup, `sim.env.drivable_at_world`)."""
    return (drivable_at_world(pack, traj[..., :2]) <= 0).to(torch.float32)


def collision_series(pack: ScenePack, traj: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """1.0 on frames where the agent's oriented box overlaps another agent's
    of its scene (the simulator's exact test, `obb_collision_matrix`)."""
    Na = pack.num_agents
    si = pack.scene_index
    eye = torch.eye(Na, dtype=torch.bool, device=traj.device)
    valid_pair = (si[:, None] == si[None, :]) & ~eye
    hit = obb_collision_matrix(traj[..., :2], traj[..., 3], pack.extent[:, :2],
                               extent_scale=cfg.collision_thresh) & valid_pair[None]
    return torch.any(hit, dim=-1).to(torch.float32)


def speed_series(pack: ScenePack, traj: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    return traj[..., 2]


def default_plan(max_speed: float = 35.0, offroad_duration_s: float = 0.0) -> EvaluationPlan:
    """The standard validation set after l5kit's CLEEvaluationPlan:
    collision, off-road and speed validators, driven-miles composites."""
    return EvaluationPlan(
        metrics={
            "displacement": displacement_series,
            "offroad": offroad_series,
            "collision": collision_series,
            "speed": speed_series,
        },
        validators=(
            RangeValidator("collision", "collision", max_value=0.5),
            RangeValidator("offroad", "offroad", max_value=0.5,
                           violation_duration_s=offroad_duration_s,
                           duration_mode="continuous"),
            RangeValidator("speed", "speed", max_value=max_speed),
        ),
        composite_metrics=(
            DrivenMilesCompositeMetric(),
            PassedDrivenMilesCompositeMetric(validators=("collision", "offroad")),
        ),
    )


class ClosedLoopEvaluator:
    """Runs an `EvaluationPlan` over a rollout log
    (`closed_loop_evaluator.py:202-277`): the metric series, then per
    controlled agent the validators and composite metrics."""

    def __init__(self, plan: EvaluationPlan):
        self.plan = plan

    def evaluate(self, pack: ScenePack, traj: torch.Tensor, cfg: SimConfig) -> Dict[str, Dict]:
        series = {name: fn(pack, traj, cfg).detach().cpu().numpy()
                  for name, fn in self.plan.metrics.items()}  # each [T, Na]
        agents = np.nonzero(pack.controlled_mask.cpu().numpy())[0]
        validation: Dict[int, Dict[str, ValidatorOutput]] = {}
        composites: Dict[int, Dict[str, float]] = {}
        for a in agents:
            per_metric = {k: v[:, a] for k, v in series.items()}
            vouts = {v.validator_name: v.validate(per_metric[v.metric_name], cfg.dt)
                     for v in self.plan.validators}
            validation[int(a)] = vouts
            composites[int(a)] = {cm.composite_metric_name: cm.compute(per_metric, vouts)
                                  for cm in self.plan.composite_metrics}
        return {"validation": validation, "composite": composites}


class ValidationCountingAggregator:
    """Failed scenes (agents) per validator (`validators.py:197-240`); with
    `failed_frames`, failed frames instead."""

    def __init__(self, failed_frames: bool = False):
        self.failed_frames = failed_frames

    def aggregate(self, validation: Dict[int, Dict[str, ValidatorOutput]]) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for outs in validation.values():
            for name, out in outs.items():
                n = len(out.failed_frames) if self.failed_frames else int(not out.is_valid_scene)
                agg[name] = agg.get(name, 0) + n
        return agg


def cle_report(pack: ScenePack, traj: torch.Tensor, cfg: SimConfig,
               plan: Optional[EvaluationPlan] = None) -> Dict[str, object]:
    """The rollout CLI's CLE summary: failed scenes and failed frames per
    validator, and each composite metric summed over the agents."""
    res = ClosedLoopEvaluator(plan or default_plan()).evaluate(pack, traj, cfg)
    comp_total: Dict[str, float] = {}
    for per_agent in res["composite"].values():
        for k, v in per_agent.items():
            comp_total[k] = comp_total.get(k, 0.0) + v
    return {
        "num_scenes": len(res["validation"]),
        "failed_scenes": ValidationCountingAggregator().aggregate(res["validation"]),
        "failed_frames": ValidationCountingAggregator(failed_frames=True).aggregate(
            res["validation"]),
        "composite": comp_total,
    }
