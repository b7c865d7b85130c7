"""Closed-loop metric summaries (port of `cld_tpu/sim/metrics.py`): reduces
the simulator's per-agent accumulators to episode rates."""

from __future__ import annotations

from typing import Dict

from cld_tpu_torch.sim.env import SimConfig, SimState
from cld_tpu_torch.sim.scene import ScenePack

# comfort bounds: max |acceleration| and |yaw rate|
COMFORT_MAX_ABS_ACC = 3.0
COMFORT_MAX_ABS_YAWVEL = 0.7


def summarize_metrics(pack: ScenePack, state: SimState, cfg: SimConfig) -> Dict[str, float]:
    """Reduce per-agent accumulators (controlled agents only) to episode
    rates. Reads the accumulators back to the host."""
    mask = pack.controlled_mask.cpu().numpy()
    n_steps = float(state.step)
    offroad = state.offroad_steps.cpu().numpy()[mask]
    collision = state.collision_steps.cpu().numpy()[mask]
    acc = state.max_abs_acc.cpu().numpy()[mask]
    yawvel = state.max_abs_yawvel.cpu().numpy()[mask]
    ctype = state.collision_type_steps.cpu().numpy()[mask]  # [n, 3]

    # a replay-only or 0-step episode reports 0.0 rates, not NaN
    def rate(x) -> float:
        return float(x.mean()) if x.size else 0.0

    denom = max(len(offroad), 1) * max(n_steps, 1.0)
    return {
        "offroad_rate": rate(offroad > 0),  # any offroad step -> failure
        "collision_rate": rate(collision > 0),
        "collision_rate_front": rate(ctype[:, 0] > 0),
        "collision_rate_rear": rate(ctype[:, 1] > 0),
        "collision_rate_side": rate(ctype[:, 2] > 0),
        "offroad_step_fraction": float(offroad.sum() / denom),
        "collision_step_fraction": float(collision.sum() / denom),
        "critical_failure_rate": rate((offroad > 0) | (collision > 0)),
        "comfort_violation_rate": rate(
            (acc > COMFORT_MAX_ABS_ACC) | (yawvel > COMFORT_MAX_ABS_YAWVEL)
        ),
        "num_controlled_agents": int(mask.sum()),
        "num_sim_steps": n_steps,
    }
