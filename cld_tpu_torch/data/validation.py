"""Batch self-consistency checks (port of `cld_tpu/data/validation.py`):
that a TrafficBatch is coherent before it reaches training (standardized
frames, finite values, mask and shape agreement, a ground-truth future the
dynamics can integrate). The converter runs it on what it packs; it also
serves as a loader debug hook. The problem strings are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics


def check_batch_consistency(
    batch: TrafficBatch, dyn: Optional[UnicycleParams] = None, atol_pos: float = 0.5
) -> List[str]:
    """A list of violation strings (empty: consistent)."""
    problems: List[str] = []
    b = {k: v.detach().cpu().numpy() for k, v in batch._asdict().items() if torch.is_tensor(v)}

    for name, arr in b.items():
        if not np.isfinite(arr).all():
            problems.append(f"{name}: non-finite values")

    B = b["image"].shape[0]
    for name in ("drivable_map", "raster_from_agent", "curr_speed", "target_positions"):
        if b[name].shape[0] != B:
            problems.append(f"{name}: batch dim {b[name].shape[0]} != {B}")

    # standardized agent frame: current pose at the origin
    if np.abs(b["history_positions"][:, -1]).max() > 1e-3:
        problems.append("history_positions[-1] not at origin (unstandardized frame?)")
    if np.abs(b["history_yaws"][:, -1]).max() > 1e-3:
        problems.append("history_yaws[-1] not zero (unstandardized frame?)")

    # availability masks are {0, 1}
    for name in ("target_availabilities", "history_availabilities"):
        if not np.isin(np.unique(b[name]), [0.0, 1.0]).all():
            problems.append(f"{name}: non-binary availability values")

    # the ground-truth future must re-integrate through the dynamics:
    # inverse dynamics -> forward rollout -> positions
    dyn = RECORD_DYNAMICS if dyn is None else dyn
    sa = get_state_and_action_from_batch(batch, batch.target_positions.shape[1])
    re = unicycle_forward_dynamics(dyn, get_current_states(batch), sa[..., 4:6], 0.1)
    err = np.abs(re[..., :2].detach().cpu().numpy() - b["target_positions"])
    avail = b["target_availabilities"][..., None] > 0
    max_err = (err * avail).max() if avail.any() else 0.0
    if max_err > atol_pos:
        problems.append(f"GT future not dynamics-consistent: max position error {max_err:.3f} m")
    return problems
