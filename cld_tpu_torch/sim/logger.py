"""Rollout logging: episodes of world-frame trajectories and actions,
serialized per scene to HDF5 or to one .npz (port of
`cld_tpu/sim/logger.py`, after `rollout_logger.py:9-253`). Arrays are
kept in numpy; tensors are read back at the boundary.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RolloutLogger:
    def __init__(self, dt: float = 0.1):
        self.dt = dt
        self._episodes = []

    def log_episode(self, trajectories, scene_index, controlled_mask,
                    metrics: Optional[Dict] = None, actions=None) -> None:
        """trajectories [T, Na, 4] world (x, y, v, yaw), scene_index [Na],
        controlled_mask [Na], actions [T, Na, 2] or None."""
        self._episodes.append({
            "trajectories": _np(trajectories),
            "scene_index": _np(scene_index),
            "controlled_mask": _np(controlled_mask),
            "metrics": metrics or {},
            "actions": None if actions is None else _np(actions),
        })

    def save_hdf5(self, path: str) -> str:
        """One group per episode, one subgroup per scene (centroid, speed,
        yaw, controlled, actions), the episode's scalar metrics as a JSON
        attribute. Needs `h5py`."""
        try:
            import h5py
        except ImportError as e:
            raise ImportError("RolloutLogger.save_hdf5 needs h5py, which is not installed "
                              "here; use save_npz instead") from e
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with h5py.File(path, "w") as f:
            for ei, ep in enumerate(self._episodes):
                grp = f.create_group(f"episode_{ei:04d}")
                for scene in np.unique(ep["scene_index"]):
                    agents = np.nonzero(ep["scene_index"] == scene)[0]
                    sg = grp.create_group(f"scene_{int(scene):06d}")
                    sg.create_dataset("centroid", data=ep["trajectories"][:, agents, :2])
                    sg.create_dataset("speed", data=ep["trajectories"][:, agents, 2])
                    sg.create_dataset("yaw", data=ep["trajectories"][:, agents, 3])
                    sg.create_dataset("controlled", data=ep["controlled_mask"][agents])
                    if ep["actions"] is not None:
                        sg.create_dataset("actions", data=ep["actions"][:, agents])
                kept = {}  # whatever float() accepts: numbers, 0-d arrays and tensors
                for k, v in ep["metrics"].items():
                    try:
                        kept[k] = float(v)
                    except (TypeError, ValueError):
                        pass
                grp.attrs["metrics"] = json.dumps(kept)
        return path

    def save_npz(self, path: str) -> str:
        """Every episode's trajectories as `episode_<i>_traj`; returns the
        written path (np.savez appends .npz to a path without it)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez(path, **{f"episode_{i}_traj": ep["trajectories"]
                          for i, ep in enumerate(self._episodes)})
        return path

    def __len__(self) -> int:
        return len(self._episodes)
