"""Checkpoints on `torch.save` (port of `cld_tpu/training/checkpoints.py`).

A checkpoint is one file holding a nested dict of CPU tensors and Python
numbers. Per-stage checkpoints store that stage's module only (`{"params":
state_dict}`; BatchNorm running statistics are buffers of the state dict), so
the next stage restores it into a fresh module. A full-state checkpoint adds
the optimizer's moments and step counts, the trainer's step and the outer
loop's step, for a true mid-training resume.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

from cld_tpu_torch.training.state import TrainState


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Save a nested dict / list of tensors and numbers (overwrites). The
    file is written beside its final name and moved into place."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, device="cpu") -> Any:
    """Load what `save_pytree` wrote, tensors mapped to `device`. Only
    tensors and plain containers are unpickled."""
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def save_train_state(path: str, state: TrainState, loop_step: Optional[int] = None) -> None:
    """Full-state checkpoint: parameters and buffers, optimizer moments, the
    state's step, the EMA copy when there is one, and `loop_step`, the outer
    training loop's step (it differs from `state.step` for PPO, where the
    optimizer steps `ppo_epochs * ppo_update_times` times per collection)."""
    tree = {
        "params": state.model.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "step": state.step,
        "loop_step": int(loop_step if loop_step is not None else state.step),
    }
    if state.ema_params is not None:
        tree["ema_params"] = list(state.ema_params)
    save_pytree(path, tree)


def restore_train_state(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore a full-state checkpoint into an initialized train state, in
    place. Returns (state, loop_step)."""
    device = next(state.model.parameters()).device
    tree = restore_pytree(path, device=device)
    state.model.load_state_dict(tree["params"], strict=True)
    state.optimizer.load_state_dict(tree["opt_state"])
    state.step = int(tree["step"])
    if state.ema_params is not None and "ema_params" in tree:
        with torch.no_grad():
            for e, saved in zip(state.ema_params, tree["ema_params"]):
                e.copy_(saved)
    return state, int(tree["loop_step"])
