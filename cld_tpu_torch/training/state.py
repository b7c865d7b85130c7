"""Optimizer, schedules and EMA of the trainers (port of
`cld_tpu/training/state.py`).

The optimizer is `torch.optim.Adam` with coupled L2 weight decay (the decay is
added to the gradient before the Adam moments; not AdamW), eps 1e-8 outside
the root. Its rate follows an epoch-granular warmup + cosine schedule:
`TrainState.apply_gradients` writes `lr_schedule(step)` into the optimizer
before update number `step`, so an update reads the rate at the count before
it, as the JAX package's optax chain does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn


def resolve_compute_dtype(precision: Optional[str] = "auto", device="cpu") -> torch.dtype:
    """Network compute dtype for training (`train.training.precision`).
    Parameters, optimizer state and losses stay float32: mixed precision, as
    the JAX package's `resolve_compute_dtype` gives its flax modules. "auto"
    is bfloat16 on a CUDA device and float32 elsewhere (the JAX package's
    auto is bf16 on its accelerator), so CPU runs stay float32. Every trainer
    (VAE, DM, PPO, the zoo, GAN, EBM and scene diffusion) computes its
    networks at this dtype; the zoo's `diff` and the scene model's
    conditioning encoder stay float32, as in the JAX package."""
    if precision in ("auto", None):
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    table = {
        "bf16": torch.bfloat16,
        "bf16-mixed": torch.bfloat16,
        "bf16-true": torch.bfloat16,
        "16": torch.bfloat16,
        "16-mixed": torch.bfloat16,
        "fp32": torch.float32,
        "32": torch.float32,
        "32-true": torch.float32,
    }
    key = str(precision)
    if key not in table:
        raise ValueError(
            f"unknown train.training.precision {precision!r}; "
            f"accepted: 'auto', {sorted(table)}"
        )
    return table[key]


def warmup_cosine_by_epoch(
    base_lr: float, total_epochs: int, steps_per_epoch: int, warmup_epochs: float = 10
) -> Callable[[int], float]:
    """step -> learning rate: linear 0 -> 1 over `warmup_epochs`, then cosine
    to 0 over the remaining epochs. The factor changes only at epoch
    boundaries, so the rate is 0 for the whole first epoch."""

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * (epoch / max(1, warmup_epochs))
        progress = (epoch - warmup_epochs) / max(1, total_epochs - warmup_epochs)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def make_optimizer(params: Iterable[nn.Parameter], weight_decay: float = 0.0):
    """Adam(b1 0.9, b2 0.999, eps 1e-8) with coupled L2 `weight_decay`; the
    rate is set per update by `TrainState.apply_gradients`."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """What a trainer updates: the trainable module (BatchNorm running
    statistics are its buffers), its optimizer, the step -> rate schedule, the
    count of updates applied, optionally an EMA copy of the parameters (in
    `model.parameters()` order), and the data-parallel mesh of a run over
    several ranks (`parallel.mesh`; None: one process). The trainers update
    a state in place and return it."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0
    ema_params: Optional[List[torch.Tensor]] = None
    mesh: Optional[object] = None

    def loss_is_finite(self, loss: torch.Tensor) -> bool:
        """The non-finite guard's test: the loss is finite (on every rank of
        the mesh). Reads one scalar on the host."""
        from cld_tpu_torch.parallel.mesh import all_finite

        return all_finite(loss, self.mesh)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in place (first averaged
        over the mesh's ranks), at the rate `lr_schedule(step)`; clears the
        gradients and counts the step."""
        if self.mesh is not None:
            from cld_tpu_torch.parallel.mesh import average_gradients

            average_gradients(self.model.parameters(), self.mesh)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


@torch.no_grad()
def ema_update(ema_params, new_params, decay: float = 0.995) -> None:
    """In place: ema <- decay * ema + (1 - decay) * new, over two parallel
    sequences of tensors."""
    for e, p in zip(ema_params, new_params):
        e.mul_(decay).add_(p, alpha=1.0 - decay)


@dataclasses.dataclass(frozen=True)
class BetaSchedule:
    """KL weight annealing: linear 0.05 -> 0.3 over 9000 steps, clamped."""

    beta_start: float = 0.05
    beta_max: float = 0.3
    anneal_steps: int = 9000

    def __call__(self, step: int) -> float:
        inc = (self.beta_max - self.beta_start) / self.anneal_steps
        return min(self.beta_start + step * inc, self.beta_max)
