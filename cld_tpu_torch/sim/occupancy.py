"""Occupancy-grid metrics: KDE occupancy of rollout positions (port of
`cld_tpu/sim/occupancy.py`).

Positions are splatted into a dense [Hg, Wg] grid with a Gaussian RBF
kernel over a fixed window of cells around each one; the reductions report
the drivable area's coverage and the share of the mass off the road. The
splat is one `index_put_(accumulate=True)`: on the card it adds with
atomics, so the order in which a cell's float32 terms are summed, and with
it the cell's last bits, is not fixed.

Not `models/occupancy.py`: that is the zoo's learned occupancy network;
this module measures a rollout's log.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class OccupancyGridState(NamedTuple):
    grid: torch.Tensor  # [Hg, Wg] accumulated kernel mass
    origin: torch.Tensor  # [2] world coords of cell (0, 0)
    step: float  # meters per cell
    # mass decays as exp(-d^2 / (2 sigma)): sigma acts as the variance, as in
    # the reference's kernel (env_metrics.py:1009)
    sigma: float


def occupancy_init(origin: Tuple[float, float], size: Tuple[int, int], step: float = 1.0,
                   sigma: float = 1.0, device="cuda") -> OccupancyGridState:
    return OccupancyGridState(
        grid=torch.zeros(size, device=device),
        origin=torch.tensor(origin, dtype=torch.float32, device=device),
        step=float(step),
        sigma=float(sigma),
    )


def occupancy_update(state: OccupancyGridState, coords: torch.Tensor, weight: float = 1.0,
                     window: int = 7) -> OccupancyGridState:
    """Splat [N, 2] world positions with a Gaussian kernel over a window x
    window cell neighbourhood (`env_metrics.py:991-1009,1032-1046`)."""
    Hg, Wg = state.grid.shape
    half = window // 2
    dev = state.grid.device
    coords = coords.to(dev, torch.float32)
    ci = (coords - state.origin) / state.step  # fractional cell coords [N, 2]
    base = torch.round(ci).to(torch.int32)  # half to even, as jnp.round
    r = torch.arange(-half, half + 1, device=dev, dtype=torch.int32)
    offs = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)  # [K*K, 2]
    cells = base[:, None, :] + offs[None, :, :]  # [N, K*K, 2]
    cell_centers = cells.to(torch.float32) * state.step + state.origin
    d2 = torch.sum((coords[:, None, :] - cell_centers) ** 2, dim=-1)
    kernel = weight * torch.exp(-d2 / (2 * state.sigma))  # [N, K*K]
    cx, cy = cells[..., 0], cells[..., 1]  # the grid is indexed [y, x]
    valid = (cx >= 0) & (cx < Wg) & (cy >= 0) & (cy < Hg) & torch.isfinite(kernel)
    kernel = torch.where(valid, kernel, torch.zeros_like(kernel))
    grid = state.grid.clone().index_put_(
        (cy.clamp(0, Hg - 1).reshape(-1).long(), cx.clamp(0, Wg - 1).reshape(-1).long()),
        kernel.reshape(-1), accumulate=True)
    return state._replace(grid=grid)


def occupancy_metrics(state: OccupancyGridState, drivable_map: torch.Tensor,
                      map_origin: torch.Tensor, map_resolution: float,
                      occupied_thresh: float = 0.1) -> Dict[str, float]:
    """Coverage and off-road occupancy reductions (`Occupancymet` family)."""
    Hg, Wg = state.grid.shape
    dev = state.grid.device
    drivable_map = drivable_map.to(dev)
    map_origin = map_origin.to(dev)
    ys = state.origin[1] + torch.arange(Hg, device=dev) * state.step
    xs = state.origin[0] + torch.arange(Wg, device=dev) * state.step
    # the casts truncate toward zero, as astype(int32) does
    px = ((xs - map_origin[0]) / map_resolution).to(torch.int32).clamp(
        0, drivable_map.shape[1] - 1).long()
    py = ((ys - map_origin[1]) / map_resolution).to(torch.int32).clamp(
        0, drivable_map.shape[0] - 1).long()
    lane_flag = drivable_map[py[:, None], px[None, :]] > 0  # [Hg, Wg]

    occupied = state.grid > occupied_thresh
    total_mass = torch.sum(state.grid)
    offroad_mass = torch.sum(torch.where(~lane_flag, state.grid, torch.zeros_like(state.grid)))
    drivable_cells = torch.clamp(torch.sum(lane_flag), min=1)
    return {
        "occupancy_coverage": float(torch.sum(occupied & lane_flag) / drivable_cells),
        "offroad_occupancy_fraction": float(offroad_mass / torch.clamp(total_mass, min=1e-6)),
        "occupied_cells": float(torch.sum(occupied)),
    }
