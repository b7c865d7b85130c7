"""Rendering (port of `cld_tpu/viz/render.py`): the prediction against the
ground truth over an agent's raster, the world-frame rollout plot of a
scene, and its animation as a GIF.

matplotlib (headless, Agg) and Pillow are imported by the functions that
need them, never at import: the port runs without them, and only the
rollout CLI's `--render` asks for them. Tensors may lie on any device; the
plots are made from host copies.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from cld_tpu_torch.ops.geometry import transform_points


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError that names
    the package and `--render`."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering (the rollout CLI's --render) needs the matplotlib "
                          "package, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _image_module():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the rollout GIF (the rollout CLI's --render) needs the Pillow "
                          "package (PIL), which is not installed") from e
    return Image


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _composite_raster(image: np.ndarray) -> np.ndarray:
    """[H, W, C] raster stack -> displayable RGB: the drivable layer as the
    background in gray, the history channels over it (ego red, others
    blue)."""
    H, W, C = image.shape
    sem = image[..., -3:]  # semantic layers
    hist = image[..., :-3]  # history channels
    rgb = np.zeros((H, W, 3), dtype=np.float32)
    rgb[..., :] = 0.25 + 0.5 * sem[..., 0:1]
    ego = (hist > 0.5).any(axis=-1)
    others = (hist < -0.5).any(axis=-1)
    rgb[others] = [0.2, 0.4, 1.0]
    rgb[ego] = [1.0, 0.2, 0.2]
    return np.clip(rgb, 0, 1)


def _to_pixels(points: np.ndarray, raster_from_agent: np.ndarray) -> np.ndarray:
    """[T, 2] agent-frame points -> raster pixels."""
    return _np(transform_points(torch.from_numpy(points[None]),
                                torch.from_numpy(raster_from_agent[None])))[0]


def render_batch_prediction(
    batch,
    pred_positions=None,
    indices: Sequence[int] = (0,),
    out_path: Optional[str] = None,
):
    """The ground-truth future (green) and a prediction (yellow, dashed)
    over each indexed agent's raster. `pred_positions`: [B, T, 2]
    agent-frame positions (optional). Returns the figure (saved to
    `out_path` and closed when one is given)."""
    plt = _pyplot()
    n = len(indices)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5), squeeze=False)
    image = _np(batch.image)
    rfa = _np(batch.raster_from_agent).astype(np.float32)
    gt = _np(batch.target_positions).astype(np.float32)
    for ax, i in zip(axes[0], indices):
        ax.imshow(_composite_raster(image[i]), origin="upper")
        gt_px = _to_pixels(gt[i], rfa[i])
        ax.plot(gt_px[:, 0], gt_px[:, 1], "g-", lw=2, label="GT")
        if pred_positions is not None:
            pr_px = _to_pixels(_np(pred_positions[i]).astype(np.float32), rfa[i])
            ax.plot(pr_px[:, 0], pr_px[:, 1], "y--", lw=2, label="pred")
        ax.legend(loc="upper right")
        ax.set_title(f"sample {i}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
    return fig


def render_scene_rollout(
    pack,
    trajectories,
    out_path: Optional[str] = None,
    scene: int = 0,
    upto_step: Optional[int] = None,
    figsize: float = 8.0,
):
    """World-frame rollout plot of one scene: its drivable map and each
    agent's trajectory [T, Na, 4] (controlled red and solid, replayed blue
    and dashed), the last position marked."""
    plt = _pyplot()
    traj = _np(trajectories)
    if upto_step is not None:
        traj = traj[:upto_step]
    scene_index = _np(pack.scene_index)
    controlled = _np(pack.controlled_mask)
    world_map = _np(pack.world_map[scene])
    origin = _np(pack.map_origin[scene])
    res = float(pack.map_resolution)
    Hw, Ww = world_map.shape[:2]

    fig, ax = plt.subplots(figsize=(figsize, figsize))
    extent = [origin[0], origin[0] + Ww * res, origin[1], origin[1] + Hw * res]
    ax.imshow(0.25 + 0.5 * world_map[..., 0], origin="lower", extent=extent, cmap="gray",
              vmin=0, vmax=1)
    for a in np.nonzero(scene_index == scene)[0]:
        style = "-" if controlled[a] else "--"
        color = "tab:red" if controlled[a] else "tab:blue"
        ax.plot(traj[:, a, 0], traj[:, a, 1], style, color=color, lw=1.5)
        ax.plot(traj[-1, a, 0], traj[-1, a, 1], "o", color=color, ms=5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"scene {scene}: controlled (red), replay (blue)")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
    return fig


def save_rollout_gif(
    pack, trajectories, out_path: str, scene: int = 0, stride: int = 5, figsize: float = 8.0,
):
    """The rollout of one scene as an animated GIF: one frame per `stride`
    simulation frames (T // stride frames), each the plot up to its frame."""
    Image = _image_module()
    plt = _pyplot()
    traj = _np(trajectories)
    frames = []
    for t in range(stride, traj.shape[0] + 1, stride):
        fig = render_scene_rollout(pack, traj, scene=scene, upto_step=t, figsize=figsize)
        fig.canvas.draw()
        frames.append(Image.fromarray(np.asarray(fig.canvas.buffer_rgba())[..., :3]))
        plt.close(fig)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:], duration=200, loop=0)
    return out_path
