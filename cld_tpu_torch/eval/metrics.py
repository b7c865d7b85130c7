"""Open-loop evaluation metrics (port of `cld_tpu/eval/metrics.py`): ADE /
FDE and the Wasserstein "realism deviation" over longitudinal and lateral
acceleration and jerk (`guide_dm_trainer.py:253-295`). The work is numpy on
the host, as in the JAX package; tensors are taken at the boundary.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ade(pred, gt, avail=None) -> float:
    """Average displacement error over [B, T, 2] trajectories."""
    err = np.linalg.norm(_np(pred) - _np(gt), axis=-1)
    if avail is not None:
        avail = _np(avail)
        return float((err * avail).sum() / np.clip(avail.sum(), 1, None))
    return float(err.mean())


def fde(pred, gt, avail=None) -> float:
    """Final displacement error at the last available frame of each sample
    (`metrics.py:242-287`); samples with no available frame are left out."""
    err = np.linalg.norm(_np(pred) - _np(gt), axis=-1)  # [..., T]
    if avail is None:
        return float(err[..., -1].mean())
    avail = _np(avail) > 0
    T = err.shape[-1]
    last = T - 1 - np.argmax(avail[..., ::-1], axis=-1)
    has_any = avail.any(axis=-1)
    final = np.take_along_axis(err, last[..., None], axis=-1)[..., 0]
    return float((final * has_any).sum() / np.clip(has_any.sum(), 1, None))


def wasserstein_1d(a, b) -> float:
    """W1 distance between two empirical distributions (the integral of
    |CDF_a - CDF_b|, as scipy computes it), in float64."""
    a = np.sort(_np(a).astype(np.float64).ravel())
    b = np.sort(_np(b).astype(np.float64).ravel())
    all_vals = np.sort(np.concatenate([a, b]))
    deltas = np.diff(all_vals)
    cdf_a = np.searchsorted(a, all_vals[:-1], side="right") / len(a)
    cdf_b = np.searchsorted(b, all_vals[:-1], side="right") / len(b)
    return float(np.sum(np.abs(cdf_a - cdf_b) * deltas))


def realism_deviation(stats: Dict, dt: float = 0.1) -> Dict[str, float]:
    """Wasserstein realism metrics from accumulated per-batch statistics:
    long_acc_gt / _pred, lat_acc_gt / _pred, and jerk_gt / _pred (as
    `training.ppo.PPOTrainer.test_step` gives them) or 2-D per-agent
    acceleration rows, differenced along time here."""
    long_gt = _np(stats["long_acc_gt"])
    long_pred = _np(stats["long_acc_pred"])
    if "jerk_gt" in stats:
        jerk_gt = _np(stats["jerk_gt"])
        jerk_pred = _np(stats["jerk_pred"])
    elif long_gt.ndim >= 2:
        jerk_gt = np.diff(long_gt, axis=-1) / dt
        jerk_pred = np.diff(long_pred, axis=-1) / dt
    else:
        raise ValueError(
            "realism_deviation needs per-agent jerk: pass jerk_gt / jerk_pred or 2-D "
            "per-agent acceleration rows; differencing flat concatenated arrays would add "
            "false jerk samples at the seams between agents and batches")
    wd_long = wasserstein_1d(long_gt, long_pred)
    wd_lat = wasserstein_1d(stats["lat_acc_gt"], stats["lat_acc_pred"])
    wd_jerk = wasserstein_1d(jerk_gt, jerk_pred)
    return {
        "wd_long": wd_long,
        "wd_lat": wd_lat,
        "wd_jerk": wd_jerk,
        "realism_deviation": (wd_long + wd_lat + wd_jerk) / 3.0,
    }
