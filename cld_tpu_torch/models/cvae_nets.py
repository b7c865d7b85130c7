"""CVAE building-block networks (port of `cld_tpu/models/cvae_nets.py`):
`SplitMLP` / `MIMOMLP` (dict-out / dict-in-dict-out MLPs),
`RNNTrajectoryEncoder`, `PosteriorEncoder`, `ScenePosteriorEncoder`
(per-agent features, one attention pass, masked aggregation),
`ConditionNet`, `ConditionDecoder` and `MLPTrajectoryDecoder` (feature ->
actions -> unicycle-integrated trajectory).

Flax infers input widths at its first call; here each constructor takes
them. Submodules carry the flax module names (`MLP_0`, `SplitMLP_0`,
`LSTMEncoder_0`, ...) so `utils.weights.export_flax` maps the JAX variables
one to one.

Each network carries `compute_dtype` (`ops.precision`), the JAX module's
`dtype`: at bf16 it runs under bf16 autocast over float32 parameters (the
LSTMs through `models.vae._lstm_stack`, which casts explicitly with autocast
off). The decoder's unicycle integration and the masked aggregation's
sentinel stay outside it, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from cld_tpu_torch.models.nets import MLP, MultiHeadDotProductAttention
from cld_tpu_torch.models.vae import LSTMEncoder
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast


class SplitMLP(nn.Module):
    """MLP whose flat output is split into named heads; `output_shapes`
    maps a name to its trailing shape, in order."""

    compute_dtype = torch.float32

    def __init__(self, input_dim: int, output_shapes: Mapping[str, Tuple[int, ...]],
                 layer_dims: Sequence[int] = (128, 128), normalization: bool = False):
        super().__init__()
        self.output_shapes = {k: tuple(v) for k, v in output_shapes.items()}
        total = sum(math.prod(s) for s in self.output_shapes.values())
        self.MLP_0 = MLP(input_dim, total, tuple(layer_dims), normalization)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with autocast(self.compute_dtype, x.device.type):
            flat = self.MLP_0(x)
        out, ofs = {}, 0
        for k, s in self.output_shapes.items():
            n = math.prod(s)
            out[k] = flat[..., ofs:ofs + n].reshape(*x.shape[:-1], *s)
            ofs += n
        return out


class MIMOMLP(nn.Module):
    """Dict-in dict-out MLP: the named inputs, flattened per sample and
    concatenated in sorted name order (`input_dim` wide in all), then a
    `SplitMLP`."""

    compute_dtype = torch.float32

    def __init__(self, input_dim: int, output_shapes: Mapping[str, Tuple[int, ...]],
                 layer_dims: Sequence[int] = (128, 128)):
        super().__init__()
        self.SplitMLP_0 = SplitMLP(input_dim, output_shapes, layer_dims)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        flat = torch.cat([inputs[k].reshape(inputs[k].shape[0], -1) for k in sorted(inputs)],
                         dim=-1)
        with autocast(self.compute_dtype, flat.device.type):
            return self.SplitMLP_0(flat)


class RNNTrajectoryEncoder(nn.Module):
    """Trajectory [B, T, D] -> the last hidden state [B, H] of a one-layer
    LSTM whose initial hidden state is its `cond2hidden` of zeros (the bias),
    as the JAX module's."""

    compute_dtype = torch.float32

    def __init__(self, input_dim: int, rnn_hidden_size: int = 100):
        super().__init__()
        self.rnn_hidden_size = rnn_hidden_size
        self.LSTMEncoder_0 = LSTMEncoder(input_dim, rnn_hidden_size, rnn_hidden_size,
                                         num_layers=1)

    def forward(self, traj: torch.Tensor) -> torch.Tensor:
        cond = traj.new_zeros(traj.shape[0], self.rnn_hidden_size)
        with autocast(self.compute_dtype, traj.device.type):
            return self.LSTMEncoder_0(traj, cond)[:, -1]


class PosteriorEncoder(nn.Module):
    """(trajectories [B, T, D], condition features [B, C]) -> named q
    parameters."""

    compute_dtype = torch.float32

    def __init__(self, traj_dim: int, cond_dim: int,
                 output_shapes: Mapping[str, Tuple[int, ...]],
                 mlp_layer_dims: Sequence[int] = (128, 128), rnn_hidden_size: int = 100,
                 normalization: bool = False):
        super().__init__()
        self.RNNTrajectoryEncoder_0 = RNNTrajectoryEncoder(traj_dim, rnn_hidden_size)
        self.SplitMLP_0 = SplitMLP(rnn_hidden_size + cond_dim, output_shapes, mlp_layer_dims,
                                   normalization)

    def forward(self, trajectories, condition_features):
        with autocast(self.compute_dtype, trajectories.device.type):
            feat = torch.cat([self.RNNTrajectoryEncoder_0(trajectories), condition_features],
                             dim=-1)
            return self.SplitMLP_0(feat)


class ScenePosteriorEncoder(nn.Module):
    """Scene-level posterior: per-agent (trajectory, condition) features, one
    self-attention pass among the real agents (plus a residual), and a masked
    max or mean over agents, then a `SplitMLP`. The max fills padding
    agents with float32's minimum, so it runs in at least float32, as the
    JAX module's does."""

    compute_dtype = torch.float32

    def __init__(self, traj_dim: int, cond_dim: int,
                 output_shapes: Mapping[str, Tuple[int, ...]], aggregate_func: str = "max",
                 mlp_layer_dims: Sequence[int] = (128, 128), rnn_hidden_size: int = 100,
                 num_heads: int = 4):
        super().__init__()
        if aggregate_func not in ("max", "mean"):
            raise ValueError(aggregate_func)
        self.aggregate_func = aggregate_func
        D = rnn_hidden_size + cond_dim
        Dh = -(-D // num_heads) * num_heads  # head-divisible width
        self.RNNTrajectoryEncoder_0 = RNNTrajectoryEncoder(traj_dim, rnn_hidden_size)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            D, num_heads, qkv_features=Dh, out_features=D)
        self.SplitMLP_0 = SplitMLP(D, output_shapes, mlp_layer_dims)

    def forward(self, trajectories, condition_features, mask):
        """trajectories [B, Na, T, D], condition_features [B, Na, C], mask
        [B, Na] bool (real agents)."""
        B, Na = trajectories.shape[:2]
        with autocast(self.compute_dtype, trajectories.device.type):
            traj_feat = self.RNNTrajectoryEncoder_0(
                trajectories.reshape(B * Na, *trajectories.shape[2:])).reshape(B, Na, -1)
            feat = torch.cat([traj_feat, condition_features], dim=-1)
            attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
            feat = feat + self.MultiHeadDotProductAttention_0(feat, feat, mask=attn_mask)
        if self.aggregate_func == "max":
            wide = feat.to(torch.promote_types(feat.dtype, torch.float32))
            agg = torch.where(mask[..., None], wide, torch.finfo(torch.float32).min).amax(dim=1)
        else:
            m = mask[..., None].to(feat.dtype)
            msum = m.sum(1)
            agg = (feat * m).sum(1) / torch.maximum(msum, msum.new_tensor(1e-6))
        with autocast(self.compute_dtype, trajectories.device.type):
            return self.SplitMLP_0(agg)


class ConditionNet(nn.Module):
    """Named condition inputs (`input_dim` wide when flattened and
    concatenated) -> one ReLU condition feature [B, condition_dim]."""

    compute_dtype = torch.float32

    def __init__(self, input_dim: int, condition_dim: int, mlp_layer_dims: Sequence[int] = ()):
        super().__init__()
        self.MIMOMLP_0 = MIMOMLP(input_dim, {"feat": (condition_dim,)}, mlp_layer_dims)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with autocast(self.compute_dtype, next(iter(inputs.values())).device.type):
            return torch.relu(self.MIMOMLP_0(inputs)["feat"])


class ConditionDecoder(nn.Module):
    """(z, c) -> decoder(concat(z, c))."""

    def __init__(self, decoder: nn.Module):
        super().__init__()
        self.decoder = decoder

    def forward(self, latents, condition_features, **kw):
        return self.decoder(torch.cat([latents, condition_features], dim=-1), **kw)


class MLPTrajectoryDecoder(nn.Module):
    """Feature -> action sequence -> dynamics-integrated trajectory. With
    dynamics the MLP predicts scaled (acc, yawvel), descaled and integrated
    through the unicycle from `curr_states` -> {"trajectories" [B, T, 6]
    (x, y, v, yaw, acc, yawvel), "controls"}; without, it predicts raw
    states [B, T, state_dim]."""

    compute_dtype = torch.float32

    def __init__(self, feat_dim: int, horizon: int, state_dim: int = 3,
                 layer_dims: Sequence[int] = (128, 128), use_dynamics: bool = True,
                 dt: float = 0.1, dyn: UnicycleParams = RECORD_DYNAMICS):
        super().__init__()
        self.horizon, self.state_dim = horizon, state_dim
        self.use_dynamics, self.dt, self.dyn = use_dynamics, dt, dyn
        out = horizon * (2 if use_dynamics else state_dim)
        self.MLP_0 = MLP(feat_dim, out, tuple(layer_dims))

    def forward(self, feat: torch.Tensor, curr_states: Optional[torch.Tensor] = None):
        with autocast(self.compute_dtype, feat.device.type):
            raw = self.MLP_0(feat)
        if not self.use_dynamics:
            return {"trajectories": raw.reshape(-1, self.horizon, self.state_dim)}
        if curr_states is None:
            raise ValueError("MLPTrajectoryDecoder with dynamics needs curr_states")
        actions = TrajNormalizer().descale(raw.reshape(-1, self.horizon, 2), [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr_states, actions, self.dt)
        return {"trajectories": torch.cat([states, actions], dim=-1), "controls": actions}
