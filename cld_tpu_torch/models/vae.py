"""The decoder half of the LSTM-VAE and action integration (port of the
parts of `cld_tpu/models/vae.py` and `cld_tpu/models/lstm.py` that the
guided pipeline runs).

`LSTMDecoder` holds the reference torch key layout (`lstm_dec.*`:
cond2hidden, a 2-layer fused-gate LSTM, hid2act); its sequential core runs
through the kernel-backed `ops.lstm_kernels.fused_decode_actions`.
"""

from __future__ import annotations

import torch
from torch import nn

from cld_tpu_torch.ops.dynamics import UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.lstm_kernels import fused_decode_actions
from cld_tpu_torch.ops.normalization import TrajNormalizer


class _LSTMWeights(nn.Module):
    """Parameter store with torch.nn.LSTM's names (weight_ih_l{n} [4H, I],
    weight_hh_l{n} [4H, H], bias_ih_l{n}, bias_hh_l{n}; gate order i, f, g,
    o) and its uniform(-1/sqrt(H), 1/sqrt(H)) initialization."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__()
        H = hidden_size
        k = H ** -0.5
        for n in range(num_layers):
            in_dim = input_size if n == 0 else H
            for name, shape in ((f"weight_ih_l{n}", (4 * H, in_dim)),
                                (f"weight_hh_l{n}", (4 * H, H)),
                                (f"bias_ih_l{n}", (4 * H,)),
                                (f"bias_hh_l{n}", (4 * H,))):
                self.register_parameter(name, nn.Parameter(torch.empty(shape).uniform_(-k, k)))


class LSTMDecoder(nn.Module):
    """Latent sequence [B, T, L] + cond [B, C] -> scaled actions [B, T, 2].
    h0 of both layers = cond2hidden(cond), c0 = 0."""

    def __init__(self, latent_size: int = 4, hidden_size: int = 64,
                 cond_dim: int = 256, output_size: int = 2):
        super().__init__()
        self.cond2hidden = nn.Linear(cond_dim, hidden_size)
        self.lstm = _LSTMWeights(latent_size, hidden_size)
        self.hid2act = nn.Linear(hidden_size, output_size)

    def forward(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return fused_decode_actions(self, z, cond)


def decode_actions(decoder: LSTMDecoder, z: torch.Tensor, cond_feat: torch.Tensor):
    """Latents -> scaled actions through the kernel-backed decoder."""
    return fused_decode_actions(decoder, z, cond_feat)


def convert_action_to_state_and_action(
    actions: torch.Tensor,
    curr_states: torch.Tensor,
    dyn_params: UnicycleParams,
    normalizer: TrajNormalizer,
    dt: float = 0.1,
    scaled_input: bool = True,
    descaled_output: bool = False,
) -> torch.Tensor:
    """Integrate (scaled) actions through the unicycle into a (scaled)
    state+action trajectory. Handles [B, T, 2] and [B, N, T, 2]."""
    squeeze = None
    if actions.ndim == 4:
        B, N, T, _ = actions.shape
        actions = actions.reshape(B * N, T, -1)
        squeeze = (B, N, T)
    if scaled_input:
        actions = normalizer.descale(actions, [4, 5])
    states = unicycle_forward_dynamics(dyn_params, curr_states, actions, dt)
    out = torch.cat([states, actions], dim=-1)
    if scaled_input and not descaled_output:
        out = normalizer.scale(out)
    if squeeze is not None:
        out = out.reshape(*squeeze, -1)
    return out
