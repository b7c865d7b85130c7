"""The conditional LSTM-VAE, its model wrapper with the context encoder, the
loss and action integration (port of `cld_tpu/models/vae.py` and
`cld_tpu/models/lstm.py`).

The modules hold the reference torch key layout (`context_encoder.*`,
`lstmvae.lstm_enc.*`, `lstmvae.lstm_dec.*`, `lstmvae.mu`, `lstmvae.logvar`;
each LSTM stack is cond2hidden plus a 2-layer fused-gate LSTM), so converted
JAX variables load ``strict=True``.

Two ways through an LSTM stack, as in the JAX package. The deterministic
decoder (sampling, guidance, PPO, evaluation) runs its sequential core through
the kernel-backed `ops.lstm_kernels.fused_decode_actions`. The encoder, and the
decoder in train mode with its inter-layer dropout, run layer by layer through
PyTorch's LSTM operator on the stored weights (`_lstm_stack`; cuDNN on the
card), which the JAX package likewise computes outside any hand-written
kernel.

Randomness is explicit: the reparametrization noise and the dropout keep-masks
are arguments, drawn from a `torch.Generator` when not given.

Mixed precision (`ops.precision`): `set_compute_dtype(model, torch.bfloat16)`
runs the context encoder, the LSTM stacks, the latent heads and the decoder
in bf16 over float32 parameters, as the JAX module's `dtype` does. The LSTM
stacks cast their weights and inputs to bf16 explicitly (cuDNN's bf16 LSTM
on the card), the fused decoder stores in bf16, and the loss terms are taken
in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.ops.dynamics import (
    UnicycleParams,
    convert_state_to_state_and_action,
    unicycle_forward_dynamics,
)
from cld_tpu_torch.ops.lstm_kernels import fused_decode_actions
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast, autocast_dtype, no_autocast


class _LSTMWeights(nn.Module):
    """Parameter store with torch.nn.LSTM's names (weight_ih_l{n} [4H, I],
    weight_hh_l{n} [4H, H], bias_ih_l{n}, bias_hh_l{n}; gate order i, f, g,
    o) and its uniform(-1/sqrt(H), 1/sqrt(H)) initialization."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__()
        H = hidden_size
        k = H ** -0.5
        self.num_layers = num_layers
        for n in range(num_layers):
            in_dim = input_size if n == 0 else H
            for name, shape in ((f"weight_ih_l{n}", (4 * H, in_dim)),
                                (f"weight_hh_l{n}", (4 * H, H)),
                                (f"bias_ih_l{n}", (4 * H,)),
                                (f"bias_hh_l{n}", (4 * H,))):
                self.register_parameter(name, nn.Parameter(torch.empty(shape).uniform_(-k, k)))


DROPOUT_RATE = 0.2  # between the two LSTM layers, train mode only


def dropout_keep_mask(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A {0, 1} keep-mask that keeps an element with probability
    1 - DROPOUT_RATE."""
    return (torch.rand(shape, generator=generator, device=device) >= DROPOUT_RATE).to(
        torch.float32)


def _lstm_stack(weights: _LSTMWeights, x: torch.Tensor, h0: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stack's LSTM layers (two, or one for the zoo's trajectory
    encoders) over x [B, T, I], each starting from hidden h0 [B, H] and a
    zero cell state -> [B, T, H]. `keep_mask` [B, T, H] is the inter-layer
    dropout: layer 0's output times the mask over the keep probability.
    Each layer is one call of PyTorch's LSTM operator on the
    stored weights (cuDNN on the card): `torch._VF.lstm`, the private
    function that `nn.LSTM.forward` calls, with that call's positional
    signature (input, hx, flat weights, has_biases, num_layers, dropout,
    train, bidirectional, batch_first), checked against torch 2.11 and 2.13.
    It is used because the `state_dict` keeps the reference's flat
    `weight_ih_l0 ...` names on a plain module and the mask goes between the
    layers; the four separate parameters make cuDNN re-pack them per call.

    Inside a bf16 autocast region the weights, x, h0 and each layer's input
    are cast to bf16 explicitly and the stack runs with autocast off (autocast
    would send the operator to float16); the output is bf16. Elsewhere the
    stack runs in the weights' dtype."""
    dt = autocast_dtype(x.device.type)
    if dt == torch.float32:
        dt = weights.weight_ih_l0.dtype
    with no_autocast(x.device.type):
        h0 = h0.to(dt)
        hx = (h0[None].contiguous(), torch.zeros_like(h0)[None])
        # the operator's train flag only tells cuDNN to keep what its backward needs
        # (there is no dropout inside a single layer)
        keep_for_backward = torch.is_grad_enabled()
        y = x.to(dt)
        for n in range(weights.num_layers):
            flat = [getattr(weights, f"{k}_l{n}").to(dt) for k in
                    ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            y = torch._VF.lstm(y.contiguous(), hx, flat, True, 1, 0.0, keep_for_backward, False,
                               True)[0]
            if n == 0 and keep_mask is not None:
                y = (y * (keep_mask / (1.0 - DROPOUT_RATE))).to(dt)
        return y


class LSTMEncoder(nn.Module):
    """Scaled trajectory [B, T, 6] + cond [B, C] -> hidden states [B, T, H]."""

    def __init__(self, input_size: int = 6, hidden_size: int = 64, cond_dim: int = 256,
                 num_layers: int = 2):
        super().__init__()
        self.cond2hidden = nn.Linear(cond_dim, hidden_size)
        self.lstm = _LSTMWeights(input_size, hidden_size, num_layers)

    def forward(self, x, cond, keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _lstm_stack(self.lstm, x, self.cond2hidden(cond), keep_mask)


class LSTMDecoder(nn.Module):
    """Latent sequence [B, T, L] + cond [B, C] -> scaled actions [B, T, 2]
    (in the compute dtype). h0 of both layers = cond2hidden(cond), c0 = 0.
    Without a dropout mask the core is the fused kernel-backed one; with
    `keep_mask` [B, T, H] (train mode) it runs layer by layer."""

    compute_dtype = torch.float32

    def __init__(self, latent_size: int = 4, hidden_size: int = 64,
                 cond_dim: int = 256, output_size: int = 2):
        super().__init__()
        self.cond2hidden = nn.Linear(cond_dim, hidden_size)
        self.lstm = _LSTMWeights(latent_size, hidden_size)
        self.hid2act = nn.Linear(hidden_size, output_size)

    def forward(self, z: torch.Tensor, cond: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with autocast(self.compute_dtype, z.device.type):
            if keep_mask is None:
                return fused_decode_actions(self, z, cond)
            return self.hid2act(_lstm_stack(self.lstm, z, self.cond2hidden(cond), keep_mask))


class LSTMVAE(nn.Module):
    """Conditional sequence VAE: a 2-layer LSTM encoder over the scaled
    [B, T, 6] trajectory, per-step latent heads mu / logvar [B, T, L], and the
    LSTM decoder back to [B, T, 2] actions.

    `train` turns the inter-layer dropout on, with `keep_masks` = (encoder
    mask, decoder mask), each [B, T, H], or drawn from `generator`. `noise`
    [B, T, L] is the reparametrization noise: zeros when None and no
    generator is given (z = mean), else drawn from `generator`. Under bf16
    compute mean and logvar come out in bf16 and z in float32."""

    compute_dtype = torch.float32

    def __init__(self, input_size: int = 6, hidden_size: int = 64, latent_size: int = 4,
                 cond_dim: int = 256, output_size: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        self.lstm_enc = LSTMEncoder(input_size, hidden_size, cond_dim)
        self.lstm_dec = LSTMDecoder(latent_size, hidden_size, cond_dim, output_size)
        self.mu = nn.Linear(hidden_size, latent_size)
        self.logvar = nn.Linear(hidden_size, latent_size)

    def traj2z(self, x, cond, train: bool = False, noise: Optional[torch.Tensor] = None,
               keep_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """-> (z, mean, logvar), each [B, T, L]."""
        if train and keep_mask is None:
            keep_mask = dropout_keep_mask((*x.shape[:2], self.hidden_size), generator, x.device)
        with autocast(self.compute_dtype, x.device.type):
            h = self.lstm_enc(x, cond, keep_mask if train else None)
            mean, logvar = self.mu(h), self.logvar(h)
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean if noise is None else mean + noise * torch.exp(0.5 * logvar)
        return z, mean, logvar

    def decode(self, z, cond, train: bool = False, keep_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        if train and keep_mask is None:
            keep_mask = dropout_keep_mask((*z.shape[:2], self.hidden_size), generator, z.device)
        return self.lstm_dec(z, cond, keep_mask if train else None)

    def forward(self, x, cond, train: bool = False, noise: Optional[torch.Tensor] = None,
                keep_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """-> (recon_actions [B, T, 2], mean, logvar)."""
        enc_mask, dec_mask = keep_masks if keep_masks is not None else (None, None)
        z, mean, logvar = self.traj2z(x, cond, train, noise, enc_mask, generator)
        return self.decode(z, cond, train, dec_mask, generator), mean, logvar


DECODE_IMPLS = ("auto", "kernel", "module")


def decode_actions(decoder: LSTMDecoder, z: torch.Tensor, cond_feat: torch.Tensor,
                   impl: str = "auto"):
    """Latents z [..., T, L] + cond_feat [..., C] -> scaled actions
    [..., T, 2]. `impl` "kernel" (and "auto") runs the kernel-backed core
    (`ops.lstm_kernels.fused_decode_actions`), "module" the decoder's
    layer-by-layer stack through PyTorch's LSTM operator (the JAX package's
    "pallas" and "flax"). Both are differentiable in z, cond_feat and the
    weights, run at the decoder's compute dtype and return at least float32."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r} (expected one of {DECODE_IMPLS})")
    with autocast(decoder.compute_dtype, z.device.type):
        if impl in ("auto", "kernel"):
            acts = fused_decode_actions(decoder, z, cond_feat)
        else:
            lead, (T, L) = z.shape[:-2], z.shape[-2:]
            y = _lstm_stack(decoder.lstm, z.reshape(-1, T, L),
                            decoder.cond2hidden(cond_feat.reshape(-1, cond_feat.shape[-1])))
            acts = decoder.hid2act(y).reshape(*lead, T, -1)
    return acts.to(torch.promote_types(acts.dtype, torch.float32))


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


def get_state_and_action_from_batch(batch: TrafficBatch, horizon: int = 52,
                                    dt: float = 0.1) -> torch.Tensor:
    """Ground-truth [B, T, 6] state+action by inverse unicycle dynamics."""
    traj_state = torch.cat(
        [batch.target_positions[:, :horizon], batch.target_yaws[:, :horizon]], dim=-1
    )
    return convert_state_to_state_and_action(traj_state, batch.curr_speed, dt)


def vae_loss(gt_scaled, recon_actions, mu, logvar, beta):
    """Action-MSE + beta * KLD / (B * T) -> (loss, recon, kld), in float32."""
    recon_actions, mu, logvar = (v.to(torch.float32) for v in (recon_actions, mu, logvar))
    recon = torch.mean((gt_scaled.to(torch.float32)[..., -2:] - recon_actions) ** 2)
    B, T, _ = mu.shape
    kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar)) / (B * T)
    return recon + beta * kld, recon, kld


class VaeModel(nn.Module):
    """The context encoder and the LSTM-VAE. Dynamics integration and
    normalization are parameter-free functions beside it. Its networks
    compute at the dtype `ops.precision.set_compute_dtype` gives them.

    Every method takes `train` as an argument (BatchNorm's batch statistics
    and the LSTM stacks' dropout), as the JAX module does; the module's
    `.training` flag is not read."""

    def __init__(self, raster_channels: int = 34, curr_state_feat_dim: int = 64,
                 map_feature_dim: int = 256, cond_feat_dim: int = 256,
                 vae_hidden_size: int = 64, vae_latent_size: int = 4, horizon: int = 52,
                 dt: float = 0.1, map_arch: str = "resnet18"):
        super().__init__()
        self.horizon, self.dt = horizon, dt
        self.context_encoder = ContextEncoder(raster_channels, curr_state_feat_dim,
                                              map_feature_dim, cond_feat_dim, map_arch)
        self.lstmvae = LSTMVAE(6, vae_hidden_size, vae_latent_size, cond_feat_dim, 2)

    def pre_vae(self, batch: TrafficBatch, train: bool = False):
        """-> (aux_info, gt_state_and_action_scaled, gt_state_and_action)."""
        aux_info = self.context_encoder(batch, train)
        sa = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        return aux_info, TrajNormalizer().scale(sa), sa

    def forward(self, batch: TrafficBatch, beta, train: bool = False,
                noise: Optional[torch.Tensor] = None,
                keep_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        aux_info, gt_scaled, _ = self.pre_vae(batch, train)
        recon_actions, mu, logvar = self.lstmvae(gt_scaled, aux_info["cond_feat"], train, noise,
                                                 keep_masks, generator)
        loss, recon, kld = vae_loss(gt_scaled, recon_actions, mu, logvar, beta)
        return {"loss": loss, "recon": recon, "kld": kld, "recon_actions": recon_actions,
                "aux_info": aux_info}

    def encode(self, batch: TrafficBatch, train: bool = False,
               noise: Optional[torch.Tensor] = None,
               keep_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """batch -> (z, mu, logvar, aux_info): the latent target of the
        diffusion stage."""
        aux_info, gt_scaled, _ = self.pre_vae(batch, train)
        z, mu, logvar = self.lstmvae.traj2z(gt_scaled, aux_info["cond_feat"], train, noise,
                                            keep_mask, generator)
        return z, mu, logvar, aux_info

    def decode(self, z, cond_feat, train: bool = False,
               keep_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Latents -> scaled action sequence."""
        return self.lstmvae.decode(z, cond_feat, train, keep_mask, generator)
