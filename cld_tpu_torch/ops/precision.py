"""Mixed precision of the networks: bfloat16 compute over float32 parameters.

Counterpart of the JAX package's `dtype` field on its flax modules
(`cld_tpu/training/state.py:resolve_compute_dtype`): parameters, optimizer
state, losses and the sampler's math stay float32; the network layers compute
in the module's `compute_dtype`. A module that carries `compute_dtype` runs its
forward under `autocast(self.compute_dtype, device_type)`, PyTorch's autocast
at bfloat16 (matmuls and convolutions in bf16; on the card the norms and the
softmax in f32) or nothing at all at float32, so the float32 path is exactly
the one without mixed precision. `set_compute_dtype` sets the attribute on
every submodule that has one. A module may also name parameters that the JAX
package creates in its compute dtype (`compute_dtype_params`: a flax
`self.param(..., self.dtype)`, such as the scene denoiser's `time_pos_emb`):
`set_compute_dtype` stores those in the compute dtype, so under bf16 they and
their optimizer moments are bf16, as in the JAX package.

Every trainer resolves `train.training.precision` to one compute dtype
(`training.state.resolve_compute_dtype`: "auto" is bf16 on the card and
float32 on the CPU) and gives it to the networks whose JAX counterparts take
the trainer's `dtype`; the others stay float32 (the `diff` algo of the zoo,
the scene model's conditioning encoder, the composers' own networks).

The LSTM paths (`ops.lstm_kernels.fused_decode_actions`,
`models.vae._lstm_stack`) follow the autocast region they are called in
(`autocast_dtype`) and cast explicitly: inside a bf16 region they store their
weights, inputs and sequences in bf16, as the JAX package's fused decoder
does on its accelerator.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype}: expected torch.float32 or torch.bfloat16")
    return dtype


def autocast(dtype: torch.dtype, device_type: str):
    """The network region of a module at compute dtype `dtype`: bf16
    autocast on `device_type`, or no context at float32."""
    if check_compute_dtype(dtype) == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=torch.bfloat16)


def autocast_dtype(device_type: str) -> torch.dtype:
    """bfloat16 inside a bf16 autocast region on `device_type`, else
    float32."""
    if torch.is_autocast_enabled(device_type) and (
            torch.get_autocast_dtype(device_type) == torch.bfloat16):
        return torch.bfloat16
    return torch.float32


def no_autocast(device_type: str):
    """Leave an autocast region on `device_type` (explicit dtypes inside)."""
    if torch.is_autocast_enabled(device_type):
        return torch.autocast(device_type, enabled=False)
    return contextlib.nullcontext()


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set `compute_dtype` on every submodule of `module` (itself included)
    that carries one, and store the parameters it names in
    `compute_dtype_params` in `dtype`; returns `module`. Call it before the
    optimizer is built, so that its moments take the parameters' dtypes."""
    check_compute_dtype(dtype)
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
            for name in getattr(m, "compute_dtype_params", ()):
                param = getattr(m, name)
                param.data = param.data.to(dtype)
    return module
