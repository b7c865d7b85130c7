"""Reference torch checkpoints -> the port's modules (counterpart of
`cld_tpu/utils/torch_import.py`).

The reference's Lightning trainers save the VAE under ``vae.``
(`vae_trainer.py:17`) and the DM stage's denoiser under ``dm.model.``
beside its frozen VAE under ``vae.`` (`dm_trainer.py:23,40`). The port's
modules hold the reference's `state_dict` layout, so importing one is a
prefix strip and a ``strict=True`` load: `load_vae_model`,
`load_context_encoder`, `load_lstm_decoder` and `load_temporal_unet` take a
reference-layout state dict (prefixes included). The one renaming is the
ResNet trunk: a raw ``RasterizedMapEncoder`` keeps it under
``map_encoder.map_model``, the port (like the reference's feature-extractor
wrapper) under ``map_encoder.encoder_heads.map_model`` (`find_resnet_root`).

CLI: ``python -m cld_tpu_torch.utils.torch_import --ckpt iter.ckpt --kind vae
--out runs/imported_vae`` writes the port's own checkpoint format
(`training.checkpoints.save_pytree`, ``{"params": state_dict}``), which the
``--vae-ckpt`` / ``--dm-ckpt`` flags of ``python -m cld_tpu_torch.train`` and
``python -m cld_tpu_torch.rollout`` read.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Optional

import torch

StateDict = Dict[str, torch.Tensor]

# where the port's context encoder keeps its ResNet trunk
PORT_RESNET_ROOT = "map_encoder.encoder_heads.map_model"


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # A Lightning checkpoint also pickles its hyper-parameters and loop
        # state as Python objects, which the weights-only unpickler refuses;
        # such a file is read with the full unpickler (trusted files only).
        return torch.load(path, map_location="cpu", weights_only=False)


def _weights(obj) -> StateDict:
    """Lightning checkpoints keep the weights under ``"state_dict"``; a bare
    ``torch.save(model.state_dict())`` file is the dict itself."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_state_dict_file(path: str) -> StateDict:
    """Read a torch ``.ckpt`` / ``.pt`` file -> its state dict of CPU tensors
    (Lightning or bare)."""
    return _weights(_torch_load(path))


def submap(sd: StateDict, prefix: str) -> StateDict:
    """Keys under `prefix` with the prefix stripped (`trainer_utils.py:30-39`)."""
    if prefix and not prefix.endswith("."):
        prefix += "."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def find_resnet_root(sd: StateDict, under: str = "map_encoder") -> str:
    """The key root of the torchvision-style trunk inside a context encoder's
    state dict: ``map_encoder.encoder_heads.map_model`` or a raw
    ``map_encoder.map_model``."""
    for k, v in sd.items():
        if not k.startswith(under):
            continue
        m = re.fullmatch(r"(.*)\.conv1\.weight", k)
        if m and "layer" not in m.group(1) and v.ndim == 4:
            return m.group(1)
    raise KeyError(f"no ResNet trunk found under '{under}'")


def _context_keys(sd: StateDict) -> StateDict:
    """A context encoder's state dict with its trunk under the port's root."""
    root = find_resnet_root(sd)
    if root == PORT_RESNET_ROOT:
        return sd
    return {(PORT_RESNET_ROOT + k[len(root):] if k.startswith(root + ".") else k): v
            for k, v in sd.items()}


def _load(module: torch.nn.Module, sd: StateDict) -> torch.nn.Module:
    device = next(module.parameters()).device
    module.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return module


def vae_state_dict(sd: StateDict, prefix: str = "vae") -> StateDict:
    """The `VaeModel` keys of a reference-layout state dict (``vae.``
    stripped, the trunk re-rooted)."""
    sub = submap(sd, prefix) if prefix else sd
    ctx = _context_keys(submap(sub, "context_encoder"))
    rest = {k: v for k, v in sub.items() if not k.startswith("context_encoder.")}
    return {**{f"context_encoder.{k}": v for k, v in ctx.items()}, **rest}


def load_vae_model(module, sd: StateDict, prefix: str = "vae"):
    """The whole `VaeModel` (context encoder with its BatchNorm statistics,
    LSTM encoder and decoder, `mu`, `logvar`) from the ``vae.`` keys."""
    return _load(module, vae_state_dict(sd, prefix))


def load_context_encoder(module, sd: StateDict, prefix: str = "vae"):
    """`ContextEncoder` from the ``vae.context_encoder.`` keys."""
    return _load(module, submap(vae_state_dict(sd, prefix), "context_encoder"))


def load_lstm_decoder(module, sd: StateDict, prefix: str = "vae"):
    """`LSTMDecoder` from the ``vae.lstmvae.lstm_dec.`` keys."""
    return _load(module, submap(sd, f"{prefix}.lstmvae.lstm_dec" if prefix
                                else "lstmvae.lstm_dec"))


def load_temporal_unet(module, sd: StateDict, prefix: str = "dm.model"):
    """`TemporalMapUnet` from the ``dm.model.`` keys (``prefix=""``: a bare
    `TemporalMapUnet` state dict)."""
    return _load(module, submap(sd, prefix) if prefix else sd)


def module_state_dict(sd: StateDict, kind: str) -> StateDict:
    """A reference-layout state dict -> the state dict of the port's module
    of `kind`: vae (a `VaeModel`), dm (the ``dm.model.`` denoiser) or unet (a
    bare `TemporalMapUnet` state dict, returned as it is). Raises when the
    file holds no weights of that kind."""
    if kind == "vae":
        out = vae_state_dict(sd) if any(k.startswith("vae.") for k in sd) else {}
    elif kind == "dm":
        out = submap(sd, "dm.model")
    elif kind == "unet":
        out = dict(sd)
    else:
        raise ValueError(f"unknown kind '{kind}' (expected vae|dm|unet)")
    if not out:
        raise ValueError(f"the checkpoint holds no '{kind}' weights")
    return out


def read_checkpoint(path: str, kind: str) -> StateDict:
    """The state dict of the port's module of `kind` (see
    `module_state_dict`) from a checkpoint file: the port's own format
    (``{"params": state_dict}``: a trainer stage's ``ckpt_final`` or this
    module's CLI output), or a reference Lightning or bare state-dict file."""
    obj = _torch_load(path)
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict):
        return dict(obj["params"])
    return module_state_dict(_weights(obj), kind)


def main(argv: Optional[list] = None) -> None:
    import argparse

    from cld_tpu_torch.training.checkpoints import save_pytree

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="reference .ckpt / .pt file")
    ap.add_argument("--kind", required=True, choices=["vae", "dm", "unet"])
    ap.add_argument("--out", required=True, help="output file (the port's ckpt_final format)")
    args = ap.parse_args(argv)

    sd = module_state_dict(load_state_dict_file(args.ckpt), args.kind)
    save_pytree(args.out, {"params": sd})
    n = sum(int(v.numel()) for v in sd.values())
    print(f"imported {args.kind} checkpoint -> {args.out} ({n} scalars)")


if __name__ == "__main__":
    main()
