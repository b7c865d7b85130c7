"""JAX-package variables -> the port's state dicts.

The JAX package's flax variables, given as nested dicts of numpy arrays,
become reference-layout torch state dicts: the same key mapping as
`cld_tpu/utils/torch_export.py:43-240`, kept here as the port's own copy.
The port's modules use that layout, so the converted dicts load with
``strict=True`` (`load_vae_model`, `load_context_encoder`,
`load_lstm_decoder`, `load_temporal_unet`). Conventions:

* Dense kernel [in, out] -> Linear [out, in];
* flax Conv [k.., in, out] -> Conv1d/2d [out, in, k..]; flax ConvTranspose
  (k-flipped) -> ConvTranspose1d [in, out, k];
* per-gate flax `OptimizedLSTMCell` kernels -> fused-gate
  ``weight_ih_l{n}`` [4H, I] (gate order i, f, g, o); the single flax bias
  goes to ``bias_ih_l{n}``, ``bias_hh_l{n}`` is zero;
* ``batch_stats`` -> BatchNorm running stats (+ a zero
  ``num_batches_tracked``);
* a bfloat16 leaf (`ml_dtypes.bfloat16`, the dtype of a flax parameter made
  in a bf16 compute dtype) keeps its dtype and its bits: `export_*` give it
  back unchanged, and the loaders carry it into a `torch.bfloat16` tensor
  through its 16-bit pattern.

The zoo's models, the GAN, the EBM and the scene diffusion model keep the
flax module names instead (`export_flax` / `load_flax`): one walk over the
port module converts each flax leaf by the type of the module it lands in,
where attention kernels [D, H, hd] and [H, hd, D] flatten head-major onto
Linear layers.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.resnet import BatchNorm2d, ResNetTrunk
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.models.vae import LSTMEncoder

StateDict = Dict[str, np.ndarray]


def _np(v) -> np.ndarray:
    return np.asarray(v)


def _dense(p, key: str, out: StateDict):
    out[f"{key}.weight"] = _np(p["kernel"]).T.copy()
    if "bias" in p:
        out[f"{key}.bias"] = _np(p["bias"]).copy()


def _conv1d(p, key: str, out: StateDict):
    out[f"{key}.weight"] = _np(p["kernel"]).transpose(2, 1, 0).copy()  # [out, in, k]
    if "bias" in p:
        out[f"{key}.bias"] = _np(p["bias"]).copy()


def _conv2d(p, key: str, out: StateDict):
    out[f"{key}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1).copy()  # [out, in, kh, kw]
    if "bias" in p:
        out[f"{key}.bias"] = _np(p["bias"]).copy()


def _convtranspose1d(p, key: str, out: StateDict):
    out[f"{key}.weight"] = _np(p["kernel"])[::-1].transpose(1, 2, 0).copy()  # [in, out, k]
    out[f"{key}.bias"] = _np(p["bias"]).copy()


def _norm_affine(p, key: str, out: StateDict):
    out[f"{key}.weight"] = _np(p["scale"]).copy()
    out[f"{key}.bias"] = _np(p["bias"]).copy()


def _bn(p, stats, key: str, out: StateDict):
    _norm_affine(p, key, out)
    out[f"{key}.running_mean"] = _np(stats["mean"]).copy()
    out[f"{key}.running_var"] = _np(stats["var"]).copy()
    out[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _prefixed(out: StateDict, root: str) -> StateDict:
    return {f"{root}.{k}": v for k, v in out.items()} if root else out


def export_mlp(params: Dict[str, Any], root: str = "") -> StateDict:
    """`models.nets.MLP` params -> ``_model`` Sequential keys: [Linear,
    LayerNorm?, ReLU] per hidden layer, then the output Linear."""
    base = f"{root}._model" if root else "_model"
    hidden = sorted(int(m.group(1)) for k in params if (m := re.fullmatch(r"dense_(\d+)", k)))
    normalization = any(k.startswith("ln_") for k in params)
    stride = 3 if normalization else 2
    out: StateDict = {}
    for n in hidden:
        _dense(params[f"dense_{n}"], f"{base}.{n * stride}", out)
        if normalization:
            _norm_affine(params[f"ln_{n}"], f"{base}.{n * stride + 1}", out)
    _dense(params["dense_out"], f"{base}.{len(hidden) * stride}", out)
    return out


def _lstm_cell(cell, lstm_key: str, layer: int, out: StateDict):
    w_ih = np.concatenate([_np(cell[f"i{g}"]["kernel"]).T for g in "ifgo"], axis=0)
    w_hh = np.concatenate([_np(cell[f"h{g}"]["kernel"]).T for g in "ifgo"], axis=0)
    b = np.concatenate([_np(cell[f"h{g}"]["bias"]) for g in "ifgo"], axis=0)
    out[f"{lstm_key}.weight_ih_l{layer}"] = w_ih.copy()
    out[f"{lstm_key}.weight_hh_l{layer}"] = w_hh.copy()
    out[f"{lstm_key}.bias_ih_l{layer}"] = b.copy()
    out[f"{lstm_key}.bias_hh_l{layer}"] = np.zeros_like(b)


def _lstm_stack(stack, root: str, out: StateDict):
    _dense(stack["cond2hidden"], f"{root}.cond2hidden", out)
    layers = sorted(int(m.group(1)) for k in stack if (m := re.fullmatch(r"lstm_(\d+)", k)))
    for layer in layers:
        _lstm_cell(stack[f"lstm_{layer}"], f"{root}.lstm", layer, out)


def export_lstm_vae(params: Dict[str, Any], root: str = "lstmvae") -> StateDict:
    """`models.lstm.LSTMVAE` params -> reference ``LSTMVAE`` keys."""
    out: StateDict = {}
    _lstm_stack(params["lstm_enc"]["stack"], "lstm_enc", out)
    _lstm_stack(params["lstm_dec"]["stack"], "lstm_dec", out)
    _dense(params["lstm_dec"]["hid2act"], "lstm_dec.hid2act", out)
    _dense(params["mu"], "mu", out)
    _dense(params["logvar"], "logvar", out)
    return _prefixed(out, root)


def export_resnet(params: Dict[str, Any], stats: Dict[str, Any], root: str = "") -> StateDict:
    """`models.resnet.ResNetEncoder` variables (any arch, either head) ->
    torchvision-style keys; also the trunk of `RasterizedMapUNet`."""
    out: StateDict = {}
    _conv2d(params["conv1"], "conv1", out)
    _bn(params["bn1"], stats["bn1"], "bn1", out)
    block_re = re.compile(r"layer(\d+)_block(\d+)")
    for name in sorted(k for k in params if block_re.fullmatch(k)):
        stage, b = block_re.fullmatch(name).groups()
        troot = f"layer{stage}.{b}"
        bp, bs = params[name], stats[name]
        for c in (1, 2, 3):
            if f"conv{c}" not in bp:
                break
            _conv2d(bp[f"conv{c}"], f"{troot}.conv{c}", out)
            _bn(bp[f"bn{c}"], bs[f"bn{c}"], f"{troot}.bn{c}", out)
        if "downsample_conv" in bp:
            _conv2d(bp["downsample_conv"], f"{troot}.downsample.0", out)
            _bn(bp["downsample_bn"], bs["downsample_bn"], f"{troot}.downsample.1", out)
    if "spatial_softmax" in params:
        head = params["spatial_softmax"]
        if "kp_conv" in head:
            _conv2d(head["kp_conv"], "spatial_softmax.kp_conv", out)
        if "log_temperature" in head:
            out["spatial_softmax.log_temperature"] = _np(head["log_temperature"]).copy()
    if "fc" in params:
        _dense(params["fc"], "fc", out)
    return _prefixed(out, root)


def export_context_encoder(params: Dict[str, Any], stats: Dict[str, Any],
                           root: str = "context_encoder") -> StateDict:
    """Context encoder variables; the map trunk lands under
    ``map_encoder.encoder_heads.map_model``."""
    out: StateDict = {}
    out.update(export_mlp(params["agent_state_encoder"], "agent_state_encoder"))
    out.update(export_resnet(params["map_encoder"], stats["map_encoder"],
                             "map_encoder.encoder_heads.map_model"))
    out.update(export_mlp(params["process_cond_mlp"], "process_cond_mlp"))
    return _prefixed(out, root)


def _conv1dblock(p, root: str, out: StateDict):
    _conv1d(p["conv"], f"{root}.block.0", out)
    _norm_affine(p["norm"], f"{root}.block.2", out)


def _resblock(p, root: str, out: StateDict):
    _conv1dblock(p["block0"], f"{root}.blocks.0", out)
    _conv1dblock(p["block1"], f"{root}.blocks.1", out)
    _dense(p["time_dense"], f"{root}.time_mlp.1", out)
    if "residual_conv" in p:
        _conv1d(p["residual_conv"], f"{root}.residual_conv", out)


def export_temporal_unet(params: Dict[str, Any], root: str = "model") -> StateDict:
    """`models.temporal_unet.TemporalMapUnet` params -> reference keys."""
    out: StateDict = {}
    _dense(params["time_dense0"], "time_mlp.1", out)
    _dense(params["time_dense1"], "time_mlp.3", out)
    n_down = 1 + max((int(m.group(1)) for k in params
                      if (m := re.match(r"down(\d+)_res0", k))), default=-1)
    for i in range(n_down):
        _resblock(params[f"down{i}_res0"], f"downs.{i}.0", out)
        _resblock(params[f"down{i}_res1"], f"downs.{i}.1", out)
        if f"down{i}_downsample" in params:
            _conv1d(params[f"down{i}_downsample"]["Conv_0"], f"downs.{i}.2.conv", out)
    _resblock(params["mid_res0"], "mid_block1", out)
    _resblock(params["mid_res1"], "mid_block2", out)
    n_up = 1 + max((int(m.group(1)) for k in params
                    if (m := re.match(r"up(\d+)_res0", k))), default=-1)
    for i in range(n_up):
        _resblock(params[f"up{i}_res0"], f"ups.{i}.0", out)
        _resblock(params[f"up{i}_res1"], f"ups.{i}.1", out)
        if f"up{i}_upsample" in params:
            _convtranspose1d(params[f"up{i}_upsample"]["ConvTranspose_0"],
                             f"ups.{i}.2.conv", out)
    _conv1dblock(params["final_block"], "final_conv.0", out)
    _conv1d(params["final_conv"], "final_conv.1", out)
    return _prefixed(out, root)


def export_vae_checkpoint(variables: Dict[str, Any], prefix: str = "vae") -> StateDict:
    """`VaeModel` variables {"params", "batch_stats"} -> ``vae.``-prefixed
    state dict."""
    if "batch_stats" not in variables:
        raise ValueError("vae export requires batch_stats (the context "
                         "encoder's BatchNorm running stats)")
    params, stats = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    out.update(export_context_encoder(params["context_encoder"], stats["context_encoder"]))
    out.update(export_lstm_vae(params["lstmvae"]))
    return _prefixed(out, prefix)


def export_dm_checkpoint(variables: Dict[str, Any], prefix: str = "dm") -> StateDict:
    """`TemporalMapUnet` variables -> ``dm.model.``-prefixed state dict."""
    return _prefixed(export_temporal_unet(variables["params"], root="model"), prefix)


def _tensor(v) -> torch.Tensor:
    """A numpy leaf as a tensor; a bfloat16 leaf bit for bit (numpy knows
    the dtype only through `ml_dtypes`, which `torch.as_tensor` refuses)."""
    v = np.ascontiguousarray(v)
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.as_tensor(v)


def _load(module: torch.nn.Module, sd: StateDict, prefix: str) -> torch.nn.Module:
    sub = {k[len(prefix):]: _tensor(v) for k, v in sd.items() if k.startswith(prefix)}
    ref = next(module.parameters())
    sub = {k: v.to(ref.device) for k, v in sub.items()}
    module.load_state_dict(sub, strict=True)
    return module


def load_vae_model(module, vae_variables: Dict[str, Any]):
    """Load `VaeModel` variables {"params", "batch_stats"} into the port's
    whole `VaeModel`: context encoder with its BatchNorm statistics, LSTM
    encoder and decoder, `mu` and `logvar`."""
    return _load(module, export_vae_checkpoint(vae_variables), "vae.")


def load_context_encoder(module, vae_variables: Dict[str, Any]):
    """Load `VaeModel` variables' context encoder into `ContextEncoder`."""
    return _load(module, export_vae_checkpoint(vae_variables), "vae.context_encoder.")


def load_lstm_decoder(module, vae_variables: Dict[str, Any]):
    """Load `VaeModel` variables' LSTM decoder into `LSTMDecoder`."""
    return _load(module, export_vae_checkpoint(vae_variables), "vae.lstmvae.lstm_dec.")


def load_temporal_unet(module, unet_variables: Dict[str, Any]):
    """Load `TemporalMapUnet` variables ({"params": ...}) into the port's."""
    return _load(module, export_dm_checkpoint(unet_variables), "dm.model.")


def load_state_dicts(context, decoder, unet, sd: StateDict):
    """Load one flat converted state dict (the union of
    `export_vae_checkpoint` and `export_dm_checkpoint`, e.g. read back from
    an .npz) into the port's `ContextEncoder`, `LSTMDecoder` and
    `TemporalMapUnet`, each ``strict=True``."""
    _load(context, sd, "vae.context_encoder.")
    _load(decoder, sd, "vae.lstmvae.lstm_dec.")
    _load(unet, sd, "dm.model.")


# -- the zoo: one walk over flax-named modules -------------------------------

_TRUNK_CHILDREN = {"conv1", "bn1", "layer1", "layer2", "layer3", "layer4", "fc",
                   "spatial_softmax"}


def _has_state(module: nn.Module) -> bool:
    return any(True for _ in module.parameters()) or any(True for _ in module.buffers())


def _walk(m: nn.Module, p, s, root: str, out: StateDict) -> None:
    def key(name):
        return f"{root}.{name}" if root else name

    # modules in the reference's key layout keep their hand mappings
    if isinstance(m, ContextEncoder):
        out.update(export_context_encoder(p, s, root))
        return
    if isinstance(m, MLP):
        out.update(export_mlp(p, root))
        return
    if isinstance(m, TemporalMapUnet):
        out.update(export_temporal_unet(p, root))
        return
    if isinstance(m, LSTMEncoder):
        _lstm_stack(p["stack"], root, out)
        return
    if isinstance(m, nn.Linear):  # Dense, or an attention DenseGeneral flattened
        out[key("weight")] = _np(p["kernel"]).reshape(m.in_features, m.out_features).T.copy()
        if m.bias is not None:
            out[key("bias")] = _np(p["bias"]).reshape(-1).copy()
        return
    if isinstance(m, nn.Conv2d):
        _conv2d(p, root, out)
        return
    if isinstance(m, nn.Conv1d):
        _conv1d(p, root, out)
        return
    if isinstance(m, BatchNorm2d):
        _bn(p, s, root, out)
        return
    if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
        _norm_affine(p, root, out)
        return
    skip = set()
    if isinstance(m, ResNetTrunk):  # torchvision keys for the trunk and its head
        out.update(export_resnet(p, s, root))
        skip = _TRUNK_CHILDREN
    for name, param in m.named_parameters(recurse=False):
        out[key(name)] = _np(p[name]).copy()
    for name, child in m.named_children():
        if name in skip or not _has_state(child):
            continue
        if isinstance(child, nn.ModuleList):  # a flax setup list: name_0, name_1, ...
            for i, sub in enumerate(child):
                _walk(sub, p[f"{name}_{i}"], s.get(f"{name}_{i}", {}), key(f"{name}.{i}"), out)
        else:
            _walk(child, p[name], s.get(name, {}), key(name), out)


def export_flax(module: nn.Module, params: Dict[str, Any],
                stats: Dict[str, Any] = None) -> StateDict:
    """A zoo model's flax `params` / `batch_stats` -> the port module's state
    dict. The walk follows the port module: a submodule named as the flax
    one (`Dense_0`, `MLP_0`, `posteriors` for flax's `posteriors_0`, ...)
    takes that subtree, converted by its type (Dense kernels transposed,
    attention kernels flattened head-major, Conv HWIO -> OIHW, BatchNorm and
    LayerNorm / GroupNorm `scale` / `bias` and statistics); the context
    encoder, MLPs, ResNet trunks, LSTM stacks and the temporal UNet keep the
    reference layout of the exporters above."""
    out: StateDict = {}
    _walk(module, params, stats or {}, "", out)
    return out


def load_flax(module: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load flax variables {"params", "batch_stats"?} into a zoo model (or
    `MLPResDenoiser`, a `ResNetEncoder`, `PermuteEBM`, `TrajectoryGAN` with
    either generator, `SceneDMModel` or one of its parts), ``strict=True``."""
    return _load(module, export_flax(module, variables["params"], variables.get("batch_stats")),
                 "")
