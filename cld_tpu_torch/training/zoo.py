"""Algo factory and the generic zoo trainer (port of
`cld_tpu/training/zoo.py`).

`algo_factory(config, name)` resolves one of the eleven baseline algos to a
spec: how to build its network, how to compute its loss, and which random
draws a train step takes. `ZooTrainer` is the one loop they share: loss,
backward, Adam with coupled L2 at `optim_params.vae`'s constant rate, and
the non-finite guard. The networks compute at `train.training.precision`
(`state.resolve_compute_dtype`: bf16 under "auto" on the card, float32 on
the CPU) over float32 parameters, Adam moments and BatchNorm statistics, as
the JAX factory passes `dtype` to ten of the algos; `diff` builds its context
encoder and UNet without it there, so it stays float32 under every
precision (`AlgoSpec.takes_dtype`). TransformerPred stores its two learned
embeddings in the compute dtype, as the JAX module does.

Randomness is explicit: a step's draws (`noise`, a dict whose keys the spec
names) are arguments, drawn from a `torch.Generator` when not given. The
algos that draw: `vae` {"noise": [B, 16]}, `discrete_vae` {"uniform":
[B, 8] in [1e-9, 1)}, `tree_vae` {"noise": [stages, B, 4]} and `diff`
{"t": [B], "noise": [B, T, 2], "drop": [B] bool}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import TrainState, make_optimizer, resolve_compute_dtype
from cld_tpu_torch.training.vae import raster_channels

Noise = Dict[str, torch.Tensor]
ALGO_FACTORY: Dict[str, Callable] = {}
CVAE_LATENT = 16  # TrajectoryCVAE's latent_dim (the JAX module's default)
DISCRETE_MODES = 8  # DiscreteTrajectoryCVAE's num_modes
TREE_LATENT = 4  # TreeTrajectoryVAE's latent_dim


@dataclasses.dataclass
class AlgoSpec:
    """`build()` -> a fresh network (on the CPU); `loss_call(model, batch,
    train, noise)` -> (loss, metrics); `draw(batch, generator)` -> the step's
    random draws ({} for a deterministic algo); `takes_dtype`: the network
    computes at the trainer's precision (False: float32 always)."""

    build: Callable[[], nn.Module]
    loss_call: Callable[[nn.Module, TrafficBatch, bool, Noise], Tuple[torch.Tensor, dict]]
    draw: Callable[[TrafficBatch, Optional[torch.Generator]], Noise] = lambda batch, gen: {}
    takes_dtype: bool = True


def register_algo(name: str):
    def deco(fn):
        ALGO_FACTORY[name] = fn
        return fn

    return deco


def algo_factory(config, name: str) -> AlgoSpec:
    """Resolve an algo name to its spec."""
    if name not in ALGO_FACTORY:
        raise KeyError(f"unknown algo {name!r}; registered: {sorted(ALGO_FACTORY)}")
    return ALGO_FACTORY[name](config)


def _dims(cfg) -> dict:
    return dict(raster_channels=raster_channels(cfg), horizon=cfg.algo.horizon,
                dt=cfg.algo.step_time, cond_feat_dim=cfg.algo.cond_feat_dim,
                map_arch=cfg.algo.map_encoder_model_arch)


def _plain_arch(cfg) -> str:
    """The map encoder's arch without a pooling suffix (the UNet, ROI and
    tree models take the trunk only)."""
    return cfg.algo.map_encoder_model_arch.split("_spatial")[0]


def _scalars(out: dict) -> dict:
    return {k: v for k, v in out.items() if torch.is_tensor(v) and v.ndim == 0}


def _method_loss(model, batch, train, noise):
    out = model.loss(batch, train)
    return out["loss"], {"loss": out["loss"]}


def _method_loss_scalars(model, batch, train, noise):
    out = model.loss(batch, train)
    return out["loss"], _scalars(out)


def _call_scalars(model, batch, train, noise):
    out = model(batch, train)
    return out["loss"], _scalars(out)


@register_algo("bc")
def _bc(cfg):
    """BehaviorCloning."""
    from cld_tpu_torch.models.bc import BCPlanner

    return AlgoSpec(lambda: BCPlanner(**_dims(cfg)), _method_loss)


@register_algo("bc_gc")
def _bc_gc(cfg):
    """BehaviorCloningGC: BCPlanner with the teacher-forced goal feature."""
    from cld_tpu_torch.models.bc import BCPlanner

    return AlgoSpec(lambda: BCPlanner(goal_conditional=True, **_dims(cfg)), _method_loss)


@register_algo("vae")
def _vae(cfg):
    """VAETrafficModel: the single-latent CVAE baseline."""
    from cld_tpu_torch.models.cvae import TrajectoryCVAE

    beta = cfg.algo.get("vae_beta", 0.1)

    def loss_call(model, batch, train, noise):
        out = model(batch, beta, train, noise=noise.get("noise"))
        return out["loss"], {"loss": out["loss"], "recon": out["recon"], "kld": out["kld"]}

    def draw(batch, gen):
        return {"noise": torch.randn((batch.batch_size, CVAE_LATENT), generator=gen,
                                     device=batch.image.device)}

    return AlgoSpec(lambda: TrajectoryCVAE(**_dims(cfg)), loss_call, draw)


@register_algo("discrete_vae")
def _discrete_vae(cfg):
    """DiscreteVAETrafficModel: the Gumbel-softmax discrete CVAE."""
    from cld_tpu_torch.models.discrete_cvae import GUMBEL_UNIFORM_LOW, DiscreteTrajectoryCVAE

    def loss_call(model, batch, train, noise):
        out = model(batch, train=train, uniform=noise.get("uniform"))
        return out["loss"], {"loss": out["loss"], "recon": out["recon"], "kld": out["kld"]}

    def draw(batch, gen):
        u = torch.rand((batch.batch_size, DISCRETE_MODES), generator=gen,
                       device=batch.image.device)
        return {"uniform": GUMBEL_UNIFORM_LOW + (1.0 - GUMBEL_UNIFORM_LOW) * u}

    return AlgoSpec(lambda: DiscreteTrajectoryCVAE(num_modes=DISCRETE_MODES, **_dims(cfg)),
                    loss_call, draw)


@register_algo("TransformerPred")
def _transformer(cfg):
    """TransformerTrafficModel."""
    from cld_tpu_torch.models.transformer_baseline import TransformerTrajectoryPredictor

    return AlgoSpec(lambda: TransformerTrajectoryPredictor(
        hist_len=cfg.algo.history_num_frames + 1, horizon=cfg.algo.horizon,
        width=cfg.algo.get("transformer_width", 64), dt=cfg.algo.step_time), _method_loss)


@register_algo("tree_vae")
def _tree_vae(cfg):
    """TreeVAETrafficModel: the staged trajectory-tree CVAE."""
    from cld_tpu_torch.models.tree_vae import TreeTrajectoryVAE

    stages = cfg.algo.get("tree_stages", 2)

    def build():
        return TreeTrajectoryVAE(
            raster_channels(cfg), stages=stages,
            frames_per_stage=cfg.algo.get("tree_frames_per_stage", 10),
            cond_feat_dim=cfg.algo.cond_feat_dim, map_arch=_plain_arch(cfg),
            dt=cfg.algo.step_time)

    def loss_call(model, batch, train, noise):
        out = model(batch, train, noise=noise.get("noise"))
        return out["loss"], {"loss": out["loss"], "recon": out["recon"], "kld": out["kld"]}

    def draw(batch, gen):
        return {"noise": torch.randn((stages, batch.batch_size, TREE_LATENT), generator=gen,
                                     device=batch.image.device)}

    return AlgoSpec(build, loss_call, draw)


def _agent_predictor_spec(cfg, ec_conditioning: bool) -> AlgoSpec:
    from cld_tpu_torch.models.agent_predictor import MAAgentPredictor
    from cld_tpu_torch.ops.dynamics import UnicycleParams

    def build():
        return MAAgentPredictor(
            raster_channels(cfg), horizon=cfg.algo.horizon, dt=cfg.algo.step_time,
            cond_feat_dim=cfg.algo.cond_feat_dim, map_arch=_plain_arch(cfg),
            ec_conditioning=ec_conditioning,
            dyn=UnicycleParams.from_config(cfg.algo.dynamics),
            pixel_size=cfg.env.rasterizer.pixel_size)

    return AlgoSpec(build, _method_loss_scalars)


@register_algo("agent_predictor")
def _agent_predictor(cfg):
    """MATrafficModel: ego + neighbor prediction from one shared raster."""
    return _agent_predictor_spec(cfg, False)


@register_algo("bc_ec")
def _bc_ec(cfg):
    """BehaviorCloningEC: the agent predictor with ego-conditioned neighbor
    heads."""
    return _agent_predictor_spec(cfg, True)


@register_algo("spatial_planner")
def _spatial_planner(cfg):
    """SpatialPlanner: dense goal-location prediction over the raster."""
    from cld_tpu_torch.models.spatial_planner import SpatialPlannerNet

    return AlgoSpec(lambda: SpatialPlannerNet(raster_channels(cfg), _plain_arch(cfg)),
                    _call_scalars)


@register_algo("occupancy")
def _occupancy(cfg):
    """OccupancyMetric: per-future-frame occupancy maps from the map UNet."""
    from cld_tpu_torch.models.occupancy import OccupancyPredictor

    return AlgoSpec(lambda: OccupancyPredictor(
        raster_channels(cfg), _plain_arch(cfg), future_num_frames=cfg.algo.future_num_frames,
        every_n_frame=cfg.algo.get("occupancy_every_n_frame", 4)), _call_scalars)


class RawDiffuserModel(nn.Module):
    """The `diff` algo's network: a context encoder and a temporal UNet
    (6 -> 2 channels) trained with `RawActionDiffuser`'s loss. Submodule
    names follow the JAX module's (`ContextEncoder_0`,
    `TemporalMapUnet_0`)."""

    def __init__(self, cfg):
        super().__init__()
        from cld_tpu_torch.models.context import ContextEncoder
        from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
        from cld_tpu_torch.ops.dynamics import UnicycleParams

        algo = cfg.algo
        self.horizon, self.dt = algo.horizon, algo.step_time
        self.n_diffusion_steps = algo.n_diffusion_steps
        self.dyn = UnicycleParams.from_config(algo.dynamics)
        self.ContextEncoder_0 = ContextEncoder(
            raster_channels(cfg), algo.curr_state_feat_dim, algo.map_feature_dim,
            algo.cond_feat_dim, algo.map_encoder_model_arch)
        self.TemporalMapUnet_0 = TemporalMapUnet(6, 2, algo.cond_feat_dim, algo.base_dim,
                                                 (2, 4, 8))
        self._schedules = {}

    def diffuser(self, device):
        from cld_tpu_torch.algos.diffuser import RawActionDiffuser
        from cld_tpu_torch.ops.diffusion import make_schedule

        key = str(device)
        if key not in self._schedules:
            self._schedules[key] = make_schedule(self.n_diffusion_steps, device=device)
        return RawActionDiffuser(self.TemporalMapUnet_0, self._schedules[key], self.dyn,
                                 dt=self.dt)

    def forward(self, batch: TrafficBatch, train: bool = False, t=None, noise=None, drop=None,
                generator: Optional[torch.Generator] = None):
        from cld_tpu_torch.models.vae import get_state_and_action_from_batch
        from cld_tpu_torch.ops.normalization import TrajNormalizer

        aux = self.ContextEncoder_0(batch, train)
        gt = TrajNormalizer().scale(get_state_and_action_from_batch(batch, self.horizon, self.dt))
        loss = self.diffuser(gt.device).loss(gt, get_current_states(batch), aux["cond_feat"],
                                             t, noise, drop, generator=generator)
        return {"loss": loss}


@register_algo("diff")
def _diff(cfg):
    """DiffuserTrafficModel: the CTG raw-action diffusion, float32 under
    every precision (the JAX factory gives its networks no `dtype`)."""

    def loss_call(model, batch, train, noise):
        out = model(batch, train, **noise)
        return out["loss"], {"loss": out["loss"]}

    from cld_tpu_torch.algos.diffuser import draw_loss_noise

    def draw(batch, gen):
        t, noise, drop = draw_loss_noise(cfg.algo.n_diffusion_steps, batch.batch_size,
                                         cfg.algo.horizon, generator=gen,
                                         device=batch.image.device)
        return {"t": t, "noise": noise, "drop": drop}

    return AlgoSpec(lambda: RawDiffuserModel(cfg), loss_call, draw, takes_dtype=False)


class ZooTrainer:
    """One trainer for every factory algo. `compute_dtype` is the network's
    (float32 for an algo whose spec does not take the precision)."""

    def __init__(self, config, algo_name: str, device="cuda"):
        self.spec = algo_factory(config, algo_name)
        self.device = torch.device(device)
        self.compute_dtype = torch.float32
        if self.spec.takes_dtype:
            self.compute_dtype = resolve_compute_dtype(
                config.train.training.get("precision", "auto"), self.device)
        opt = config.algo.optim_params.vae
        self.lr = opt.learning_rate.initial
        self.weight_decay = opt.regularization.L2

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh network (torch's default initializers under `seed`) at the
        trainer's compute dtype, with its optimizer at step 0, at the
        constant rate."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = set_compute_dtype(self.spec.build().to(self.device), self.compute_dtype)
        lr = self.lr
        return TrainState(model, make_optimizer(model.parameters(), self.weight_decay),
                          lambda step: lr)

    def train_step(self, state: TrainState, batch: TrafficBatch, noise: Optional[Noise] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, object]]:
        """One update in place: the loss in train mode (BatchNorm on batch
        statistics), backward, one optimizer update. `noise` is the step's
        draws, taken from `generator` (the default generator when None) if not
        given. A non-finite loss skips the update: parameters, optimizer
        moments, BatchNorm statistics and the step count stay as they were,
        and `skipped_nonfinite` is 1 (one scalar read on the host)."""
        model = state.model
        if noise is None:
            noise = self.spec.draw(batch, generator)
        buffers = [b.clone() for b in model.buffers()]
        loss, metrics = self.spec.loss_call(model, batch, True, noise)
        loss.backward()
        ok = state.loss_is_finite(loss)
        if ok:
            state.apply_gradients()
        else:
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, old in zip(model.buffers(), buffers):
                    b.copy_(old)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped_nonfinite"] = float(not ok)
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: TrafficBatch, noise: Optional[Noise] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The metrics with `train=False` (running BatchNorm statistics, the
        discrete CVAE's argmax mode). The draws of the algos that take them
        come from `noise`, else `generator`, else a generator seeded 0, as
        the JAX trainer evaluates under key 0."""
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            noise = self.spec.draw(batch, generator)
        return self.spec.loss_call(state.model, batch, False, noise)[1]
