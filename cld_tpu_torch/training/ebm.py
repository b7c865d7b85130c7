"""EBM learned-metric trainer (port of `cld_tpu/training/ebm.py`): trains
`PermuteEBM` with the InfoNCE permutation objective, so that its
matched-pair score becomes the learned closed-loop realism metric
(`sim.learned_metrics`, the rollout CLI's `--ebm-ckpt`). Adam with the VAE
stage's coupled L2 at its constant initial rate; a step that gives a
non-finite loss is skipped. The networks compute at
`train.training.precision` (`state.resolve_compute_dtype`: bf16 under
"auto" on the card, float32 on the CPU) over float32 parameters and Adam
moments; InfoNCE is float32. The rollout CLI's `--ebm-ckpt` scores through
this trainer, so its metric follows the same precision.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.learned_metric import PermuteEBM, ebm_infonce_loss
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training.state import TrainState, make_optimizer, resolve_compute_dtype
from cld_tpu_torch.training.vae import raster_channels


class EBMTrainer:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(
            config.train.training.get("precision", "auto"), self.device)
        opt = config.algo.optim_params.vae  # the VAE stage's optimizer group
        self.lr = opt.learning_rate.initial
        self.weight_decay = opt.regularization.L2

    def build(self) -> PermuteEBM:
        """The EBM at the config's widths: trajectory features as wide as
        the map's, embeddings as wide as `cond_feat_dim`."""
        algo = self.config.algo
        return set_compute_dtype(
            PermuteEBM(raster_channels(self.config), algo.map_encoder_model_arch,
                       map_feature_dim=algo.map_feature_dim,
                       traj_feature_dim=algo.map_feature_dim,
                       embedding_dim=algo.cond_feat_dim),
            self.compute_dtype)

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh EBM (torch's default initializers under `seed`) with its
        optimizer at step 0, at the constant rate."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = self.build().to(self.device)
        lr = self.lr
        return TrainState(model, make_optimizer(model.parameters(), self.weight_decay),
                          lambda step: lr)

    def train_step(self, state: TrainState, batch: TrafficBatch
                   ) -> Tuple[TrainState, Dict[str, object]]:
        """One update in place: the score matrix in train mode (BatchNorm on
        batch statistics), InfoNCE, backward, one optimizer update. A
        non-finite loss skips the update (parameters, moments, BatchNorm
        statistics and the step stay; one scalar read on the host).
        `infonce_acc` is the share of maps whose own trajectory scores
        highest. Under data parallelism a rank scores its maps against every
        rank's trajectories, so the mean of the ranks' losses is the global
        batch's InfoNCE."""
        model, mesh = state.model, state.mesh
        buffers = [b.clone() for b in model.buffers()]
        scores = model(batch, train=True, mesh=mesh)["scores"]
        rows = scores.shape[0]
        labels = torch.arange(rows, device=scores.device)
        if mesh is not None:
            labels = labels + mesh.rank * rows  # this rank's columns of the global batch
        loss = ebm_infonce_loss(scores, labels)
        loss.backward()
        if state.loss_is_finite(loss):
            state.apply_gradients()
        else:
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, old in zip(model.buffers(), buffers):
                    b.copy_(old)
        acc = (torch.argmax(scores.detach(), dim=-1) == labels).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "infonce_acc": acc}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: TrafficBatch) -> Dict[str, torch.Tensor]:
        """Mean and (population) spread of the matched-pair scores, with the
        running BatchNorm statistics."""
        scores = state.model.get_scores(batch)
        return {"score_mean": scores.mean(), "score_std": scores.std(unbiased=False)}

    def score_fn(self, state: TrainState) -> Callable[[TrafficBatch], torch.Tensor]:
        """(obs) -> [B] matched-pair scores, for `sim.learned_metrics`."""
        return lambda obs: state.model.get_scores(obs)
