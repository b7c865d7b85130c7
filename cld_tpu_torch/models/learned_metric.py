"""Learned trajectory-likelihood metric, the EBM (port of
`cld_tpu/models/learned_metric.py`): a ResNet map encoder and a one-layer
LSTM trajectory encoder score (map, trajectory) pairs. Training takes the
InfoNCE objective over the batch's permutations (the [B, B] score matrix,
labels on the diagonal); at evaluation the matched-pair score is a learned
realism metric of rollout trajectories (`sim.learned_metrics`).

Submodules carry the flax names (`map_encoder`, `traj_encoder`, `embed_net`,
`score_net`), so `utils.weights.load_flax` loads the JAX package's
variables. The trajectory encoder runs through PyTorch's LSTM operator
(cuDNN on the card), as the VAE's encoder does.

At `compute_dtype` bf16 (`ops.precision`) every network runs under bf16
autocast over float32 parameters (the LSTM in bf16 through
`models.vae._lstm_stack`, cuDNN's bf16 cells on the card), and the scores
come out bf16, as the JAX module's; InfoNCE takes them in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.resnet import ResNetEncoder
from cld_tpu_torch.models.vae import LSTMEncoder
from cld_tpu_torch.ops.precision import autocast
from cld_tpu_torch.parallel.mesh import gather_rows


class PermuteEBM(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, map_arch: str = "resnet18",
                 map_feature_dim: int = 64, traj_feature_dim: int = 64,
                 embedding_dim: int = 64):
        super().__init__()
        self.map_encoder = ResNetEncoder(map_arch, raster_channels, map_feature_dim)
        # (x, y, yaw) per step, h0 from a zero cond of the map feature's width
        self.traj_encoder = LSTMEncoder(3, traj_feature_dim, map_feature_dim, num_layers=1)
        self.embed_net = MLP(map_feature_dim + traj_feature_dim, embedding_dim, (128, 128),
                             normalization=True)
        self.score_net = nn.Linear(embedding_dim, 1)

    def _features(self, batch: TrafficBatch, train: bool):
        trajs = torch.cat([batch.target_positions, batch.target_yaws], dim=-1)
        with autocast(self.compute_dtype, trajs.device.type):
            map_feat = self.map_encoder(batch.image, train)
            cond = map_feat.new_zeros((trajs.shape[0], map_feat.shape[-1]))
            traj_feat = self.traj_encoder(trajs, cond)[:, -1]  # the last hidden state
        return map_feat, traj_feat

    def _score(self, feat: torch.Tensor):
        with autocast(self.compute_dtype, feat.device.type):
            emb = F.relu(self.embed_net(feat))
            return self.score_net(emb)[..., 0], emb

    def forward(self, batch: TrafficBatch, train: bool = False,
                mesh=None) -> Dict[str, torch.Tensor]:
        """The contrastive score matrix [B, B]: scores[i, j] pairs map i with
        trajectory j; the true pairs are on the diagonal. Under data
        parallelism (an active `parallel.mesh.Mesh`) a rank's [B, world * B]
        rows pair its maps with every rank's trajectories, gathered with
        their gradient; its true pairs are in the columns of its own rows."""
        map_feat, traj_feat = self._features(batch, train)
        traj_feat = gather_rows(traj_feat, mesh)
        b, n = map_feat.shape[0], traj_feat.shape[0]
        pairs = torch.cat([map_feat[:, None].expand(b, n, -1),
                           traj_feat[None].expand(b, n, -1)], dim=-1)
        scores, emb = self._score(pairs)
        return {"scores": scores, "features": emb}

    def get_scores(self, batch: TrafficBatch, train: bool = False) -> torch.Tensor:
        """The matched-pair scores [B]: the learned realism metric."""
        map_feat, traj_feat = self._features(batch, train)
        return self._score(torch.cat([map_feat, traj_feat], dim=-1))[0]


def ebm_infonce_loss(scores: torch.Tensor, labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """InfoNCE in float32: each map should score its own trajectory, the
    column `labels` (default: the diagonal), highest."""
    scores = scores.to(torch.float32)
    if labels is None:
        labels = torch.arange(scores.shape[0], device=scores.device)
    return F.cross_entropy(scores, labels)
