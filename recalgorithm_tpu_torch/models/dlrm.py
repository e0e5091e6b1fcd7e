"""DLRM: deep learning recommendation model (beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/dlrm.py``: Naumov et al. 2019
(arXiv:1906.00091) on the WeChat feature surface.  The dense features run a
bottom MLP down to the embedding dim and join PNN's 8 fields as a ninth
latent vector; the interaction is every pairwise dot of the 9 (36 pairs);
the top MLP reads concat(bottom output, dots).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import pairwise_dot
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class DLRMConfig(common.TrainFlags):
    embedding_dim: int = 16
    bottom_hidden_units: tuple[int, ...] = (64,)
    hidden_units: tuple[int, ...] = (256, 128)  # top MLP
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class DLRM(nn.Module):
    """Submodules carry the flax names: ``bottom`` (no dropout),
    ``bottom_out``, ``embedder``, ``top``, ``logit``."""

    def __init__(self, config: DLRMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        self.bottom = MLPTower(len(schema.dense), config.bottom_hidden_units, 0.0,
                               config.batch_norm, generator=generator, compute_dtype=dt)
        self.bottom_out = Dense(self.bottom.out_features, k, generator)
        self.embedder = pnn_embedder(schema, k, generator)
        n = len(PNN_FIELDS) + 1
        self.top = MLPTower(k + n * (n - 1) // 2, config.hidden_units, config.dropout_rate,
                            config.batch_norm, generator=generator, compute_dtype=dt)
        self.logit = Dense(self.top.out_features, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        bottom = self.bottom_out(self.bottom(batch["dense"]))  # (B, K)
        z = common.stack_fields([bottom, *self.embedder(batch)])  # (B, F+1, K)
        top = self.top(torch.cat([bottom, pairwise_dot(z)], dim=-1))
        return {"read_comment": self.logit(top)[:, 0]}, {}


common.register_model("DLRM", DLRMConfig, DLRM)
