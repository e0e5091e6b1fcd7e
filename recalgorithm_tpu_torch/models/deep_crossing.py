"""DeepCrossing: stacked residual units over the concatenated feature vector.

Counterpart of ``recalgorithm_tpu/models/deep_crossing.py``.  Reference:
algorithm/DeepCrossing/deepcrossing.py (model_fn L121-270, residual stack
L152-159) — dense(16) + W&D-family embeddings (incl. the mean-pooled
behaviour sequence sharing the feedid table) concatenated, run through
``residual_network_num`` ResidualUnits, then a 1-unit logit head.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.mlp import Dense, ResidualUnit


@dataclasses.dataclass(frozen=True)
class DeepCrossingConfig(common.TrainFlags):
    residual_internal_dim: int = 128
    residual_network_num: int = 1
    task_names: tuple[str, ...] = ("read_comment",)


class DeepCrossing(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``res_<i>``, ``logit``."""

    def __init__(self, config: DeepCrossingConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, d = wd_embedder(schema, generator)
        for i in range(config.residual_network_num):
            self.add_module(f"res_{i}", ResidualUnit(d, config.residual_internal_dim, generator,
                                                     compute_dtype=dt))
        self.logit = Dense(d, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        for i in range(self.config.residual_network_num):
            x = getattr(self, f"res_{i}")(x)
        return {"read_comment": self.logit(x)[:, 0]}, {}


common.register_model("DeepCrossing", DeepCrossingConfig, DeepCrossing)
