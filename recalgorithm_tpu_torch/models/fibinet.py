"""FiBiNET: SENET field reweighting + bilinear pair interactions -> DNN.

Counterpart of ``recalgorithm_tpu/models/fibinet.py``.  Reference:
algorithm/FiBiNET/fibinet.py — 8 uniform-dim embedding fields (L106-116);
dense-feature ``linear`` logit (L166-168); the ``senet`` stream (L171-174);
bilinear interaction of the original and the SENET streams
(``bilinear_original``, ``bilinear_senet``), concatenated on K and
flattened (L177-187); dense-relu -> dropout -> BN per layer (``dense_<i>``,
``bn_<i>``, L189-195) -> ``logit``; logit = linear + dnn.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import BilinearInteraction, SENet
from recalgorithm_tpu_torch.ops.mlp import Dense, add_tower


@dataclasses.dataclass(frozen=True)
class FiBiNETConfig(common.TrainFlags):
    embedding_dim: int = 8
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    reduction_ratio: int = 2
    bilinear_interaction_type: str = "all"  # {'all', 'each', 'interaction'}
    task_names: tuple[str, ...] = ("read_comment",)


class FiBiNET(nn.Module):
    def __init__(self, config: FiBiNETConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k, f = config.embedding_dim, len(PNN_FIELDS)
        self.linear = Dense(len(schema.dense), 1, generator)
        self.embedder = pnn_embedder(schema, k, generator)
        self.senet = SENet(f, k, config.reduction_ratio, generator)
        kind = config.bilinear_interaction_type
        self.bilinear_original = BilinearInteraction(f, k, kind, generator=generator)
        self.bilinear_senet = BilinearInteraction(f, k, kind, generator=generator)
        num_pairs = len(self.bilinear_original.pairs[0])
        self._tower, width = add_tower(self, num_pairs * 2 * k, config.hidden_units,
                                       config.dropout_rate, config.batch_norm, generator, dt)
        self.logit = Dense(width, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        linear_logit = self.linear(batch["dense"])[:, 0]
        field_emb = common.stack_fields(self.embedder(batch))  # (B, F, K)
        x = torch.cat([self.bilinear_original(field_emb),
                       self.bilinear_senet(self.senet(field_emb))], dim=-1)  # (B, P, 2K)
        x = x.reshape(x.shape[0], -1)
        for name in self._tower:
            x = getattr(self, name)(x)
        return {"read_comment": linear_logit + self.logit(x)[:, 0]}, {}


common.register_model("FiBiNET", FiBiNETConfig, FiBiNET)
