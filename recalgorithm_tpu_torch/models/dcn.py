"""DCN: Deep & Cross Network (v1).

Counterpart of ``recalgorithm_tpu/models/dcn.py``.  Reference:
algorithm/DCN/dcn.py — input = concat(dense, W&D-family embeddings)
(L150-155); parallel cross stack with x0 fixed (L157-160, cross_layer.py:4-26)
and MLP (L162-165); concat(cross_out, deep_out) -> Dense(1) (L167-169).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.interactions import CrossNetwork
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower

# The W&D-family field surface of DeepCrossing, DCN, DCNv2 and GDCN (its
# order is not SCALAR_CAT_FIELDS'): dense + these 8 fields is 16 + 66 wide.
WD_FIELDS = [
    ("userid", "userid", "scalar"),
    ("device", "device", "scalar"),
    ("authorid", "authorid", "scalar"),
    ("bgm_song_id", "bgm_song_id", "scalar"),
    ("bgm_singer_id", "bgm_singer_id", "scalar"),
    ("manual_tag_list", "manual_tag_id", "mean"),
    ("feedid", "feedid", "scalar"),
    ("his_read_comment_7d_seq", "feedid", "mean"),
]


def wd_embedder(schema: Schema, generator: torch.Generator | None = None
                ) -> tuple[common.FieldEmbedder, int]:
    """WD_FIELDS at the fixed W&D dims, and the width of concat(dense, fields)."""
    tables = common.wd_tables(schema)
    width = len(schema.dense) + sum(tables[v].dim for _, v, _ in WD_FIELDS)
    return common.FieldEmbedder(tables, WD_FIELDS, generator), width


@dataclasses.dataclass(frozen=True)
class DCNConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)
    num_cross_layer: int = 1
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class DCN(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``cross``, ``deep``,
    ``logit``."""

    def __init__(self, config: DCNConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, d = wd_embedder(schema, generator)
        self.cross = CrossNetwork(d, config.num_cross_layer, generator)
        self.deep = MLPTower(d, config.hidden_units, config.dropout_rate,
                             config.batch_norm, generator=generator, compute_dtype=dt)
        self.logit = Dense(d + self.deep.out_features, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x0 = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        logit = self.logit(torch.cat([self.cross(x0), self.deep(x0)], dim=-1))[:, 0]
        return {"read_comment": logit}, {}


common.register_model("DCN", DCNConfig, DCN)
