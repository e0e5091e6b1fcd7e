"""xDeepFM: linear + CIN + plain DNN, three summed logits.

Counterpart of ``recalgorithm_tpu/models/xdeepfm.py``.  Reference:
algorithm/xDeepFM/xdeepfm.py — 8 uniform-dim embedding fields (L102-112);
``linear`` logit over concat(dense, flat embeddings) (L161-163); CIN stack
``cin_<i>`` with per-layer feature-map counts, each sum-pooled over K,
concatenated -> bias-free ``cin_logit`` (L166-175, cin_layer.py:4-30); a
plain relu DNN ``dnn_<i>`` (no BN, no dropout, L178-182) -> bias-free
``dnn_logit``; total = sum of the three (L185).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import CINLayer
from recalgorithm_tpu_torch.ops.mlp import Dense


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    hidden_units: tuple[int, ...] = (512, 256, 128)
    cin_layer_feature_maps: tuple[int, ...] = (50, 50, 50)
    task_names: tuple[str, ...] = ("read_comment",)


class XDeepFM(nn.Module):
    def __init__(self, config: XDeepFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k, m = config.embedding_dim, len(PNN_FIELDS)
        self.embedder = pnn_embedder(schema, k, generator)
        width = len(schema.dense) + m * k
        self.linear = Dense(width, 1, generator)
        prev = m
        for i, h in enumerate(config.cin_layer_feature_maps):
            self.add_module(f"cin_{i}", CINLayer(m, prev, h, generator))
            prev = h
        self.cin_logit = Dense(sum(config.cin_layer_feature_maps), 1, generator, bias=False)
        for i, unit in enumerate(config.hidden_units):
            self.add_module(f"dnn_{i}", Dense(width, unit, generator, compute_dtype=dt))
            width = unit
        self.dnn_logit = Dense(width, 1, generator, bias=False)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        fields = self.embedder(batch)
        linear_vec = torch.cat([batch["dense"], *fields], dim=-1)
        linear_logit = self.linear(linear_vec)[:, 0]
        x0 = xk = common.stack_fields(fields)  # (B, m, K)
        pooled = []
        for i in range(len(cfg.cin_layer_feature_maps)):
            xk = getattr(self, f"cin_{i}")(x0, xk)
            pooled.append(xk.sum(dim=-1))     # (B, h_i)
        cin_logit = self.cin_logit(torch.cat(pooled, dim=-1))[:, 0]
        net = linear_vec
        for i in range(len(cfg.hidden_units)):
            net = torch.relu(getattr(self, f"dnn_{i}")(net))
        dnn_logit = self.dnn_logit(net)[:, 0]
        return {"read_comment": linear_logit + cin_logit + dnn_logit}, {}


common.register_model("xDeepFM", XDeepFMConfig, XDeepFM)
