"""PNN: product-based neural network (IPNN / OPNN).

Counterpart of ``recalgorithm_tpu/models/pnn.py``.  Reference:
algorithm/PNN/pnn.py — 8 uniform-dim embedding fields incl. the mean-pooled
behaviour sequence sharing the feedid table (L75-85); linear signal lz =
flat embeddings x ``linear_w`` (L133-139); product signal lp = IPNN or OPNN
(L146-173); relu(lz + lp + ``bias``) -> MLP -> Dense(1) (L178-193); with
``weight_regularizer > 0`` the L2 penalties on ``linear_w`` and the product
weights (L209-211), returned beside the logits.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.interactions import (
    InnerProductLayer,
    OuterProductLayer,
    l2_penalty,
)
from recalgorithm_tpu_torch.ops.mlp import MLPTower, glorot_param

# The field surface of PNN, AutoInt, xDeepFM and FiBiNET: the 6 scalar
# fields, the manual_tag mean, and the behaviour-sequence mean on the feedid
# table.
PNN_FIELDS = [(n, n, "scalar") for n in common.SCALAR_CAT_FIELDS] + [
    ("manual_tag_list", "manual_tag_id", "mean"),
    ("his_read_comment_7d_seq", "feedid", "mean"),
]
PNN_VOCABS = tuple(common.SCALAR_CAT_FIELDS) + ("manual_tag_id",)


def pnn_embedder(schema: Schema, embedding_dim: int,
                 generator: torch.Generator | None = None) -> common.FieldEmbedder:
    """The 8 fields of PNN_FIELDS at one ``embedding_dim``."""
    return common.FieldEmbedder(
        common.uniform_tables(schema, embedding_dim, PNN_VOCABS), PNN_FIELDS, generator)


@dataclasses.dataclass(frozen=True)
class PNNConfig(common.TrainFlags):
    embedding_dim: int = 8
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    output_dimension: int = 1024
    product_method: str = "IPNN"  # {'IPNN', 'OPNN'}
    weight_regularizer: float = 0.0
    task_names: tuple[str, ...] = ("read_comment",)


class PNN(nn.Module):
    """Submodules and parameters carry the flax names: ``embedder``,
    ``linear_w``, ``inner_product`` or ``outer_product``, ``bias``, ``fcn``."""

    def __init__(self, config: PNNConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k, d = config.embedding_dim, config.output_dimension
        self.embedder = pnn_embedder(schema, k, generator)
        num_fields = len(PNN_FIELDS)
        self.linear_w = glorot_param(num_fields * k, d, generator=generator)
        if config.product_method == "IPNN":
            self.inner_product = InnerProductLayer(
                num_fields, d, config.weight_regularizer, generator)
        elif config.product_method == "OPNN":
            self.outer_product = OuterProductLayer(k, d, config.weight_regularizer, generator)
        else:
            raise ValueError(f"product_method must be IPNN or OPNN, got "
                             f"{config.product_method!r}")
        self.bias = nn.Parameter(torch.zeros(d))
        self.fcn = MLPTower(d, config.hidden_units, config.dropout_rate,
                            config.batch_norm, logits_dim=1, generator=generator,
                            compute_dtype=dt)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        fields = self.embedder(batch)
        flat = torch.cat(fields, dim=-1)           # (B, F*K)
        field_emb = common.stack_fields(fields)    # (B, F, K)
        name = "inner_product" if cfg.product_method == "IPNN" else "outer_product"
        product = getattr(self, name)
        x = torch.relu(flat @ self.linear_w + product(field_emb) + self.bias)
        logit = self.fcn(x)[:, 0]
        losses = {f"{name}.{k}": v for k, v in product.losses().items()}
        if cfg.weight_regularizer > 0:
            losses["weight_l2"] = l2_penalty(cfg.weight_regularizer, self.linear_w)
        return {"read_comment": logit}, losses


common.register_model("PNN", PNNConfig, PNN)
