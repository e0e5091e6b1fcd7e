"""AFM: attentional FM over pairwise Hadamard products, plus a dense linear term.

Counterpart of ``recalgorithm_tpu/models/afm.py``.  Reference:
algorithm/AFM/afm.py — dense linear logit (L144-146); 7 uniform-dim
embedding fields (6 scalar + mean-pooled manual_tag, L94-102); all pair
Hadamard products (L160-165); attention MLP h^T relu(Wp + b) softmaxed over
pairs (L167-182); attention-weighted sum projected by the p-vector
(L184-188).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.interactions import AFMAttention, pairwise_hadamard
from recalgorithm_tpu_torch.ops.mlp import Dense, glorot_param

# The field surface of AFM and NFM: the 6 scalar fields and the manual_tag
# mean.
AFM_FIELDS = [(n, n, "scalar") for n in common.SCALAR_CAT_FIELDS] + [
    ("manual_tag_list", "manual_tag_id", "mean")
]
AFM_VOCABS = tuple(common.SCALAR_CAT_FIELDS) + ("manual_tag_id",)


def afm_embedder(schema: Schema, embedding_dim: int,
                 generator: torch.Generator | None = None) -> common.FieldEmbedder:
    """The 7 fields of AFM_FIELDS at one ``embedding_dim``."""
    return common.FieldEmbedder(
        common.uniform_tables(schema, embedding_dim, AFM_VOCABS), AFM_FIELDS, generator)


@dataclasses.dataclass(frozen=True)
class AFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    attention_factor: int = 128
    task_names: tuple[str, ...] = ("read_comment",)


class AFM(nn.Module):
    """Submodules and parameters carry the flax names: ``dense_logit``,
    ``embedder``, ``attention``, the raw (K, 1) ``p``."""

    def __init__(self, config: AFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        self.dense_logit = Dense(len(schema.dense), 1, generator)
        self.embedder = afm_embedder(schema, k, generator)
        self.attention = AFMAttention(k, config.attention_factor, generator)
        self.p = glorot_param(k, 1, generator=generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        pairs = pairwise_hadamard(common.stack_fields(self.embedder(batch)))  # (B, P, K)
        afm_logit = (self.attention(pairs) @ self.p)[:, 0]
        return {"read_comment": self.dense_logit(batch["dense"])[:, 0] + afm_logit}, {}


common.register_model("AFM", AFMConfig, AFM)
