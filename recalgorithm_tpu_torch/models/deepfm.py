"""DeepFM: FM first+second order plus a deep tower over shared embeddings.

Counterpart of ``recalgorithm_tpu/models/deepfm.py``.  Reference:
algorithm/DeepFM/deepfm.py — 6 scalar categorical fields only (L56-95);
first order = one-hot indicators -> Dense(1) (L179-181, here a per-id weight
sum, ``FirstOrderLogit``); second order = sum-square FM pooling summed over
K (L192-200); deep = MLP(relu -> dropout -> BN) over the concatenated field
embeddings (L203-212); logit = first + second + deep (L214).

On the WeChat schema the fields are the reference's 6; on any other schema
(douban, ...) they come from the schema (``reference_or_schema_fields``):
sequences mean-pooled into the FM fields and sum-pooled into the first
order.  The task defaults to the schema's first label.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.interactions import fm_pool
from recalgorithm_tpu_torch.ops.mlp import MLPTower


@dataclasses.dataclass(frozen=True)
class DeepFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ()  # () = the schema's first label


class DeepFM(nn.Module):
    """Submodules carry the flax names: ``first_order``, ``embedder``,
    ``deep``."""

    def __init__(self, config: DeepFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        fields = common.reference_or_schema_fields(schema)
        # the first order sums the per-id weights of a multi-hot field
        self.first_order = common.FirstOrderLogit(
            schema, [(key, v, "sum" if kind == "mean" else kind) for key, v, kind in fields])
        self.embedder = common.FieldEmbedder(
            common.uniform_tables(schema, k, sorted({v for _, v, _ in fields})), fields,
            generator)
        self.deep = MLPTower(len(fields) * k, config.hidden_units, config.dropout_rate,
                             config.batch_norm, logits_dim=1, generator=generator,
                             compute_dtype=dt)

    @property
    def tasks(self) -> tuple[str, ...]:
        return self.config.task_names or (self.schema.labels[0],)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        fields = self.embedder(batch)
        second_order = fm_pool(common.stack_fields(fields)).sum(dim=-1)
        deep_logit = self.deep(torch.cat(fields, dim=-1))[:, 0]
        return {self.tasks[0]: self.first_order(batch) + second_order + deep_logit}, {}


common.register_model("DeepFM", DeepFMConfig, DeepFM)
