"""GenericDNN: a schema-driven DNN baseline that trains on any dataset's schema.

Counterpart of ``recalgorithm_tpu/models/generic_dnn.py``.  The fields come
from the Schema, not a hand-written list: every categorical feature embeds
as a scalar field and every sequence feature mean-pools into a field of the
same dim (sharing its vocabulary's table), with the dense block in front.
So the same model builds on the WeChat and the Douban schema.  Tasks
default to the schema's first label.

Architecture: concat(dense, embeddings) -> MLP -> Dense(1) per task
(``logit_<task>``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class GenericDNNConfig(common.TrainFlags):
    embedding_dim: int = 16
    hidden_units: tuple[int, ...] = (256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ()  # () = the schema's first label


class GenericDNN(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``deep``,
    ``logit_<task>``."""

    def __init__(self, config: GenericDNNConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        fields = common.schema_fields(schema)
        vocabs = sorted({v for _, v, _ in fields})
        self.embedder = common.FieldEmbedder(
            common.uniform_tables(schema, config.embedding_dim, vocabs), fields, generator)
        self.deep = MLPTower(len(schema.dense) + len(fields) * config.embedding_dim,
                             config.hidden_units, config.dropout_rate, config.batch_norm,
                             generator=generator, compute_dtype=dt)
        for t in self.tasks:
            self.add_module(f"logit_{t}", Dense(self.deep.out_features, 1, generator))

    @property
    def tasks(self) -> tuple[str, ...]:
        return self.config.task_names or (self.schema.labels[0],)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x = self.deep(torch.cat([batch["dense"], *self.embedder(batch)], dim=-1))
        return {t: getattr(self, f"logit_{t}")(x)[:, 0] for t in self.tasks}, {}


common.register_model("GenericDNN", GenericDNNConfig, GenericDNN)
