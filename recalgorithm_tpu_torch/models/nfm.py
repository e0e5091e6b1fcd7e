"""NFM: bi-interaction pooling -> DNN, plus a dense linear term.

Counterpart of ``recalgorithm_tpu/models/nfm.py``.  Reference:
algorithm/NFM/nfm.py — dense linear logit (L147-149); bi-interaction = FM
sum-square pooling kept as a (B, K) vector (L155-168) -> BatchNorm + a
dropout whose rate is fixed at 0.1 whatever ``dropout_rate`` says
(L169-171) -> MLP -> Dense(1) (L172-180); logit = dense + dnn.  The hidden
layers run dense-relu -> BN -> dropout (L175-179), the reverse of
MLPTower's dropout -> BN, under their own ``dense_<i>`` / ``bn_<i>`` names.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.afm import afm_embedder
from recalgorithm_tpu_torch.ops.activations import Dropout, batch_norm
from recalgorithm_tpu_torch.ops.interactions import fm_pool
from recalgorithm_tpu_torch.ops.mlp import Dense

BI_INTERACTION_DROPOUT = 0.1  # nfm.py:171 hard-codes it


@dataclasses.dataclass(frozen=True)
class NFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class NFM(nn.Module):
    """Submodules carry the flax names: ``dense_logit``, ``embedder``,
    ``bi_interaction_bn`` (eps 1e-3, flax momentum 0.99), ``dense_<i>``,
    ``bn_<i>``, ``logit``; the dropouts hold no parameters."""

    def __init__(self, config: NFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        self.dense_logit = Dense(len(schema.dense), 1, generator)
        self.embedder = afm_embedder(schema, k, generator)
        self.bi_interaction_bn = batch_norm(k)
        self.bi_interaction_dropout = Dropout(BI_INTERACTION_DROPOUT)
        self._order, width = [], k
        for i, units in enumerate(config.hidden_units):
            layers = [(f"dense_{i}", Dense(width, units, generator, compute_dtype=dt)),
                      (f"relu_{i}", nn.ReLU())]
            if config.batch_norm:
                layers.append((f"bn_{i}", batch_norm(units)))
            if 0.0 < config.dropout_rate < 1.0:
                layers.append((f"dropout_{i}", Dropout(config.dropout_rate)))
            for name, module in layers:
                self.add_module(name, module)
                self._order.append(name)
            width = units
        self.logit = Dense(width, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x = fm_pool(common.stack_fields(self.embedder(batch)))  # (B, K)
        x = self.bi_interaction_dropout(self.bi_interaction_bn(x))
        for name in self._order:
            x = getattr(self, name)(x)
        nfm_logit = self.logit(x)[:, 0]
        return {"read_comment": self.dense_logit(batch["dense"])[:, 0] + nfm_logit}, {}


common.register_model("NFM", NFMConfig, NFM)
