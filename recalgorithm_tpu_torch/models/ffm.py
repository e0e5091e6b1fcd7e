"""FFM: field-aware factorization machine.

Counterpart of ``recalgorithm_tpu/models/ffm.py``.  Reference:
algorithm/FFM/ffm.py — first order as in DeepFM (L123-125); second order
(L128-160): field i owns F-1 sub-tables; for a pair (i < j), v_i comes from
field i's (j-1)-th sub-table and v_j from field j's i-th; logit +=
<v_i, v_j>.  As in the JAX package, field i's sub-tables are one
(|V_i| + 1, (F-1)*K) table, so one lookup a field fetches all F-1 pair
embeddings.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common

SCALAR_FIELDS = [(n, n, "scalar") for n in common.SCALAR_CAT_FIELDS]


@dataclasses.dataclass(frozen=True)
class FFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    task_names: tuple[str, ...] = ("read_comment",)


class FFM(nn.Module):
    """Submodules carry the flax names: ``first_order`` and ``embed``, the
    wide tables' collection directly under the model."""

    def __init__(self, config: FFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.schema = schema
        f = len(common.SCALAR_CAT_FIELDS)
        self.first_order = common.FirstOrderLogit(schema, SCALAR_FIELDS)
        self.embed = EmbeddingCollection({
            n: TableSpec(n, schema.vocab_sizes[n], (f - 1) * config.embedding_dim)
            for n in common.SCALAR_CAT_FIELDS}, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        names = common.SCALAR_CAT_FIELDS
        f, k = len(names), self.config.embedding_dim
        # per-field lookups -> (B, F-1, K) pair-embedding banks
        banks = [self.embed.embed_scalar(n, batch[n]).reshape(-1, f - 1, k) for n in names]
        logit = self.first_order(batch)
        for i in range(f - 1):
            for j in range(i + 1, f):
                # reference indexing (ffm.py:150-157): field i reads its
                # sub-table j-1, field j its sub-table i
                logit = logit + (banks[i][:, j - 1, :] * banks[j][:, i, :]).sum(dim=-1)
        return {"read_comment": logit}, {}


common.register_model("FFM", FFMConfig, FFM)
