"""FwFM: field-weighted FM — pairwise dots scaled by learned pair strengths.

Counterpart of ``recalgorithm_tpu/models/fwfm.py``.  Reference:
algorithm/FwFM/fwfm.py — first order as DeepFM (L135-137); second order
(L144-160): logit += r_ij * <v_i, v_j> over all pairs, r a learned vector of
F(F-1)/2 strengths in the upper-triangle pair order (algorithm/utils.py:67-82),
here every pair's dot read off one Gram matrix (``pairwise_dot``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.interactions import pairwise_dot
from recalgorithm_tpu_torch.ops.mlp import glorot_param

SCALAR_FIELDS = [(n, n, "scalar") for n in common.SCALAR_CAT_FIELDS]


@dataclasses.dataclass(frozen=True)
class FwFMConfig(common.TrainFlags):
    embedding_dim: int = 8
    task_names: tuple[str, ...] = ("read_comment",)


class FwFM(nn.Module):
    """Submodules and parameters carry the flax names: ``first_order``,
    ``embedder``, the raw (P, 1) ``fields_pair_strength_weight``."""

    def __init__(self, config: FwFMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.schema = schema
        self.first_order = common.FirstOrderLogit(schema, SCALAR_FIELDS)
        self.embedder = common.FieldEmbedder(
            common.uniform_tables(schema, config.embedding_dim, common.SCALAR_CAT_FIELDS),
            SCALAR_FIELDS, generator)
        f = len(SCALAR_FIELDS)
        self.fields_pair_strength_weight = glorot_param(f * (f - 1) // 2, 1,
                                                        generator=generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        dots = pairwise_dot(common.stack_fields(self.embedder(batch)))  # (B, P)
        second_order = dots @ self.fields_pair_strength_weight[:, 0]
        return {"read_comment": self.first_order(batch) + second_order}, {}


common.register_model("FwFM", FwFMConfig, FwFM)
