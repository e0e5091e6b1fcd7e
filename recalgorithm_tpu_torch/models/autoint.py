"""AutoInt: automatic feature interaction via field self-attention.

Counterpart of ``recalgorithm_tpu/models/autoint.py`` (Song et al. 2019,
arXiv:1810.11921; no reference counterpart).  The 8 fields of PNN's surface
embed to (B, 8, K); the dense features project to one more field
(``dense_field``, the paper's numeric-feature embedding, §3.2), appended
last; ``att_layers`` stacked InteractingLayers (``interact_<i>``, the BST
attention kernels on the card) refine the (B, 9, K) tensor before a
flattened Dense(1) ``logit``.  AutoInt+ (``use_deep_tower``, §4.6) adds a
parallel MLP tower ``deep`` and its ``deep_logit``.  As in the JAX model,
the tower reads ``dense ‖ 8 fields ‖ dense_field`` (the projected field was
appended before the concat), of width n_dense + 9 K.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import InteractingLayer
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class AutoIntConfig(common.TrainFlags):
    """AutoInt flags.  The JAX package's ``use_fused_attention`` has no
    counterpart: here the tensors' device picks the BST kernels (CUDA) or
    their plain twin (CPU)."""

    embedding_dim: int = 16
    att_layers: int = 3
    num_heads: int = 2
    head_dim: int = 16
    use_deep_tower: bool = False  # AutoInt+ variant
    hidden_units: tuple[int, ...] = (256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class AutoInt(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``dense_field``,
    ``interact_<i>``, ``logit``, and for AutoInt+ ``deep`` and
    ``deep_logit``."""

    def __init__(self, config: AutoIntConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k, n_dense = config.embedding_dim, len(schema.dense)
        num_fields = len(PNN_FIELDS) + 1
        self.embedder = pnn_embedder(schema, k, generator)
        self.dense_field = Dense(n_dense, k, generator)
        width = k
        for i in range(config.att_layers):
            self.add_module(f"interact_{i}", InteractingLayer(
                width, config.num_heads, config.head_dim, generator))
            width = config.num_heads * config.head_dim
        self.logit = Dense(num_fields * width, 1, generator)
        if config.use_deep_tower:
            self.deep = MLPTower(n_dense + num_fields * k, config.hidden_units,
                                 config.dropout_rate, config.batch_norm,
                                 generator=generator, compute_dtype=dt)
            self.deep_logit = Dense(self.deep.out_features, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        fields = self.embedder(batch)
        fields.append(self.dense_field(batch["dense"]))
        x = common.stack_fields(fields)  # (B, F+1, K)
        for i in range(self.config.att_layers):
            x = getattr(self, f"interact_{i}")(x)
        logit = self.logit(x.reshape(x.shape[0], -1))[:, 0]
        if self.config.use_deep_tower:
            deep_in = torch.cat([batch["dense"], *fields], dim=-1)
            logit = logit + self.deep_logit(self.deep(deep_in))[:, 0]
        return {"read_comment": logit}, {}


common.register_model("AutoInt", AutoIntConfig, AutoInt)
