"""DLRM: deep learning recommendation model (beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/dlrm.py`` in its default form
(``interaction="dot"``): Naumov et al. 2019 (arXiv:1906.00091) on the WeChat
feature surface.  The dense features run a bottom MLP down to the embedding
dim and join PNN's 8 fields as a ninth latent vector; the interaction is
every pairwise dot of the 9 (36 pairs); the top MLP reads concat(bottom
output, dots).

``interaction="dcn"`` is DLRM-DCNv2, the model of MLPerf Training's
recommendation benchmark (torchrec's ``DLRM_DCN``), which the JAX package
does not have:

    d   = bottom(dense)                  dense -> relu per hidden layer
    e_f = sum_j E_f[id_fj]               every schema field, sum-pooled
    x0  = concat(d, e_1 .. e_F)
    x   = CrossNetworkV2(x0)             x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l
    logit = logit(top(x))                relu per hidden layer, then 256 -> 1

with no batch norm and no dropout where the configuration turns them off.
The fields are embedded at ``embedding_dim`` in the order of their
vocabularies in the schema (the Criteo schema's: ``cat_0`` .. ``cat_25``,
the published feature order).  Every width comes from the configuration.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import CrossNetworkV2, pairwise_dot
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower
from recalgorithm_tpu_torch.utils.summary import span


@dataclasses.dataclass(frozen=True)
class DLRMConfig(common.TrainFlags):
    embedding_dim: int = 16
    bottom_hidden_units: tuple[int, ...] = (64,)
    hidden_units: tuple[int, ...] = (256, 128)  # top MLP
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)
    # "dot": Naumov's pairwise dots of PNN's fields; "dcn": DLRM-DCNv2
    interaction: str = "dot"
    num_cross_layers: int = 3  # "dcn": the low-rank cross stack
    cross_low_rank: int = 512
    # the Adagrad accumulator's start and eps (optax's form: eps inside the
    # square root), when ``optimizer`` is adagrad
    adagrad_initial_accumulator_value: float = 1e-8
    adagrad_eps: float = 1e-7

    def optimizer_options(self) -> dict:
        if self.optimizer.lower() != "adagrad":
            return {}
        return {"initial_accumulator_value": self.adagrad_initial_accumulator_value,
                "eps": self.adagrad_eps}


def dcn_fields(schema: Schema) -> list[tuple[str, str, str]]:
    """Every categorical field as a scalar and every sequence field
    sum-pooled, in the order of their vocabularies in the schema."""
    order = {v: i for i, v in enumerate(schema.vocab_sizes)}
    fields = common.schema_fields(schema, sequences="sum")
    return sorted(fields, key=lambda f: order[f[1]])


class DLRM(nn.Module):
    """Submodules carry the flax names: ``bottom`` (no dropout),
    ``bottom_out``, ``embedder``, ``top``, ``logit``; the DCN form has no
    ``bottom_out`` (its bottom ends at its last hidden layer) and adds
    ``cross``."""

    def __init__(self, config: DLRMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.interaction not in ("dot", "dcn"):
            raise ValueError(f"unknown interaction {config.interaction!r} (dot/dcn)")
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        self.bottom = MLPTower(len(schema.dense), config.bottom_hidden_units, 0.0,
                               config.batch_norm, generator=generator, compute_dtype=dt)
        if config.interaction == "dcn":
            fields = dcn_fields(schema)
            self.embedder = common.FieldEmbedder(
                common.uniform_tables(schema, k, [v for _, v, _ in fields]), fields, generator)
            width = self.bottom.out_features + len(fields) * k
            self.cross = CrossNetworkV2(width, config.num_cross_layers,
                                        low_rank=config.cross_low_rank, generator=generator)
        else:
            self.bottom_out = Dense(self.bottom.out_features, k, generator)
            self.embedder = pnn_embedder(schema, k, generator)
            n = len(PNN_FIELDS) + 1
            width = k + n * (n - 1) // 2
        self.top = MLPTower(width, config.hidden_units, config.dropout_rate,
                            config.batch_norm, generator=generator, compute_dtype=dt)
        self.logit = Dense(self.top.out_features, 1, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        task = self.config.task_names[0]
        if self.config.interaction == "dcn":
            bottom = self.bottom(batch["dense"])  # (B, D)
            with span("dlrm.embed"):
                pooled = self.embedder(batch)
            with span("dlrm.interaction"):
                x = self.cross(torch.cat([bottom, *pooled], dim=-1))
            return {task: self.logit(self.top(x))[:, 0]}, {}
        bottom = self.bottom_out(self.bottom(batch["dense"]))  # (B, K)
        with span("dlrm.embed"):
            z = common.stack_fields([bottom, *self.embedder(batch)])  # (B, F+1, K)
        with span("dlrm.interaction"):
            dots = pairwise_dot(z)
        return {"read_comment": self.logit(self.top(torch.cat([bottom, dots], dim=-1)))[:, 0]}, {}


common.register_model("DLRM", DLRMConfig, DLRM)
