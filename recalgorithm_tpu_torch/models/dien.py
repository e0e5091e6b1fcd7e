"""DIEN: Deep Interest Evolution Network — GRU extraction + AGRU/AUGRU evolution.

Counterpart of ``recalgorithm_tpu/models/dien.py``.  Reference:
algorithm/DIEN/dien.py — an interest-extraction GRU over the behaviour
sequence (L202-204); attention scores from a target-projected bilinear form,
softmaxed over the valid positions (L206-218; a row with no history attends
uniformly); interest evolution by AGRU/AUGRU fed the per-step attention
(L220-229, ``ops/recurrent.py``); concat(dense, category, target, final
state) -> the DIN dice/prelu tower (L239-255); LazyAdam (L328-329, the
default ``optimizer="lazyadam"``).

The flag-gated auxiliary loss (L261-300) is returned beside the logits as
``aux`` in train mode, with in-model negatives (the behaviour sequence
rolled across the batch) and the corrected sign, as the JAX model has it.
Unlike the JAX model, which creates ``aux_project_matrix`` inside its first
train-mode call (so a model initialised in eval mode, as the JAX trainer
initialises it, cannot train with the flag), the parameter is made here at
construction, and only when the flag is set: a model without the loss owns
no parameter that no step would reach.

The forward's parts are spans (``utils/summary.py``, recorded while a
profiler runs): ``dien.extract`` (the GRU), ``dien.attend`` (the masked
softmax attention), ``dien.evolve`` (the AGRU/AUGRU) and, in train mode
with the flag, ``dien.aux``.  A replayed train step runs none of them on
the host, so they show on eager steps alone (a graph's warm-up, eval,
predict, a mesh).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.din import DIN_CATEGORY_FIELDS, SequenceMLP
from recalgorithm_tpu_torch.ops.attention import NEG_INF, sequence_mask
from recalgorithm_tpu_torch.ops.mlp import glorot_param
from recalgorithm_tpu_torch.ops.recurrent import GRULoop
from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.utils.summary import span

SEQ = "his_read_comment_7d_seq"


@dataclasses.dataclass(frozen=True)
class DIENConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    activation: str = "dice"
    custom_gru_type: str = "AGRU"  # {'AGRU', 'AUGRU'}
    gru_output_units: int = 8
    use_auxiliary_loss: bool = False
    negative_sample_number: int = 3
    optimizer: str = "lazyadam"  # dien.py:328 LazyAdamOptimizer
    task_names: tuple[str, ...] = ("read_comment",)


class DIEN(nn.Module):
    """Submodules and parameters carry the flax names: ``embedder``, ``gru``,
    ``attention_project_matrix`` (nh, na), ``evolution``, ``fcn`` and, with
    the auxiliary loss, ``aux_project_matrix`` (na, nh)."""

    def __init__(self, config: DIENConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        tables = common.wd_tables(schema)
        self.embedder = common.FieldEmbedder(tables, DIN_CATEGORY_FIELDS, generator)
        na, nh = tables["feedid"].dim, config.gru_output_units
        self.gru = GRULoop(na, nh, "GRU", generator)
        self.attention_project_matrix = glorot_param(nh, na, generator=generator)
        self.evolution = GRULoop(nh, nh, config.custom_gru_type, generator)
        width = (len(schema.dense) + sum(tables[v].dim for _, v, _ in DIN_CATEGORY_FIELDS)
                 + na + nh)
        self.fcn = SequenceMLP(width, config.hidden_units, config.activation,
                               config.batch_norm, config.dropout_rate, generator, dt)
        if config.use_auxiliary_loss:
            self.aux_project_matrix = glorot_param(na, nh, generator=generator)
        self.mesh = None  # under a process mesh the negatives roll the global batch

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        embed = self.embedder.embed
        category = torch.cat(self.embedder(batch), dim=-1)
        target = embed.embed_scalar("feedid", batch["feedid"])  # (B, na)
        seq = embed.embed_sequence("feedid", batch[SEQ])        # (B, T, na)
        lengths = batch[SEQ + "_len"]

        with span("dien.extract"):  # interest extraction
            h, _ = self.gru(seq, lengths)  # (B, T, nh)
        with span("dien.attend"):
            # h @ (W e_target), masked softmax over time (dien.py:206-218)
            w_ea = target @ self.attention_project_matrix.T  # (B, nh)
            scores = torch.einsum("bth,bh->bt", h, w_ea)
            scores = torch.where(sequence_mask(lengths, seq.shape[1]), scores,
                                 torch.full_like(scores, NEG_INF))
            att = torch.softmax(scores, dim=1)
        with span("dien.evolve"):  # interest evolution
            _, final_state = self.evolution(h, lengths, att)

        x = torch.cat([batch["dense"], category, target, final_state], dim=-1)
        losses = {}
        if self.config.use_auxiliary_loss and self.training:
            with span("dien.aux"):
                losses["aux"] = self._auxiliary_loss(h, seq, lengths)
        return {"read_comment": self.fcn(x)}, losses

    def _auxiliary_loss(self, h: torch.Tensor, seq: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
        """Next-item discrimination: h_t should score e_{t+1} above in-batch
        negatives (dien.py:261-300, negated; negatives: the sequence rolled
        by 1..negative_sample_number rows across the batch, the global batch
        under a process mesh, as under the JAX package's)."""
        w_aux = self.aux_project_matrix
        h_ = h[:, :-1, :]
        eps = 1e-8
        pos = seq[:, 1:, :] @ w_aux  # (B, T-1, nh)
        ll = torch.log(torch.sigmoid((h_ * pos).sum(-1)) + eps)
        neg_ll = 0.0
        mesh = self.mesh
        if mesh is not None and mesh.data_size > 1:  # roll the global batch
            rows = seq.shape[0]
            everyone = multihost.gather_rows(seq, mesh.data_group, mesh.data_size,
                                             mesh.data_index, replicated=False)
            rolled = lambda k: torch.roll(everyone, k, dims=0)[
                mesh.data_index * rows:(mesh.data_index + 1) * rows]
        else:
            rolled = lambda k: torch.roll(seq, k, dims=0)
        for k in range(1, self.config.negative_sample_number + 1):
            neg = rolled(k)[:, 1:, :] @ w_aux
            neg_ll = neg_ll + torch.log(1.0 - torch.sigmoid((h_ * neg).sum(-1)) + eps)
        m = sequence_mask(lengths - 1, seq.shape[1] - 1).to(h.dtype)
        return -((ll + neg_ll) * m).sum(dim=1).mean()


common.register_model("DIEN", DIENConfig, DIEN)
