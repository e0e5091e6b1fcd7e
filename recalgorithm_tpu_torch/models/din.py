"""DIN: Deep Interest Network — target attention over the behaviour sequence.

Counterpart of ``recalgorithm_tpu/models/din.py``.  Reference:
algorithm/DIN/din.py — dense + 6 W&D-dim category fields (L85-111); target
feedid and the behaviour sequence share the 16-dim feedid table (L112-114);
din_attention pooling (L217-218); MLP with dense(no act) -> dice/prelu -> BN
-> dropout ordering (L224-238); "mini-batch-aware" regularisation
approximated as l2_lambda * ||concat(category, target, attention)||^2/2 / B
(L253-257), returned beside the logits.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.activations import Dice, Dropout, PReLU, batch_norm
from recalgorithm_tpu_torch.ops.attention import DINAttention
from recalgorithm_tpu_torch.ops.mlp import Dense

DIN_CATEGORY_FIELDS = [
    ("userid", "userid", "scalar"),
    ("device", "device", "scalar"),
    ("authorid", "authorid", "scalar"),
    ("bgm_song_id", "bgm_song_id", "scalar"),
    ("bgm_singer_id", "bgm_singer_id", "scalar"),
    ("manual_tag_list", "manual_tag_id", "mean"),
]


@dataclasses.dataclass(frozen=True)
class DINConfig(common.TrainFlags):
    """DIN flags.  The JAX package's ``use_fused_attention`` and
    ``attn_interpret`` have no counterpart: here the tensors' device picks
    the kernel (CUDA) or its plain twin (CPU)."""

    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    activation: str = "dice"  # {'dice', 'prelu'}
    mini_batch_aware_regularization: bool = True
    l2_lambda: float = 0.2
    use_softmax: bool = False
    task_names: tuple[str, ...] = ("read_comment",)


class SequenceMLP(nn.Module):
    """DIN/DIEN fcn: dense(no act) -> dice/prelu -> BN -> dropout per layer,
    then a 1-wide logit.  Submodules carry the flax names (dense_i, dice_i /
    prelu_i, bn_i, logit)."""

    def __init__(self, in_features: int, hidden_units: tuple[int, ...],
                 activation: str, batch_norm_: bool, dropout_rate: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        self._order: list[str] = []
        width = in_features
        for i, unit in enumerate(hidden_units):
            self._add(f"dense_{i}", Dense(width, unit, generator))
            if activation == "dice":
                self._add(f"dice_{i}", Dice(unit))
            else:
                self._add(f"prelu_{i}", PReLU(unit))
            if batch_norm_:
                self._add(f"bn_{i}", batch_norm(unit))
            if 0.0 < dropout_rate < 1.0:
                self._add(f"dropout_{i}", Dropout(dropout_rate))
            width = unit
        self.logit = Dense(width, 1, generator)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._order.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._order:
            x = getattr(self, name)(x)
        return self.logit(x)[:, 0]


class DIN(nn.Module):
    def __init__(self, config: DINConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        config.compute_dtype  # raises for precisions not ported yet
        self.config = config
        self.schema = schema
        tables = common.wd_tables(schema)
        self.embedder = common.FieldEmbedder(tables, DIN_CATEGORY_FIELDS, generator)
        item_dim = tables["feedid"].dim
        self.attention = DINAttention(item_dim, config.use_softmax, generator)
        width = (len(schema.dense)
                 + sum(tables[v].dim for _, v, _ in DIN_CATEGORY_FIELDS)
                 + 2 * item_dim)  # target + attention
        self.fcn = SequenceMLP(width, config.hidden_units, config.activation,
                               config.batch_norm, config.dropout_rate, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        embed = self.embedder.embed
        category = torch.cat(self.embedder(batch), dim=-1)
        target = embed.embed_scalar("feedid", batch["feedid"])  # (B, 16)
        seq = embed.embed_sequence("feedid", batch["his_read_comment_7d_seq"])
        attention = self.attention(target, seq, batch["his_read_comment_7d_seq_len"])
        x = torch.cat([batch["dense"], category, target, attention], dim=-1)
        logits = {"read_comment": self.fcn(x)}
        losses = {}
        if cfg.mini_batch_aware_regularization and cfg.l2_lambda > 0:
            emb = torch.cat([category, target, attention], dim=-1)
            # tf.nn.l2_loss = sum(x^2)/2 (din.py:255-256)
            losses["mba_l2"] = cfg.l2_lambda * 0.5 * emb.square().sum() / emb.shape[0]
        return logits, losses


common.register_model("DIN", DINConfig, DIN)
