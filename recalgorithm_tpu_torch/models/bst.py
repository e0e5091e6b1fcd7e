"""BST: Behavior Sequence Transformer.

Counterpart of ``recalgorithm_tpu/models/bst.py``.  Reference:
algorithm/BST/bst.py — target + behaviour sequence concatenated to
(B, T+1, K) with the target at slot 0 (L184); ``num_transformer_block``
transformer blocks with keys_length+1 (L186-194, transformer_layer.py);
sum/mean pooling over the sequence axis (L195-198), over all T+1 positions,
padded ones included; concat(dense, category, pooled) -> MLP (L200-211).
Parity quirk reproduced: the reference's dnn_part applies NO activation
between dense layers (bst.py:205, dense(.., activation=None) -> BN ->
dropout); ``mlp_activation`` defaults to "none" accordingly, set "relu" for
the conventional tower.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.din import DIN_CATEGORY_FIELDS
from recalgorithm_tpu_torch.ops.activations import Dropout, batch_norm
from recalgorithm_tpu_torch.ops.attention import BSTTransformerBlock
from recalgorithm_tpu_torch.ops.mlp import Dense

SEQ = "his_read_comment_7d_seq"


@dataclasses.dataclass(frozen=True)
class BSTConfig(common.TrainFlags):
    """BST flags.  The JAX package's ``use_fused_attention``,
    ``attn_interpret`` and ``kernel_layout_attn`` have no counterpart: here
    the tensors' device picks the kernels (CUDA) or the plain twin (CPU), in
    one (B, H, T, d) layout.  ``save_attn_bf16`` rounds the probabilities the
    training forward saves to bf16 (gradients only)."""

    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    sequence_max_length: int = 50
    num_transformer_block: int = 1
    num_transformer_heads: int = 3
    pooling_method: str = "sum"  # {'sum', 'mean'}
    save_attn_bf16: bool = False
    mlp_activation: str = "none"  # reference parity; "relu" for standard MLP
    task_names: tuple[str, ...] = ("read_comment",)


class BST(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``transformer_<i>``,
    ``dense_<i>``, ``bn_<i>``, ``logit``."""

    def __init__(self, config: BSTConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        config.compute_dtype  # raises for precisions not ported yet
        self.config = config
        self.schema = schema
        tables = common.wd_tables(schema)
        self.embedder = common.FieldEmbedder(tables, DIN_CATEGORY_FIELDS, generator)
        item_dim = tables["feedid"].dim
        self.num_blocks = config.num_transformer_block
        for i in range(self.num_blocks):
            self.add_module(f"transformer_{i}", BSTTransformerBlock(
                item_dim, config.num_transformer_heads,
                config.sequence_max_length + 1,
                save_attn_bf16=config.save_attn_bf16, generator=generator))
        self._tower: list[str] = []
        width = (len(schema.dense)
                 + sum(tables[v].dim for _, v, _ in DIN_CATEGORY_FIELDS) + item_dim)
        for i, unit in enumerate(config.hidden_units):
            self._add(f"dense_{i}", Dense(width, unit, generator))
            if config.mlp_activation == "relu":
                self._add(f"relu_{i}", nn.ReLU())
            if config.batch_norm:
                self._add(f"bn_{i}", batch_norm(unit))
            if 0.0 < config.dropout_rate < 1.0:
                self._add(f"dropout_{i}", Dropout(config.dropout_rate))
            width = unit
        self.logit = Dense(width, 1, generator)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._tower.append(name)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        embed = self.embedder.embed
        category = torch.cat(self.embedder(batch), dim=-1)
        target = embed.embed_scalar("feedid", batch["feedid"])  # (B, K)
        seq = embed.embed_sequence("feedid", batch[SEQ])        # (B, T, K)
        lengths = batch[SEQ + "_len"] + 1                       # the target slot
        x = torch.cat([target[:, None, :], seq], dim=1)         # (B, T+1, K)
        for i in range(self.num_blocks):
            x = getattr(self, f"transformer_{i}")(x, lengths)
        pooled = x.sum(dim=1) if self.config.pooling_method == "sum" else x.mean(dim=1)
        net = torch.cat([batch["dense"], category, pooled], dim=-1)
        for name in self._tower:
            net = getattr(self, name)(net)
        return {"read_comment": self.logit(net)[:, 0]}, {}


common.register_model("BST", BSTConfig, BST)
