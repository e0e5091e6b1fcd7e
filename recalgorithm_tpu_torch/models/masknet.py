"""MaskNet: instance-guided multiplicative masks over the embedding
(beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/masknet.py``: Wang et al. 2021
(arXiv:2102.07619) on the FiBiNET surface (dense + PNN's 8 fields).  The
field embeddings are LayerNorm'd per field (LN-EMB, §3.1) and flattened,
then fed through ``num_blocks`` MaskBlocks, each masking its input with a
mask generated from concat(dense, raw flat embedding).  ``parallel``
(MaskNet-P): every block masks the LN'd embedding and an MLP head reads
their outputs with the dense features; ``serial`` (MaskNet-S): the blocks
chain and a Dense(1) reads the last one with the dense features.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.attention import LAYER_NORM_EPS
from recalgorithm_tpu_torch.ops.interactions import MaskBlock
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class MaskNetConfig(common.TrainFlags):
    embedding_dim: int = 16
    block_mode: str = "parallel"  # 'parallel' (MaskNet-P) or 'serial' (-S)
    num_blocks: int = 3
    block_output_size: int = 64
    mask_agg_ratio: float = 2.0  # mask bottleneck = ratio * flat-emb dim
    hidden_units: tuple[int, ...] = (128, 64)  # parallel-mode head MLP
    batch_norm: bool = False  # paper uses LN inside blocks; head stays lean
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class MaskNet(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``ln_emb`` (flax's
    LayerNorm, eps 1e-6), ``block_<i>``, then ``head`` (parallel) or
    ``logit`` (serial)."""

    def __init__(self, config: MaskNetConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        if config.block_mode not in ("parallel", "serial"):
            raise ValueError(f"unknown block_mode {config.block_mode!r}")
        self.config = config
        self.schema = schema
        k, n_dense = config.embedding_dim, len(schema.dense)
        self.embedder = pnn_embedder(schema, k, generator)
        self.ln_emb = nn.LayerNorm(k, eps=LAYER_NORM_EPS)
        flat_dim = len(PNN_FIELDS) * k
        agg_size = int(config.mask_agg_ratio * flat_dim)
        out = config.block_output_size
        serial = config.block_mode == "serial"
        for i in range(config.num_blocks):
            hidden_dim = out if serial and i > 0 else flat_dim
            self.add_module(f"block_{i}", MaskBlock(hidden_dim, n_dense + flat_dim, out,
                                                    agg_size, generator))
        if serial:
            self.logit = Dense(out + n_dense, 1, generator)
        else:
            self.head = MLPTower(config.num_blocks * out + n_dense, config.hidden_units,
                                 config.dropout_rate, config.batch_norm, logits_dim=1,
                                 generator=generator, compute_dtype=dt)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        field_emb = common.stack_fields(self.embedder(batch))  # (B, F, K)
        ln_flat = self.ln_emb(field_emb).flatten(1)
        mask_input = torch.cat([batch["dense"], field_emb.flatten(1)], dim=-1)
        blocks = [getattr(self, f"block_{i}") for i in range(cfg.num_blocks)]
        if cfg.block_mode == "parallel":
            x = torch.cat([b(ln_flat, mask_input) for b in blocks] + [batch["dense"]], dim=-1)
            logit = self.head(x)[:, 0]
        else:
            x = ln_flat
            for b in blocks:
                x = b(x, mask_input)
            logit = self.logit(torch.cat([x, batch["dense"]], dim=-1))[:, 0]
        return {"read_comment": logit}, {}


common.register_model("MaskNet", MaskNetConfig, MaskNet)
