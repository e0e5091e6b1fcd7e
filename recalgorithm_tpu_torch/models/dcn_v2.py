"""DCNv2: Deep & Cross Network v2 (beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/dcn_v2.py``: the full-matrix cross
of Wang et al. 2021 (arXiv:2008.13535) on DCN's feature surface.
``structure`` picks the paper's two wirings: 'parallel' (cross stack and MLP
side by side, concatenated into the logit) or 'stacked' (the MLP consumes
the cross output).  ``cross_low_rank > 0`` switches every cross layer to the
DCN-Mix low-rank factorisation.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.interactions import CrossNetworkV2
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class DCNv2Config(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)
    num_cross_layer: int = 2
    cross_low_rank: int = 0  # 0 = full (d, d) matrices; > 0 = DCN-Mix rank
    structure: str = "parallel"  # 'parallel' | 'stacked'
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class DCNv2(nn.Module):
    """Submodules carry the flax names: ``embedder``, the cross stack
    (``cross_name``), ``deep``, ``logit``.  GDCN reuses this wiring with its
    gated cross."""

    cross_name = "cross_v2"

    def __init__(self, config, schema: Schema, generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        if config.structure not in ("parallel", "stacked"):
            raise ValueError(f"structure must be parallel/stacked, got {config.structure!r}")
        self.config = config
        self.schema = schema
        self.embedder, d = wd_embedder(schema, generator)
        self.add_module(self.cross_name, self.cross_network(d, config, generator))
        self.deep = MLPTower(d, config.hidden_units, config.dropout_rate,
                             config.batch_norm, generator=generator, compute_dtype=dt)
        parallel = config.structure == "parallel"
        self.logit = Dense(d * parallel + self.deep.out_features, 1, generator)

    @staticmethod
    def cross_network(d: int, config, generator) -> CrossNetworkV2:
        return CrossNetworkV2(d, config.num_cross_layer, low_rank=config.cross_low_rank,
                              generator=generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x0 = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        cross_out = getattr(self, self.cross_name)(x0)
        if self.config.structure == "stacked":
            logit_in = self.deep(cross_out)
        else:
            logit_in = torch.cat([cross_out, self.deep(x0)], dim=-1)
        return {"read_comment": self.logit(logit_in)[:, 0]}, {}


common.register_model("DCNv2", DCNv2Config, DCNv2)
