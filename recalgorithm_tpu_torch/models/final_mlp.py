"""FinalMLP: two-stream MLP with feature gating and bilinear fusion
(beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/final_mlp.py``: Mao et al. 2023
(arXiv:2304.00902) on the FiBiNET surface (dense + PNN's 8 fields).  Per
stream, a feature-selection gate conditioned on a field group (user-side
fields for stream 1, item-side for stream 2, §3.2) reweights the shared
flat embedding, an MLP tower digests it, and the two stream outputs combine
through the multi-head bilinear fusion (§3.3).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.pnn import PNN_FIELDS, pnn_embedder
from recalgorithm_tpu_torch.ops.interactions import BilinearFusion
from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower


@dataclasses.dataclass(frozen=True)
class FinalMLPConfig(common.TrainFlags):
    embedding_dim: int = 16
    # stream towers (paper's MLP1/MLP2; symmetric by default)
    hidden_units: tuple[int, ...] = (256, 128)
    stream2_hidden_units: tuple[int, ...] | None = None  # None = same as 1
    batch_norm: bool = True
    dropout_rate: float = 0.1
    # feature-selection conditioning groups (§3.2): batch keys whose field
    # embeddings drive each stream's gate; empty = a learned static context
    fs1_fields: tuple[str, ...] = ("userid", "device")
    fs2_fields: tuple[str, ...] = ("feedid", "authorid")
    fs_hidden_units: tuple[int, ...] = (64,)
    fusion_heads: int = 2
    task_names: tuple[str, ...] = ("read_comment",)


class FeatureSelection(nn.Module):
    """Gate = 2*sigmoid(MLP(context)) applied elementwise to the flat
    embedding (§3.2): ``fs_<i>`` relu layers, then ``fs_gate``.  The factor 2
    keeps an untrained gate's expected scale at 1."""

    def __init__(self, ctx_dim: int, hidden_units: Sequence[int], flat_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_hidden = len(hidden_units)
        width = ctx_dim
        for i, units in enumerate(hidden_units):
            self.add_module(f"fs_{i}", Dense(width, units, generator))
            width = units
        self.fs_gate = Dense(width, flat_dim, generator)

    def forward(self, flat: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        g = ctx
        for i in range(self.num_hidden):
            g = torch.relu(getattr(self, f"fs_{i}")(g))
        return flat * (2.0 * torch.sigmoid(self.fs_gate(g)))


class FinalMLP(nn.Module):
    """Submodules and parameters carry the flax names: ``embedder``,
    ``fs1``/``fs2``, ``ctx1``/``ctx2`` (zeros, only where that stream's
    field group is empty), ``stream1``/``stream2``, ``fusion``."""

    def __init__(self, config: FinalMLPConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        self.embedder = pnn_embedder(schema, k, generator)
        flat_dim = len(schema.dense) + len(PNN_FIELDS) * k
        towers = (config.hidden_units, config.stream2_hidden_units or config.hidden_units)
        for s, keys, units in zip((1, 2), (config.fs1_fields, config.fs2_fields), towers):
            if not keys:
                self.register_parameter(f"ctx{s}", nn.Parameter(torch.zeros(k)))
            self.add_module(f"fs{s}", FeatureSelection(
                len(keys) * k if keys else k, config.fs_hidden_units, flat_dim, generator))
            self.add_module(f"stream{s}", MLPTower(
                flat_dim, units, config.dropout_rate, config.batch_norm, generator=generator,
                compute_dtype=dt))
        self.fusion = BilinearFusion(self.stream1.out_features, self.stream2.out_features,
                                     config.fusion_heads, generator)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        fields = self.embedder(batch)
        by_key = {key: emb for (key, _, _), emb in zip(PNN_FIELDS, fields)}
        flat = torch.cat([batch["dense"], *fields], dim=-1)
        outs = []
        for s, keys in ((1, cfg.fs1_fields), (2, cfg.fs2_fields)):
            if keys:
                ctx = torch.cat([by_key[key] for key in keys], dim=-1)
            else:  # the learned static context, broadcast over the batch
                ctx = getattr(self, f"ctx{s}").expand(flat.shape[0], -1)
            gated = getattr(self, f"fs{s}")(flat, ctx)
            outs.append(getattr(self, f"stream{s}")(gated))
        return {"read_comment": self.fusion(*outs)}, {}


common.register_model("FinalMLP", FinalMLPConfig, FinalMLP)
