"""Shared-Bottom: the hard-parameter-sharing multi-task baseline.

Counterpart of ``recalgorithm_tpu/models/shared_bottom.py`` (beyond the
reference, which ships MMOE and PLE but not the baseline both papers compare
against): concat(dense, the W&D-family embeddings), MMOE's input, through
ONE shared bottom MLP (relu -> dropout -> BN), then a TaskTower per task.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.experts import TaskTower
from recalgorithm_tpu_torch.ops.mlp import MLPTower


@dataclasses.dataclass(frozen=True)
class SharedBottomConfig(common.TrainFlags):
    bottom_hidden_units: tuple[int, ...] = (512, 256)
    hidden_units: tuple[int, ...] = (128, 64)  # per-task tower units
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment", "like", "click_avatar")


class SharedBottom(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``bottom``,
    ``tower_<task>``."""

    def __init__(self, config: SharedBottomConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, width = wd_embedder(schema, generator)
        self.bottom = MLPTower(width, config.bottom_hidden_units, config.dropout_rate,
                               config.batch_norm, generator=generator, compute_dtype=dt)
        for task in config.task_names:
            self.add_module(f"tower_{task}", TaskTower(
                self.bottom.out_features, config.hidden_units, config.dropout_rate,
                config.batch_norm, generator, dt))

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        shared = self.bottom(torch.cat([batch["dense"], *self.embedder(batch)], dim=-1))
        return {task: getattr(self, f"tower_{task}")(shared)[:, 0]
                for task in self.config.task_names}, {}


common.register_model("SharedBottom", SharedBottomConfig, SharedBottom)
