"""MMOE: multi-gate mixture of experts for multi-task CTR.

Counterpart of ``recalgorithm_tpu/models/mmoe.py``.  Reference:
algorithm/MMOE/mmoe.py — input = concat(dense, the W&D-family embeddings)
(L199-205); ``num_experts`` one-layer relu experts, here one (E, in, H)
einsum (L208-216); a bias-free softmax gate per task (L218-224); the
gate-weighted expert mix -> a tower per task (L227-248); loss = the sum of
the per-task mean sigmoid CE (L261-263).  In train mode ``sown`` holds each
gate's batch-mean weights for the trainer's summaries (the reference's
LoggingTensorHook, L294-309).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.experts import (
    ExpertGroup,
    SoftmaxGate,
    TaskTower,
    gate_summaries,
    mix_experts,
)


@dataclasses.dataclass(frozen=True)
class MMOEConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)  # tower hidden units
    batch_norm: bool = True
    dropout_rate: float = 0.1
    num_experts: int = 3
    expert_hidden_units: int = 512
    task_names: tuple[str, ...] = ("read_comment", "like", "click_avatar")


class MMOE(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``experts``,
    ``gate_<task>``, ``tower_<task>``."""

    def __init__(self, config: MMOEConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, width = wd_embedder(schema, generator)
        self.experts = ExpertGroup(config.num_experts, width, config.expert_hidden_units,
                                   generator, dt)
        for task in config.task_names:
            self.add_module(f"gate_{task}", SoftmaxGate(width, config.num_experts, generator))
            self.add_module(f"tower_{task}", TaskTower(
                config.expert_hidden_units, config.hidden_units, config.dropout_rate,
                config.batch_norm, generator, dt))

    @property
    def sown(self) -> dict[str, torch.Tensor]:
        return gate_summaries(self)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        experts = self.experts(x)  # (B, E, H)
        out = {}
        for task in self.config.task_names:
            mixed = mix_experts(experts, getattr(self, f"gate_{task}")(x))
            out[task] = getattr(self, f"tower_{task}")(mixed)[:, 0]
        return out, {}


common.register_model("MMOE", MMOEConfig, MMOE)
