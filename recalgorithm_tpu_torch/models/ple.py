"""PLE: Progressive Layered Extraction for multi-task CTR.

Counterpart of ``recalgorithm_tpu/models/ple.py``.  Reference:
algorithm/PLE/ple.py — input = concat(dense, the W&D-family embeddings)
(L160-169); ``num_extract_network`` stacked extraction networks (L172-180,
with the reference's sum of the per-task and all-expert mixtures,
``ops/experts.ExtractionNetwork``); a final CGC layer with a gate per task
over (task ++ shared) experts feeding a tower per task (L183-236).  The
final expert groups run as one stacked einsum, each task's mix slicing its
(task ++ shared) slots out of it.  In train mode ``sown`` holds every gate's
batch-mean weights.
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
    ExtractionNetwork,
    SoftmaxGate,
    TaskTower,
    gate_summaries,
    mix_experts,
    stacked_experts,
)


@dataclasses.dataclass(frozen=True)
class PLEConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)  # tower hidden units
    batch_norm: bool = True
    dropout_rate: float = 0.1
    num_extract_network: int = 1
    num_experts_per_task: tuple[int, ...] = (5, 5, 5)
    num_experts_in_shared: int = 10
    expert_hidden_units: int = 256
    task_names: tuple[str, ...] = ("read_comment", "like", "click_avatar")


class PLE(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``extract_network_<i>``,
    ``experts_final_<task>``, ``experts_shared_final``, ``gate_final_<task>``,
    ``tower_<task>``."""

    def __init__(self, config: PLEConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, width = wd_embedder(schema, generator)
        hidden, shared = config.expert_hidden_units, config.num_experts_in_shared
        for i in range(config.num_extract_network):
            self.add_module(f"extract_network_{i}", ExtractionNetwork(
                width, config.task_names, config.num_experts_per_task, shared, hidden,
                generator, dt))
            width = hidden
        for task, n in zip(config.task_names, config.num_experts_per_task):
            self.add_module(f"experts_final_{task}",
                            ExpertGroup(n, width, hidden, generator, dt))
        self.experts_shared_final = ExpertGroup(shared, width, hidden, generator, dt)
        for task, n in zip(config.task_names, config.num_experts_per_task):
            self.add_module(f"gate_final_{task}", SoftmaxGate(width, n + shared, generator))
            self.add_module(f"tower_{task}", TaskTower(
                hidden, config.hidden_units, config.dropout_rate, config.batch_norm, generator,
                dt))

    @property
    def sown(self) -> dict[str, torch.Tensor]:
        return gate_summaries(self)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        x = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        for i in range(cfg.num_extract_network):
            x = getattr(self, f"extract_network_{i}")(x)
        groups = [getattr(self, f"experts_final_{t}") for t in cfg.task_names]
        h = stacked_experts(x, groups + [self.experts_shared_final])  # (B, sumE, H)
        offs = [0]
        for n in cfg.num_experts_per_task:
            offs.append(offs[-1] + n)
        shared = h[:, offs[-1]:, :]
        out = {}
        for i, task in enumerate(cfg.task_names):
            combined = torch.cat([h[:, offs[i]:offs[i + 1], :], shared], dim=1)
            gate = getattr(self, f"gate_final_{task}")(x)
            out[task] = getattr(self, f"tower_{task}")(mix_experts(combined, gate))[:, 0]
        return out, {}


common.register_model("PLE", PLEConfig, PLE)
