"""ESMM: Entire Space Multi-task Model (CTR and CTCVR over the whole space).

Counterpart of ``recalgorithm_tpu/models/esmm.py`` (the reference README
lists ESMM but ships no implementation).  On the WeChat labels: pCTR =
P(read_comment) from ``ctr_tower``; pCVR = P(cvr_label | read_comment) from
``cvr_tower``; pCTCVR = pCTR * pCVR, trained over the whole space against
the joint label.  Both towers share one embedding collection.  The CTCVR
head returns the log-odds of the product probability, computed stably from
log-sigmoids: log p - log1p(-clip(p, 0, 1 - 1e-7)) with log p =
logsigmoid(ctr) + logsigmoid(cvr).  Tasks: ``read_comment`` (CTR) and
``ctcvr``, whose label ``derived_label`` makes: read_comment x cvr_label.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.mlp import MLPTower


@dataclasses.dataclass(frozen=True)
class ESMMConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    cvr_label: str = "like"  # the post-click action defining CVR
    task_names: tuple[str, ...] = ("read_comment", "ctcvr")


class ESMM(nn.Module):
    """Submodules carry the flax names: ``embedder``, ``ctr_tower``,
    ``cvr_tower``."""

    def __init__(self, config: ESMMConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        self.embedder, width = wd_embedder(schema, generator)
        tower = dict(dropout_rate=config.dropout_rate, batch_norm=config.batch_norm,
                     logits_dim=1, generator=generator, compute_dtype=dt)
        self.ctr_tower = MLPTower(width, config.hidden_units, **tower)
        self.cvr_tower = MLPTower(width, config.hidden_units, **tower)

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        x = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        ctr_logit = self.ctr_tower(x)[:, 0]
        cvr_logit = self.cvr_tower(x)[:, 0]
        log_p = F.logsigmoid(ctr_logit) + F.logsigmoid(cvr_logit)
        ctcvr_logit = log_p - torch.log1p(-log_p.exp().clamp(0.0, 1.0 - 1e-7))
        return {"read_comment": ctr_logit, "ctcvr": ctcvr_logit}, {}

    def derived_label(self, task: str, batch) -> torch.Tensor:
        """The ctcvr label: read_comment AND cvr_label (the joint label)."""
        if task != "ctcvr":
            raise KeyError(task)
        idx = {n: i for i, n in enumerate(self.schema.labels)}
        return (batch["labels"][:, idx["read_comment"]]
                * batch["labels"][:, idx[self.config.cvr_label]])


common.register_model("ESMM", ESMMConfig, ESMM)
