"""GDCN: Gated Deep & Cross Network (beyond-reference addition).

Counterpart of ``recalgorithm_tpu/models/gdcn.py``: Wang et al., CIKM'23
(arXiv:2311.04635) — DCNv2's cross layers with a learned sigmoid gate per
dimension, ``x_{l+1} = x0 * (W x_l + b) * sigmoid(G x_l) + x_l``, on DCN's
feature surface, wired 'parallel' or 'stacked' as DCNv2 (GDCN-P / GDCN-S).
"""

from __future__ import annotations

import dataclasses

from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn_v2 import DCNv2
from recalgorithm_tpu_torch.ops.interactions import CrossNetworkV2


@dataclasses.dataclass(frozen=True)
class GDCNConfig(common.TrainFlags):
    hidden_units: tuple[int, ...] = (512, 256, 128)
    num_cross_layer: int = 3  # gating is what makes depth pay (paper §4.3)
    structure: str = "parallel"  # 'parallel' (GDCN-P) | 'stacked' (GDCN-S)
    batch_norm: bool = True
    dropout_rate: float = 0.1
    task_names: tuple[str, ...] = ("read_comment",)


class GDCN(DCNv2):
    """DCNv2's wiring with the gated cross stack ``gated_cross``."""

    cross_name = "gated_cross"

    @staticmethod
    def cross_network(d: int, config, generator) -> CrossNetworkV2:
        return CrossNetworkV2(d, config.num_cross_layer, gated=True, generator=generator)


common.register_model("GDCN", GDCNConfig, GDCN)
