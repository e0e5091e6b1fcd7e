"""Dense layers with reference-parity initialisation.

Counterpart of ``recalgorithm_tpu/ops/mlp.py`` (``Dense`` and
``glorot_uniform`` so far): TF-default initialisers, glorot_uniform kernels
and zero biases.
"""

from __future__ import annotations

import torch
from torch import nn


def glorot_uniform_(t: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``glorot_uniform`` on a raw parameter: fan_in = shape[-2] and
    fan_out = shape[-1], each times the product of the leading dims (an
    (H, d, d) tensor has fan_in = fan_out = H*d).  ``xavier_uniform_`` counts
    fans the other way round for such a tensor, hence this helper."""
    receptive = 1
    for n in t.shape[:-2]:
        receptive *= n
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Linear):
    """nn.Linear with a glorot_uniform weight and a zero bias.

    The weight is ``(out, in)``: the transpose of the flax kernel.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, out_features)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)
            self.bias.zero_()
