"""Activation functions with reference parity (DIN dice/prelu, BST leakyrelu).

Counterpart of ``recalgorithm_tpu/ops/activations.py``.
References: algorithm/DIN/activations.py:4-37, algorithm/BST/leakyrelu.py:4-16.
"""

from __future__ import annotations

import torch
from torch import nn


def leakyrelu(x: torch.Tensor, leak: float = 0.01) -> torch.Tensor:
    """Abs-trick leaky ReLU (reference leakyrelu.py:14-16)."""
    return 0.5 * (1 + leak) * x + 0.5 * (1 - leak) * x.abs()


class PReLU(nn.Module):
    """PReLU with per-channel alpha initialised to 1.0 (reference
    activations.py:4-17): the identity at init, as in the reference."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(min=0.0) + self.alpha * x.clamp(max=0.0)


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose training step updates the running statistics
    as flax does: ``running_var`` takes the *biased* batch variance (the one
    that normalised the batch), where torch's own update takes the unbiased
    one.  Eval reads the running statistics, as torch does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        return y


def batch_norm(features: int, affine: bool = True) -> BatchNorm:
    """TF ``batch_normalization`` defaults as flax spells them: eps 1e-3 and
    flax momentum 0.99, which is torch momentum 0.01."""
    return BatchNorm(features, eps=1e-3, momentum=0.01, affine=affine)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate), identity in eval.  The mask is drawn from
    ``self.generator`` (on the input's device) when one is set, so a trainer
    owns the dropout stream and can checkpoint it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class Dice(nn.Module):
    """DIN's Dice activation (reference activations.py:20-37).

    x_norm = BatchNorm(x, no scale/center); p = sigmoid(x_norm);
    out = x * p + alpha * x * (1 - p), with per-channel alpha init 1.0.
    """

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(features))
        self.bn = batch_norm(features, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.bn(x))
        return x * p + self.alpha * x * (1.0 - p)
