"""Dense towers with reference-parity layer ordering and initialisation.

Counterpart of ``recalgorithm_tpu/ops/mlp.py``: TF-default initialisers
(glorot_uniform kernels, zero biases) and the reference's per-layer recipe
(wide_and_deep.py:216-221, tower_layer.py:19-25)

    dense(units, relu) -> dropout(rate, if training) -> batch_norm(training)

i.e. post-activation BN applied after dropout.  The JAX ``MLPTower``'s
``activation`` (dice / prelu / a callable) has no counterpart: no model
calls the tower with another activation.

Mixed precision (``compute_dtype=torch.bfloat16``, the ``precision="bf16"``
flag): each hidden layer's product runs in bf16 with the parameters kept in
f32, as flax ``Dense(dtype=bf16)``: the input, weight and bias are rounded
to bf16, the product is rounded to bf16 (one ``F.linear`` without the bias,
f32 accumulation: cuBLAS's bf16 GEMM on the card), the bias is added in
bf16, a second rounding, and the result goes back to f32.  torch lets
cuBLAS reduce a bf16 GEMM's split-K partial sums in bf16
(``allow_bf16_reduced_precision_reduction``, True by default), so building
a bf16 ``Dense`` turns that off for the process: its product then sums in
f32 all the way, as the JAX package's does.  A fused
``F.linear(x, w, b)`` would round once; the port keeps the JAX package's two
roundings.  The logit head stays f32, as there.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recalgorithm_tpu_torch.ops.activations import Dropout, batch_norm


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


def glorot_param(*shape: int, generator: torch.Generator | None = None) -> nn.Parameter:
    """A raw parameter of ``shape`` in the flax layout, glorot_uniform."""
    return nn.Parameter(glorot_uniform_(torch.empty(shape), generator))


class Dense(nn.Linear):
    """nn.Linear with a glorot_uniform weight and a zero bias (none with
    ``bias=False``, flax ``use_bias=False``); with ``compute_dtype`` the
    product runs in that dtype (module docstring) and the output is f32.

    The weight is ``(out, in)``: the transpose of the flax kernel.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None, bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        if compute_dtype is torch.bfloat16:  # f32 sums in cuBLAS's bf16 GEMM
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))  # the product, rounded to dt
        if self.bias is not None:
            y = y + self.bias.to(dt)                # the bias add, rounded again
        return y.to(torch.float32)


def add_tower(parent: nn.Module, in_features: int, hidden_units: Sequence[int],
              dropout_rate: float, batch_norm_: bool,
              generator: torch.Generator | None = None,
              compute_dtype: torch.dtype | None = None) -> tuple[list[str], int]:
    """Register ``dense_<i>`` -> relu -> ``dropout_<i>`` -> ``bn_<i>`` per
    hidden layer on ``parent`` (the flax names; dropout only when 0 < rate <
    1, BN with running statistics, eps 1e-3, flax momentum 0.99; each dense
    in ``compute_dtype``).  Returns the submodule names in call order and
    the output width."""
    order, width = [], in_features
    for i, units in enumerate(hidden_units):
        layers = [(f"dense_{i}", Dense(width, units, generator, compute_dtype=compute_dtype)),
                  (f"relu_{i}", nn.ReLU())]
        if 0.0 < dropout_rate < 1.0:
            layers.append((f"dropout_{i}", Dropout(dropout_rate)))
        if batch_norm_:
            layers.append((f"bn_{i}", batch_norm(units)))
        for name, module in layers:
            parent.add_module(name, module)
            order.append(name)
        width = units
    return order, width


class MLPTower(nn.Module):
    """Hidden stack: [dense-relu -> dropout -> BN] * N, then with
    ``logits_dim`` a final linear ``logits`` layer with no activation,
    dropout or BN (the reference's Dense(1) head, f32 under any
    ``compute_dtype``)."""

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 dropout_rate: float = 0.0, batch_norm: bool = False,
                 logits_dim: int | None = None,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self._order, self.out_features = add_tower(
            self, in_features, hidden_units, dropout_rate, batch_norm, generator,
            compute_dtype)
        if logits_dim is not None:
            self.logits = Dense(self.out_features, logits_dim, generator)
            self._order.append("logits")
            self.out_features = logits_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._order:
            x = getattr(self, name)(x)
        return x


class ResidualUnit(nn.Module):
    """DeepCrossing residual block (reference residual_unit.py:4-21):
    y = relu(x + outer(relu(inner(x))))."""

    def __init__(self, dim: int, internal_dim: int,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.inner = Dense(dim, internal_dim, generator, compute_dtype=compute_dtype)
        self.outer = Dense(internal_dim, dim, generator, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.outer(torch.relu(self.inner(x))))
