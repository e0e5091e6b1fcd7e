"""Multi-task expert mixing: MMOE gates and experts, task towers, PLE extraction.

Counterpart of ``recalgorithm_tpu/ops/experts.py``.  All experts of a group
are one stacked ``(E, in, H)`` parameter contracted by one einsum (one
batched matmul instead of E small ones); the parameter keeps the flax name
``kernel`` and its 3-D layout, so ``convert`` carries it untransposed.
``SoftmaxGate`` is a bias-free Dense (its 2-D ``kernel`` is transposed as any
Dense's).  In train mode a gate keeps the batch mean of its weights, which
the models hand to the trainer's summaries (``model.sown``) as the JAX gates
sow them into ``summaries``.

Mixed precision (``compute_dtype``): the expert contraction takes bf16
operands and accumulates in f32 (the JAX einsum's
``preferred_element_type=f32``), and the bias is added in f32.  torch has no
bf16 x bf16 -> f32 contraction on the CPU, so the port rounds the input and
the kernel to bf16 and contracts the rounded values in f32: each product of
two bf16 values is exact in f32, so this is the JAX contraction up to
summation order (on the card an f32 GEMM, TF32 off).  The gates and towers'
logits stay f32.

Under a process mesh (the trainer calls :meth:`ExpertGroup.shard_`) a group
whose E divides the model axis keeps E / model experts on each rank of a
data row, and the rank's expert outputs are gathered over the row with a
differentiable all-gather before the gates mix them (the JAX package's
expert parallelism, there derived by the partitioner); a group whose E does
not divide stays whole on every rank.  A gate's ``gate_mean`` is then the
global batch's mean.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recalgorithm_tpu_torch.ops.mlp import Dense, MLPTower, glorot_param
from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
from recalgorithm_tpu_torch.parallel import multihost


class ExpertGroup(nn.Module):
    """E parallel one-layer relu experts: (B, in) -> (B, E, H)
    (reference mmoe.py:208-216).  ``weights()`` returns the (E, in, H)
    kernel and (E, H) bias without computing, so a parent can stack several
    groups into one einsum while each group keeps its own parameters."""

    def __init__(self, num_experts: int, in_dim: int, hidden_units: int,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.kernel = glorot_param(num_experts, in_dim, hidden_units, generator=generator)
        self.bias = nn.Parameter(torch.zeros(num_experts, hidden_units))
        self.compute_dtype = compute_dtype
        self.mesh = None  # set by shard_ when the experts are split over ranks

    def shard_(self, mesh) -> dict[str, str]:
        """Keep this rank's ``E / model`` experts when E divides the model
        axis (and it is larger than 1); otherwise stay whole.  Returns the
        parameter names it split, each ``mesh_lib.EXPERT``."""
        m = mesh.num_model
        e = self.kernel.shape[0]
        if m == 1 or e % m:
            return {}
        lo, hi = mesh.model_index * e // m, (mesh.model_index + 1) * e // m
        for p in (self.kernel, self.bias):
            p.data = p.data[lo:hi].clone()
        self.mesh = mesh
        return {"kernel": mesh_lib.EXPERT, "bias": mesh_lib.EXPERT}

    def weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.kernel, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in) -> (B, E, H).  Sharded: this rank's experts run on ``x``
        and their outputs are gathered over the data row; ``x``'s gradient
        through the experts is summed over the row, since each rank's
        experts see only their own part of it."""
        if self.mesh is None:
            return run_experts(x, self.kernel, self.bias, self.compute_dtype)
        mesh = self.mesh
        h = run_experts(multihost.sum_grads(x, mesh.model_group), self.kernel, self.bias,
                        self.compute_dtype)
        return multihost.gather_rows(h.transpose(0, 1), mesh.model_group, mesh.num_model,
                                     mesh.model_index, replicated=True).transpose(0, 1)


def run_experts(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """relu(einsum('bi,eih->beh') + bias): (B, in) -> (B, E, H); with
    ``compute_dtype`` the operands rounded to it, contracted in f32."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).to(torch.float32)
        kernel = kernel.to(compute_dtype).to(torch.float32)
    return torch.relu(torch.einsum("bi,eih->beh", x, kernel) + bias)


def stacked_experts(x: torch.Tensor, groups: Sequence[ExpertGroup]) -> torch.Tensor:
    """Every group's experts as one einsum: (B, sum E, H), slots in group
    order.  With a group sharded over a process mesh each group runs on its
    own (:meth:`ExpertGroup.forward`)."""
    if any(g.mesh is not None for g in groups):
        return torch.cat([g(x) for g in groups], dim=1)
    kernels, biases = zip(*(g.weights() for g in groups))
    return run_experts(x, torch.cat(kernels, dim=0), torch.cat(biases, dim=0),
                       groups[0].compute_dtype)


class SoftmaxGate(Dense):
    """Bias-free softmax gate over experts (reference mmoe.py:218-224):
    (B, in) -> (B, E).  In train mode ``gate_mean`` holds the batch mean of
    the gate weights (the JAX gate's sown ``gate_mean``)."""

    def __init__(self, in_dim: int, num_experts: int,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, num_experts, generator, bias=False)
        self.gate_mean: torch.Tensor | None = None
        self.mesh = None  # the global batch's mean under a process mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.softmax(super().forward(x), dim=-1)
        if self.training:
            mean = gate.detach().mean(dim=0)
            if self.mesh is not None and self.mesh.data_size > 1:
                mean = multihost.all_reduce_sum(mean, self.mesh.data_group) / self.mesh.data_size
            self.gate_mean = mean
        return gate


def gate_summaries(model: nn.Module) -> dict[str, torch.Tensor]:
    """``{<gate path>/gate_mean: (E,)}`` of every SoftmaxGate of ``model`` that
    ran in train mode (the JAX summaries' tags)."""
    return {f"{name.replace('.', '/')}/gate_mean": m.gate_mean
            for name, m in model.named_modules()
            if isinstance(m, SoftmaxGate) and m.gate_mean is not None}


def mix_experts(experts: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(B, E, H), (B, E) -> (B, H) gate-weighted expert mixture."""
    return torch.einsum("beh,be->bh", experts, gate)


class TaskTower(nn.Module):
    """Per-task head: MLP (relu, dropout, BN) -> 1 logit (tower_layer.py:4-28).
    The tower sits at ``MLPTower_0``, the JAX module's auto-name."""

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 dropout_rate: float = 0.1, batch_norm: bool = True,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.MLPTower_0 = MLPTower(in_features, hidden_units, dropout_rate, batch_norm,
                                   logits_dim=1, generator=generator,
                                   compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MLPTower_0(x)


class ExtractionNetwork(nn.Module):
    """PLE CGC block (reference extraction_network.py:4-85): (B, in) -> (B, H).

    Per task a gate over (task experts ++ shared experts), plus one gate over
    all experts.  Reference quirk kept: the per-task mixtures and the
    all-experts mixture are *summed* into one tensor (extraction_network.py:85),
    so the block is linear in the gate weights: all experts run as one stacked
    einsum, each gate's weights add into per-slot effective weights, and the
    experts are mixed once."""

    def __init__(self, in_dim: int, task_names: Sequence[str],
                 num_experts_per_task: Sequence[int], num_experts_in_shared: int,
                 expert_hidden_units: int, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.task_names = tuple(task_names)
        self.num_experts_per_task = tuple(num_experts_per_task)
        self.num_experts_in_shared = num_experts_in_shared
        for task, n in zip(self.task_names, self.num_experts_per_task):
            self.add_module(f"experts_{task}", ExpertGroup(
                n, in_dim, expert_hidden_units, generator, compute_dtype))
        self.experts_shared = ExpertGroup(num_experts_in_shared, in_dim,
                                          expert_hidden_units, generator, compute_dtype)
        self.all_gate = SoftmaxGate(in_dim, sum(self.num_experts_per_task)
                                    + num_experts_in_shared, generator)
        for task, n in zip(self.task_names, self.num_experts_per_task):
            self.add_module(f"gate_{task}",
                            SoftmaxGate(in_dim, n + num_experts_in_shared, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        groups = [getattr(self, f"experts_{t}") for t in self.task_names]
        h = stacked_experts(x, groups + [self.experts_shared])  # (B, sumE, H)
        task_parts, shared = [], 0.0
        for task, n in zip(self.task_names, self.num_experts_per_task):
            gate = getattr(self, f"gate_{task}")(x)
            task_parts.append(gate[:, :n])
            shared = shared + gate[:, n:]
        w_eff = self.all_gate(x) + torch.cat(task_parts + [shared], dim=1)
        return mix_experts(h, w_eff)
