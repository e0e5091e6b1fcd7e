"""DLRM-DCNv2 (MLPerf Training's recommendation model, torchrec's
``DLRM_DCN``), plain torch, from its configuration file.

    d   = ReLU(L3 ReLU(L2 ReLU(L1 x)))      x: the dense features (log1p'd)
    e_i = sum_j E_i[id_ij]                  each of the 26 features, sum-pooled
    x0  = concat(d, e_1 .. e_26)
    x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l,   l = 0 .. dcn_num_layers - 1
    logit = L_out ReLU(... ReLU(M_1 x_L))   the over arch, its last layer linear

and the loss is the mean sigmoid cross-entropy of the click label.  No batch
norm, no dropout.  ``V_l`` and ``U_l`` are the (width, rank) leaves
``cross.v_<l>`` and ``cross.u_<l>``: ``V_l`` projects down with no bias,
``U_l^T`` back up, and ``b_l`` is the bias.

The optimizer is Adagrad in the program's form (optax's):

    acc += g^2;   p -= lr * g / sqrt(acc + eps)   where acc > 0, else no step

which departs from torchrec's and MLPerf's ``p -= lr * g / (sqrt(acc) + eps)``
in where eps sits; the configuration file states the departure.  With the
accumulator starting at 0, a row no step has touched has acc = 0 and does
not move, as in torchrec's.

Departures from the published model, each stated in the configuration file:
the ids are drawn from one chip's slice of each row-sharded table (ids in
``[1, held rows]``, id 0 the padding row, which no traffic sends), and the
26 features embed in the published order, cat_0 first.
"""

from __future__ import annotations

import torch

from portbench.reference import layers as L


def logits(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """(B,) logits of ``batch`` (device tensors: ``dense``, ``cat_<i>``,
    ``labels``)."""
    x = batch["dense"]
    for i, _ in enumerate(cfg["dense_arch_layer_sizes"]):
        x = torch.relu(L.linear(params, f"bottom.dense_{i}", x))
    pooled = []
    for i, hot in enumerate(cfg["multi_hot_sizes"]):
        rows = L.lookup(params[f"embedder.embed.tables.cat_{i}"], batch[f"cat_{i}"])
        pooled.append(rows.sum(dim=1) if hot > 1 else rows)
    x0 = torch.cat([x, *pooled], dim=-1)
    x = x0
    for layer in range(cfg["dcn_num_layers"]):
        down = x @ params[f"cross.v_{layer}"]
        x = x0 * (down @ params[f"cross.u_{layer}"].T + params[f"cross.b_{layer}"]) + x
    for i, _ in enumerate(cfg["over_arch_layer_sizes"][:-1]):
        x = torch.relu(L.linear(params, f"top.dense_{i}", x))
    return L.linear(params, "logit", x)[:, 0]


def loss(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    return L.bce_with_logits(logits(params, cfg, batch), batch["labels"][:, 0])


class Adagrad:
    """The program's Adagrad (module docstring), one leaf at a time."""

    def __init__(self, params: dict, lr: float, initial: float, eps: float):
        self.lr, self.eps = lr, eps
        self.acc = {k: torch.full_like(p, initial) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        for k, g in grads.items():
            acc = self.acc[k]
            acc += g * g
            scale = torch.where(acc > 0, torch.rsqrt(acc + self.eps), torch.zeros_like(acc))
            params[k] -= self.lr * (scale * g)


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def train(params: dict, cfg: dict, batches: list) -> tuple[list[float], dict, dict]:
    """Adagrad steps on ``batches`` from ``params`` (every leaf, changed in
    place).  Returns each step's loss, the norm of each leaf's first-step
    gradient (the gradients themselves are not kept: at full size they are
    as large as the tables), and the leaves after the last step."""
    opt = cfg["optimizer"]
    adagrad = Adagrad(params, opt["learning_rate"], opt["initial_accumulator_value"],
                      opt["eps"])
    losses, first = [], None
    for batch in batches:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        value = loss(leaves, cfg, batch)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        del leaves
        losses.append(float(value.detach()))
        if first is None:
            first = {k: norm(g) for k, g in grads.items()}
        adagrad.step(params, grads)
        del grads
    return losses, first, params
