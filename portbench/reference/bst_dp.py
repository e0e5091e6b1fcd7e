"""BST trained data-parallel over N ranks, plain torch: the reference of the
data-parallel cells (``kinds/train_dp.py``), from ``reference/bst.py``'s
functions.

A step takes the global batch whole: rank ``r`` of the program holds its
rows ``[r B, (r+1) B)``.  Batch norm takes the global batch's statistics, as
the program's does over its ranks, and the mean loss is the global batch's.
Each rank's rows take the dropout masks of that rank's stream: a generator
seeded ``dropout_seed + r``, drawn layer by layer in the trainer's order on
its own ``(B, units)`` rows, as the trainer on rank ``r`` draws them.
"""

from __future__ import annotations

import torch

from portbench.reference import bst
from portbench.reference import layers as L


def dropout_by_rank(x: torch.Tensor, rate: float, generators: list) -> torch.Tensor:
    """Each rank's rows of ``x`` with the masks of its own stream."""
    rows = x.shape[0] // len(generators)
    return torch.cat([L.dropout(x[r * rows:(r + 1) * rows], rate, g)
                      for r, g in enumerate(generators)])


def logits(params: dict, cfg: dict, batch: dict, generators: list) -> torch.Tensor:
    """(B,) logits of the global batch in training mode: ``bst.logits``
    with each rank's rows dropped out by that rank's stream."""
    model, schema = cfg["config"], cfg["schema"]
    hist = schema["history"]
    feed = params[f"embedder.embed.tables.{hist['vocab']}"]
    target = L.lookup(feed, batch["feedid"])
    seq = L.lookup(feed, batch[hist["field"]])
    x = torch.cat([target[:, None], seq], dim=1)
    lengths = batch[hist["field"] + "_len"].long() + 1
    for i in range(model["num_transformer_block"]):
        x = bst.block(params, i, x, lengths, model["num_transformer_heads"],
                      cfg["norm_eps"]["layer_norm"], cfg["leaky_relu"])
    pooled = x.sum(dim=1) if model["pooling_method"] == "sum" else x.mean(dim=1)
    net = torch.cat([batch["dense"], L.categories(params, schema, batch), pooled], dim=-1)
    for i, _ in enumerate(model["hidden_units"]):
        net = L.linear(params, f"dense_{i}", net)
        net = L.batch_norm_train(params, f"bn_{i}", net, cfg["norm_eps"]["batch_norm"])
        net = dropout_by_rank(net, model["dropout_rate"], generators)
    return L.linear(params, "logit", net)[:, 0]


def train(params: dict, cfg: dict, batches: list, dropout_seed: int, ranks: int, device
          ) -> tuple[list[float], dict, dict]:
    """Adam steps on the global ``batches`` from ``params`` (trainable leaves
    only, changed in place), rank ``r``'s dropout stream seeded
    ``dropout_seed + r``.  Returns what ``bst.train`` returns."""
    gens = [torch.Generator(device=device).manual_seed(dropout_seed + r) for r in range(ranks)]
    opt = cfg["optimizer"]
    adam = L.Adam(params, cfg["config"]["learning_rate"], opt["b1"], opt["b2"], opt["eps"])
    losses, first = [], None
    for batch in batches:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = L.bce_with_logits(logits(leaves, cfg, batch, gens), batch["labels"][:, 0])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        adam.step(params, grads)
    return losses, first, params
