"""The layers both references share, in plain torch."""

from __future__ import annotations

import torch


def linear(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b`` with ``W`` = ``<name>.weight`` (out, in)."""
    return x @ params[name + ".weight"].T + params[name + ".bias"]


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``; id 0 (padding) gives a zero row.  The
    benchmark's ids lie in [0, vocabulary], inside every table."""
    return table[ids.long()] * (ids > 0).unsqueeze(-1).to(table.dtype)


def mean_pool(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Mean of the rows of the ids > 0 of each (B, T) row; zeros for a row
    with none."""
    count = (ids > 0).sum(dim=1, keepdim=True).clamp(min=1).to(table.dtype)
    return lookup(table, ids).sum(dim=1) / count


def categories(params: dict, schema: dict, batch: dict) -> torch.Tensor:
    """The category fields' embeddings, concatenated in the configuration's
    order (scalar fields looked up, list fields mean-pooled)."""
    out = []
    for field, vocab, kind in schema["category_fields"]:
        table = params[f"embedder.embed.tables.{vocab}"]
        out.append(lookup(table, batch[field]) if kind == "scalar"
                   else mean_pool(table, batch[field]))
    return torch.cat(out, dim=-1)


def batch_norm_train(params: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised by the batch's mean and biased variance, then scaled."""
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * params[name + ".weight"] + params[name + ".bias"]


def batch_norm_eval(params: dict, name: str, x: torch.Tensor, eps: float,
                    affine: bool = True) -> torch.Tensor:
    """Normalised by the running statistics."""
    y = (x - params[name + ".running_mean"]) / torch.sqrt(params[name + ".running_var"] + eps)
    return y * params[name + ".weight"] + params[name + ".bias"] if affine else y


def layer_norm(params: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * params[name + ".weight"] + params[name + ".bias"]


def leaky_relu(x: torch.Tensor, leak: float) -> torch.Tensor:
    return torch.where(x >= 0, x, leak * x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep with probability 1 - rate, scaled by 1 / (1 - rate).  The mask is
    ``rand >= rate`` from ``generator``: the same draw, in the same order,
    as the trainer's dropout stream, so the masks are the program's."""
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


class Adam:
    """Adam with bias-corrected moments, eps outside the square root:
    ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = torch.sqrt(self.v[k]) / c2 ** 0.5 + self.eps
            params[k] -= self.lr / c1 * self.m[k] / denom
