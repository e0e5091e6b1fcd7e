"""DIN (Deep Interest Network) in serving, plain torch, from its configuration.

Target attention: for each history position, concat(q, k, q - k, q * k) goes
through a 64-32-1 ReLU MLP to a weight; positions past the history length
weigh 0 (no softmax, as the source's flags have it), and the pooled vector is
the weighted sum of the history.  The tower takes concat(dense, categories,
target, pooled) through dense -> Dice -> BatchNorm per hidden layer, in eval
mode: Dice's and BatchNorm's running statistics, no dropout.  Dice is
``x * p + alpha * x * (1 - p)`` with ``p = sigmoid(norm(x))``, its norm a
BatchNorm without scale or shift.
"""

from __future__ import annotations

import torch

from portbench.reference import layers as L


def target_attention(params: dict, query: torch.Tensor, keys: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    b, t, h = keys.shape
    q = query[:, None, :].expand(b, t, h)
    x = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    x = torch.relu(L.linear(params, "attention.f1_att", x))
    x = torch.relu(L.linear(params, "attention.f2_att", x))
    w = L.linear(params, "attention.f3_att", x)[..., 0]
    w = w * (torch.arange(t, device=keys.device)[None, :] < lengths[:, None]).to(w.dtype)
    return torch.einsum("bt,bth->bh", w, keys)


def logits(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """(B,) eval-mode logits."""
    schema, eps = cfg["schema"], cfg["norm_eps"]["batch_norm"]
    hist = schema["history"]
    feed = params[f"embedder.embed.tables.{hist['vocab']}"]
    target = L.lookup(feed, batch["feedid"])
    seq = L.lookup(feed, batch[hist["field"]])
    pooled = target_attention(params, target, seq, batch[hist["field"] + "_len"].long())
    net = torch.cat([batch["dense"], L.categories(params, schema, batch), target, pooled],
                    dim=-1)
    for i, _ in enumerate(cfg["config"]["hidden_units"]):
        net = L.linear(params, f"fcn.dense_{i}", net)
        p = torch.sigmoid(L.batch_norm_eval(params, f"fcn.dice_{i}.bn", net, eps, affine=False))
        net = net * p + params[f"fcn.dice_{i}.alpha"] * net * (1 - p)
        net = L.batch_norm_eval(params, f"fcn.bn_{i}", net, eps)
    return L.linear(params, "fcn.logit", net)[:, 0]


@torch.no_grad()
def probabilities(params: dict, cfg: dict, rows: dict, block: int = 16384) -> torch.Tensor:
    """Sigmoid of the logits of every row of ``rows`` (device tensors), in
    blocks of ``block`` rows."""
    n = len(rows["dense"])
    out = [torch.sigmoid(logits(params, cfg, {k: v[i:i + block] for k, v in rows.items()}))
           for i in range(0, n, block)]
    return torch.cat(out)
