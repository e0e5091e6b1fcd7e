"""BST (Behavior Sequence Transformer), plain torch, from its configuration.

The target item and the history, (B, T+1, K) with the target at slot 0, go
through ``num_transformer_block`` blocks: a learned position embedding added
to the query and key inputs, per-head projections (H, K, K), scaled
dot-product attention over the valid keys (the history length plus the
target), the concatenated heads projected back, residual + LayerNorm, one
leaky-ReLU feed-forward layer, residual + LayerNorm.  The block's output is
summed over all T+1 positions, concatenated with the dense features and the
category embeddings, and goes through dense -> BatchNorm (batch statistics)
-> dropout per hidden layer (no activation, as the source's flags have it),
then a one-wide logit.  The loss is the mean sigmoid cross-entropy of the
first task's label.
"""

from __future__ import annotations

import torch

from portbench.reference import layers as L


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) each; keys at positions >= length are masked out."""
    t, d = q.shape[2], q.shape[3]
    scores = q @ k.transpose(-1, -2) / d ** 0.5
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def block(params: dict, i: int, x: torch.Tensor, lengths: torch.Tensor,
          heads: int, ln_eps: float, leak: float) -> torch.Tensor:
    p = f"transformer_{i}."
    b, t, k = x.shape
    pos = params[p + "position_embedding"][:t][None]
    qk_in = x + pos

    def project(inp, w):  # (B, T, K) x (H, K, K) -> (B, H, T, K)
        return (inp[:, None] @ w[None]).reshape(b, heads, t, k)

    out = attention(project(qk_in, params[p + "w_q"]), project(qk_in, params[p + "w_k"]),
                    project(x, params[p + "w_v"]), lengths)
    concat = out.transpose(1, 2).reshape(b, t, heads * k)
    net = L.layer_norm(params, p + "ln1", concat @ params[p + "w_o"] + x, ln_eps)
    ffn = L.leaky_relu(L.linear(params, p + "ffn", net), leak)
    return L.layer_norm(params, p + "ln2", ffn + net, ln_eps)


def logits(params: dict, cfg: dict, batch: dict, generator: torch.Generator | None
           ) -> torch.Tensor:
    """(B,) logits in training mode: batch statistics, and dropout drawn from
    ``generator`` (None: no dropout)."""
    model, schema = cfg["config"], cfg["schema"]
    hist = schema["history"]
    feed = params[f"embedder.embed.tables.{hist['vocab']}"]
    target = L.lookup(feed, batch["feedid"])
    seq = L.lookup(feed, batch[hist["field"]])
    x = torch.cat([target[:, None], seq], dim=1)
    lengths = batch[hist["field"] + "_len"].long() + 1
    for i in range(model["num_transformer_block"]):
        x = block(params, i, x, lengths, model["num_transformer_heads"],
                  cfg["norm_eps"]["layer_norm"], cfg["leaky_relu"])
    pooled = x.sum(dim=1) if model["pooling_method"] == "sum" else x.mean(dim=1)
    net = torch.cat([batch["dense"], L.categories(params, schema, batch), pooled], dim=-1)
    for i, _ in enumerate(model["hidden_units"]):
        net = L.linear(params, f"dense_{i}", net)
        net = L.batch_norm_train(params, f"bn_{i}", net, cfg["norm_eps"]["batch_norm"])
        if generator is not None:
            net = L.dropout(net, model["dropout_rate"], generator)
    return L.linear(params, "logit", net)[:, 0]


def train(params: dict, cfg: dict, batches: list, dropout_seed: int, device
          ) -> tuple[list[float], dict, dict]:
    """Adam steps on ``batches`` from ``params`` (trainable leaves only,
    changed in place).  Returns each step's loss, the first step's gradient
    of each leaf, and the leaves after the last step."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    opt = cfg["optimizer"]
    adam = L.Adam(params, cfg["config"]["learning_rate"], opt["b1"], opt["b2"], opt["eps"])
    losses, first = [], None
    for batch in batches:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = L.bce_with_logits(logits(leaves, cfg, batch, gen), batch["labels"][:, 0])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        adam.step(params, grads)
    return losses, first, params
