"""DIEN (Deep Interest Evolution Network, Zhou et al., AAAI 2019) in
training, plain torch, from its configuration file.

The history's item embeddings e_1..e_T (B, T, K) go through an interest
extraction GRU of width H, then target attention, then an interest
evolution AUGRU (or AGRU) of width H driven by the attention:

    r, u = sigmoid(x W_xg + h W_hg + b_g)         (the first H columns r)
    c    = tanh(x W_xc + (r * h) W_hc + b_c)
    GRU:   h' = u h + (1 - u) c
    AGRU:  h' = (1 - a) h + a c
    AUGRU: u' = (1 - a) u;  h' = u' h + (1 - u') c

one step at a time, each step's products taken there.  A step at or past a
row's history length emits zeros and carries the state unchanged
(``dynamic_rnn(sequence_length)``).  The attention scores each extractor
state h_t against the target item e projected to width H,
``s_t = h_t . (A e)`` with ``A`` = ``attention_project_matrix`` (H, K), and
softmaxes them over the valid steps (a row with none attends uniformly).
The evolution's final state, the dense features, the category embeddings
and the target go through dense -> Dice -> BatchNorm -> dropout per hidden
layer (batch statistics; Dice's own norm has no scale or shift), then a
one-wide logit.

The auxiliary loss scores each extractor state h_t (t < length - 1) against
the next item, ``log sigmoid(h_t . (e_{t+1} W))``, and against the next
item of the histories ``k`` rows away in the batch (k = 1 ..
``negative_sample_number``), ``log(1 - sigmoid(h_t . (e'_{t+1} W)))``, with
``W`` = ``aux_project_matrix`` (K, H) and 1e-8 inside each log as the source
writes it; it is the negated sum over t, averaged over the rows, and adds to
the click loss (the mean sigmoid cross-entropy of the first task's label)
with the configuration's weight.

LazyAdam moves the moments and the parameter only where the gradient is
nonzero, with the bias corrections of the global count of steps in
float32.
"""

from __future__ import annotations

import torch

from portbench.reference import layers as L


def gru(params: dict, name: str, x: torch.Tensor, lengths: torch.Tensor, cell: str,
        att: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, in) inputs -> (outputs (B, T, H), final state (B, H))."""
    b, t, _ = x.shape
    w_xg, w_hg, b_g = (params[f"{name}.{k}"] for k in ("w_x_gates", "w_h_gates", "b_gates"))
    w_xc, w_hc, b_c = (params[f"{name}.{k}"] for k in ("w_x_cand", "w_h_cand", "b_cand"))
    h = w_hc.shape[0]
    state = x.new_zeros(b, h)
    outputs = []
    for s in range(t):
        gates = torch.sigmoid(x[:, s] @ w_xg + state @ w_hg + b_g)
        r, u = gates[:, :h], gates[:, h:]
        c = torch.tanh(x[:, s] @ w_xc + (r * state) @ w_hc + b_c)
        if cell == "GRU":
            new = u * state + (1 - u) * c
        elif cell == "AGRU":
            a = att[:, s, None]
            new = (1 - a) * state + a * c
        elif cell == "AUGRU":
            u = (1 - att[:, s, None]) * u
            new = u * state + (1 - u) * c
        else:
            raise ValueError(f"unknown cell {cell!r}")
        valid = (s < lengths)[:, None]
        state = torch.where(valid, new, state)
        outputs.append(torch.where(valid, new, torch.zeros_like(new)))
    return torch.stack(outputs, dim=1), state


def attention(params: dict, h: torch.Tensor, target: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """(B, T) softmax weights of the extractor states over the valid steps."""
    t = h.shape[1]
    scores = (h * (target @ params["attention_project_matrix"].T)[:, None, :]).sum(dim=-1)
    valid = torch.arange(t, device=h.device)[None, :] < lengths[:, None]
    weights = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=1)
    none = ~valid.any(dim=1, keepdim=True)
    return torch.where(none, torch.full_like(scores, 1.0 / t), weights)


def auxiliary_loss(params: dict, cfg: dict, h: torch.Tensor, seq: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    eps = cfg["aux_log_eps"]
    w = params["aux_project_matrix"]
    state = h[:, :-1]

    def score(items):  # h_t against e_{t+1} of ``items``
        return (state * (items[:, 1:] @ w)).sum(dim=-1)

    terms = torch.log(torch.sigmoid(score(seq)) + eps)
    for k in range(1, cfg["config"]["negative_sample_number"] + 1):
        terms = terms + torch.log(1 - torch.sigmoid(score(torch.roll(seq, k, dims=0))) + eps)
    valid = torch.arange(seq.shape[1] - 1, device=seq.device)[None, :] < (lengths - 1)[:, None]
    return -(terms * valid.to(terms.dtype)).sum(dim=1).mean()


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """``layers.dropout``'s mask drawn as float32 uniforms whatever ``x``'s
    precision (the trainer's draw: a float64 reference keeps its masks)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def batch_norm_plain(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised by the batch's mean and biased variance, no scale."""
    mean = x.mean(dim=0)
    return (x - mean) / torch.sqrt(((x - mean) ** 2).mean(dim=0) + eps)


def forward(params: dict, cfg: dict, batch: dict, generator: torch.Generator | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) train-mode logits and the auxiliary loss (0 without the flag):
    batch statistics, and dropout drawn from ``generator`` (None: none)."""
    model, schema = cfg["config"], cfg["schema"]
    if model["activation"] != "dice":
        raise ValueError("the reference's tower is Dice's")
    eps = cfg["norm_eps"]["batch_norm"]
    hist = schema["history"]
    feed = params[f"embedder.embed.tables.{hist['vocab']}"]
    target = L.lookup(feed, batch["feedid"])
    seq = L.lookup(feed, batch[hist["field"]])
    lengths = batch[hist["field"] + "_len"].long()
    h, _ = gru(params, "gru", seq, lengths, "GRU")
    att = attention(params, h, target, lengths)
    _, final = gru(params, "evolution", h, lengths, model["custom_gru_type"], att)
    net = torch.cat([batch["dense"], L.categories(params, schema, batch), target, final], dim=-1)
    for i, _ in enumerate(model["hidden_units"]):
        net = L.linear(params, f"fcn.dense_{i}", net)
        p = torch.sigmoid(batch_norm_plain(net, eps))
        net = net * p + params[f"fcn.dice_{i}.alpha"] * net * (1 - p)
        if model["batch_norm"]:
            net = L.batch_norm_train(params, f"fcn.bn_{i}", net, eps)
        if generator is not None and 0.0 < model["dropout_rate"] < 1.0:
            net = dropout(net, model["dropout_rate"], generator)
    logits = L.linear(params, "fcn.logit", net)[:, 0]
    aux = (auxiliary_loss(params, cfg, h, seq, lengths) if model["use_auxiliary_loss"]
           else logits.new_zeros(()))
    return logits, aux


def loss(params: dict, cfg: dict, batch: dict, generator: torch.Generator | None
         ) -> torch.Tensor:
    logits, aux = forward(params, cfg, batch, generator)
    return L.bce_with_logits(logits, batch["labels"][:, 0]) + cfg["aux_loss_weight"] * aux


class LazyAdam:
    """``p -= lr * (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps)`` and the
    moments' updates, where the gradient is nonzero; n counts every step."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.n += 1
        n = torch.tensor(float(self.n))
        c1 = float(1 - torch.tensor(self.b1) ** n)
        c2 = float(1 - torch.tensor(self.b2) ** n)
        for k, g in grads.items():
            hit = g != 0
            self.m[k] = torch.where(hit, self.b1 * self.m[k] + (1 - self.b1) * g, self.m[k])
            self.v[k] = torch.where(hit, self.b2 * self.v[k] + (1 - self.b2) * g * g, self.v[k])
            move = self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            params[k] -= torch.where(hit, move, torch.zeros_like(move))


def train(params: dict, cfg: dict, batches: list, dropout_seed: int, device
          ) -> tuple[list[float], dict, dict]:
    """LazyAdam steps on ``batches`` from ``params`` (trainable leaves only,
    changed in place).  Returns each step's loss, the first step's gradient
    of each leaf, and the leaves after the last step."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    opt = cfg["optimizer"]
    lazy = LazyAdam(params, cfg["config"]["learning_rate"], opt["b1"], opt["b2"], opt["eps"])
    losses, first = [], None
    for batch in batches:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        value = loss(leaves, cfg, batch, gen)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        if first is None:
            first = grads
        lazy.step(params, grads)
    return losses, first, params
