"""The benchmark's weights: every leaf of a model, drawn from ``--seed`` on
the device in one call, in the float32 the configurations state.

The leaves, their shapes and their ranges follow from the configuration file
alone (:func:`spec`); the program and the reference both take the same
tensors.  Every leaf is uniform in its range: Glorot's for products, about
the initialiser's for tables, and ranges around 1 or 0 for the norms' scales,
shifts and running statistics and for Dice's alpha, so that eval-mode
normalisation and Dice do work a freshly initialised model would skip.
"""

from __future__ import annotations

import torch


def _glorot(fan_in: int, fan_out: int) -> tuple[float, float]:
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return -a, a


BIAS = (-0.1, 0.1)
SCALE = (0.8, 1.2)
RUNNING_MEAN = (-0.2, 0.2)
RUNNING_VAR = (0.5, 1.5)
DICE_ALPHA = (0.0, 0.5)


def _tables(schema: dict) -> list:
    align = schema["table_row_align"]
    out = []
    for vocab, dim in schema["embedding_dims"].items():
        rows = -(-(schema["vocab_sizes"][vocab] + 1) // align) * align
        a = 1.5 / dim ** 0.5
        out.append((f"embedder.embed.tables.{vocab}", (rows, dim), (-a, a)))
    return out


def _dense(name: str, n_in: int, n_out: int) -> list:
    return [(name + ".weight", (n_out, n_in), _glorot(n_in, n_out)),
            (name + ".bias", (n_out,), BIAS)]


def _norm(name: str, n: int, affine: bool = True, running: bool = True) -> list:
    out = [(name + ".weight", (n,), SCALE), (name + ".bias", (n,), BIAS)] if affine else []
    if running:
        out += [(name + ".running_mean", (n,), RUNNING_MEAN),
                (name + ".running_var", (n,), RUNNING_VAR),
                (name + ".num_batches_tracked", (), None)]
    return out


def _category_width(schema: dict) -> int:
    return sum(schema["embedding_dims"][v] for _, v, _ in schema["category_fields"])


def _bst(cfg: dict) -> list:
    model, schema = cfg["config"], cfg["schema"]
    k = schema["embedding_dims"][schema["history"]["vocab"]]
    h, t = model["num_transformer_heads"], model["sequence_max_length"] + 1
    out = _tables(schema)
    for i in range(model["num_transformer_block"]):
        p = f"transformer_{i}."
        out.append((p + "position_embedding", (t, k), _glorot(t, k)))
        out += [(p + w, (h, k, k), _glorot(h * k, h * k)) for w in ("w_q", "w_k", "w_v")]
        out.append((p + "w_o", (h * k, k), _glorot(h * k, k)))
        out += _norm(p + "ln1", k, running=False) + _dense(p + "ffn", k, k)
        out += _norm(p + "ln2", k, running=False)
    width = schema["num_dense"] + _category_width(schema) + k
    for i, unit in enumerate(model["hidden_units"]):
        out += _dense(f"dense_{i}", width, unit) + _norm(f"bn_{i}", unit)
        width = unit
    return out + _dense("logit", width, 1)


def _din(cfg: dict) -> list:
    model, schema = cfg["config"], cfg["schema"]
    k = schema["embedding_dims"][schema["history"]["vocab"]]
    out = _tables(schema)
    width = 4 * k
    for name, unit in zip(("f1_att", "f2_att", "f3_att"), cfg["attention_units"]):
        out += _dense(f"attention.{name}", width, unit)
        width = unit
    width = schema["num_dense"] + _category_width(schema) + 2 * k
    for i, unit in enumerate(model["hidden_units"]):
        out += _dense(f"fcn.dense_{i}", width, unit)
        out += [(f"fcn.dice_{i}.alpha", (unit,), DICE_ALPHA)]
        out += _norm(f"fcn.dice_{i}.bn", unit, affine=False) + _norm(f"fcn.bn_{i}", unit)
        width = unit
    return out + _dense("fcn.logit", width, 1)


SPECS = {"BST": _bst, "DIN": _din}


def spec(cfg: dict) -> list[tuple[str, tuple, tuple | None]]:
    """(state-dict name, shape, uniform range or None for a zero counter)."""
    return SPECS[cfg["model"]](cfg)


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of the configuration's model, from ``seed``: one
    uniform draw on ``device`` cut into the leaves and scaled to each range."""
    leaves = spec(cfg)
    sizes = [torch.Size(shape).numel() for _, shape, law in leaves if law is not None]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    parts = iter(torch.split(flat, sizes))
    out = {}
    for name, shape, law in leaves:
        if law is None:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        lo, hi = law
        out[name] = (next(parts).view(shape) * (hi - lo) + lo).contiguous()
    return out


def trainable(cfg: dict, weights: dict) -> dict[str, torch.Tensor]:
    """The leaves an optimizer updates (every leaf but the running statistics
    and counters)."""
    return {k: v.clone() for k, v in weights.items()
            if not k.endswith((".running_mean", ".running_var", ".num_batches_tracked"))}
