"""DLRM-DCNv2's weights: every leaf of the program's ``DLRM`` in its DCN
form, drawn from ``--seed`` on the device, one leaf at a time.

The leaves, their shapes and their ranges follow from the configuration
file alone (:func:`spec`, also ``weights.SPECS["DLRM"]``), with the ranges
of ``portbench/weights.py``: Glorot's for products, ``1.5 / sqrt(dim)`` for
tables, 0.1 for biases.  Unlike ``weights.make`` (one draw cut into the
leaves), each leaf is drawn alone from a generator seeded by the seed and
the leaf's place in the spec, so a leaf can be drawn again without the
others: with 13.1 GB of tables, a second copy of the whole initial state
does not fit beside the trainer, and the check draws each leaf's initial
value again where it needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights


def table_rows(cfg: dict, i: int) -> int:
    """Rows of table ``cat_<i>``: its held ids plus the padding row, padded
    to the configuration's row alignment."""
    align = cfg["table_row_align"]
    return -(-(cfg["num_embeddings_per_feature"][i] + 1) // align) * align


def _dense(name: str, n_in: int, n_out: int) -> list:
    return [(name + ".weight", (n_out, n_in), weights._glorot(n_in, n_out)),
            (name + ".bias", (n_out,), weights.BIAS)]


def spec(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(state-dict name, shape, uniform range) of every leaf, in the
    program's state-dict order."""
    dim = cfg["embedding_dim"]
    out, width = [], cfg["num_dense"]
    for i, unit in enumerate(cfg["dense_arch_layer_sizes"]):
        out += _dense(f"bottom.dense_{i}", width, unit)
        width = unit
    a = 1.5 / dim ** 0.5
    for i in range(len(cfg["num_embeddings_per_feature"])):
        out.append((f"embedder.embed.tables.cat_{i}", (table_rows(cfg, i), dim), (-a, a)))
    width += dim * len(cfg["num_embeddings_per_feature"])
    rank = cfg["dcn_low_rank_dim"]
    for layer in range(cfg["dcn_num_layers"]):
        out += [(f"cross.u_{layer}", (width, rank), weights._glorot(width, rank)),
                (f"cross.v_{layer}", (width, rank), weights._glorot(width, rank)),
                (f"cross.b_{layer}", (width,), weights.BIAS)]
    over = cfg["over_arch_layer_sizes"]
    for i, unit in enumerate(over[:-1]):
        out += _dense(f"top.dense_{i}", width, unit)
        width = unit
    return out + _dense("logit", width, over[-1])


weights.SPECS["DLRM"] = spec


def leaf(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """Leaf ``name``'s initial value from ``seed``."""
    for index, (n, shape, (lo, hi)) in enumerate(spec(cfg)):
        if n == name:
            state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
            gen = torch.Generator(device=device).manual_seed(int(state))
            return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)
    raise KeyError(name)


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf from ``seed`` (the reference's start; the program loads
    them leaf by leaf with :func:`load_`)."""
    return {name: leaf(cfg, seed, name, device) for name, _, _ in spec(cfg)}


@torch.no_grad()
def load_(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Each of ``model``'s leaves set to its value from ``seed``, one at a
    time; a leaf the spec lacks, or a spec leaf the model lacks, raises."""
    state = model.state_dict()
    names = [name for name, _, _ in spec(cfg)]
    if list(state) != names:
        raise KeyError(f"the model's leaves {sorted(set(state) ^ set(names))} "
                       "differ from the spec's")
    for name, t in state.items():
        t.copy_(leaf(cfg, seed, name, t.device))


@torch.no_grad()
def norm_of_change(cfg: dict, seed: int, name: str, value: torch.Tensor) -> float:
    """The norm of ``value`` less leaf ``name``'s initial value, in float64."""
    return float(torch.linalg.vector_norm(value.detach() - leaf(cfg, seed, name, value.device),
                                          dtype=torch.float64))
