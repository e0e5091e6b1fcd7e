"""DIEN's weights: every leaf of the program's ``DIEN``, from the
configuration file alone, drawn by ``portbench/weights.py``'s ``make`` (one
uniform draw on the device cut into the leaves).

Ranges as ``weights.py`` gives them: Glorot's for products (each GRU's
input and recurrent matrices, the attention and auxiliary projections, the
tower), ``1.5 / sqrt(dim)`` for tables, 0.1 for biases, about 1 and 0 for
the norms' scales, shifts and running statistics and for Dice's alpha.  A
GRU's gate bias is drawn about its initial 1.0 (the source's ``bias_ones``),
so that its gates start as the source's do, open to the candidate; its
candidate bias about 0.  The configuration file names this law.
"""

from __future__ import annotations

from portbench import weights

GATE_BIAS = (0.8, 1.2)


def _gru(name: str, n_in: int, h: int) -> list:
    """A ``GRULoop``'s leaves: (in, 2H) and (H, 2H) gate matrices, (in, H)
    and (H, H) candidate matrices, their biases."""
    return [(name + ".w_x_gates", (n_in, 2 * h), weights._glorot(n_in, 2 * h)),
            (name + ".w_h_gates", (h, 2 * h), weights._glorot(h, 2 * h)),
            (name + ".b_gates", (2 * h,), GATE_BIAS),
            (name + ".w_x_cand", (n_in, h), weights._glorot(n_in, h)),
            (name + ".w_h_cand", (h, h), weights._glorot(h, h)),
            (name + ".b_cand", (h,), weights.BIAS)]


def spec(cfg: dict) -> list[tuple[str, tuple, tuple | None]]:
    """(state-dict name, shape, uniform range or None for a zero counter) of
    every leaf."""
    model, schema = cfg["config"], cfg["schema"]
    na = schema["embedding_dims"][schema["history"]["vocab"]]
    nh = model["gru_output_units"]
    out = weights._tables(schema)
    out += _gru("gru", na, nh)
    out.append(("attention_project_matrix", (nh, na), weights._glorot(nh, na)))
    out += _gru("evolution", nh, nh)
    width = schema["num_dense"] + weights._category_width(schema) + na + nh
    for i, unit in enumerate(model["hidden_units"]):
        out += weights._dense(f"fcn.dense_{i}", width, unit)
        out += [(f"fcn.dice_{i}.alpha", (unit,), weights.DICE_ALPHA)]
        out += weights._norm(f"fcn.dice_{i}.bn", unit, affine=False)
        if model["batch_norm"]:
            out += weights._norm(f"fcn.bn_{i}", unit)
        width = unit
    out += weights._dense("fcn.logit", width, 1)
    if model["use_auxiliary_loss"]:
        out.append(("aux_project_matrix", (na, nh), weights._glorot(na, nh)))
    return out


weights.SPECS["DIEN"] = spec
