"""Carry weights between the JAX package's flax trees and this package's models.

The JAX models hold ``{"params": ..., "batch_stats": ...}`` trees keyed by
flax module paths (``params/FieldEmbedder_0/embed/feedid``,
``params/attention/f1_att/kernel``, ``batch_stats/fcn/dice_0/BatchNorm_0/
mean``, ...).  The torch modules carry the same names, apart from these
rules, which :func:`from_flax` and :func:`to_flax` apply both ways:

  * flax ``Dense`` kernels are ``(in, out)``; a torch ``Linear.weight`` is
    their transpose.  Only a leaf named ``weight`` is transposed: raw
    parameters keep their flax names and layout (BST's ``w_q``/``w_k``/
    ``w_v`` (H, d, d), ``w_o`` (H*d, d), ``position_embedding``);
  * BatchNorm and LayerNorm ``scale``/``bias`` -> ``weight``/``bias`` (a
    1-D ``weight`` goes back to ``scale``), ``mean``/``var`` ->
    ``running_mean``/``running_var``; torch's ``num_batches_tracked``
    has no flax counterpart;
  * ``FieldEmbedder_0`` -> ``embedder``, Dice's ``BatchNorm_0`` -> ``bn``,
    and tables sit in ``embed.tables``; table rows keep their ROW_ALIGN
    padding.

Exports keep the JAX package's layout (``train/loop.py``,
``_Checkpointer.maybe_export_best``): ``<model_dir>/export/best_<step>/``
with ``metrics.json``, listed in ``<model_dir>/best_exports.json``.  The
weights are one ``params.npz`` keyed by the flax paths rather than
``params.msgpack``, so reading one needs numpy only.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping

import numpy as np
import torch
from torch import nn

_MODULES = {"FieldEmbedder_0": "embedder", "BatchNorm_0": "bn"}
_MODULES_BACK = {v: k for k, v in _MODULES.items()}
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
EXPORT_FILE = "params.npz"


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree -> a torch state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            mods = [_MODULES.get(m, m) for m in path[:-1]]
            if mods and mods[-1] == "embed":
                mods.append("tables")
            leaf = path[-1]
            if collection == "batch_stats":
                leaf = _STATS[leaf]
                if leaf == "running_mean":
                    sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
            elif leaf == "kernel":
                leaf, arr = "weight", arr.T
            elif leaf == "scale":
                leaf = "weight"
            sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(arr))
    return sd


def to_flax(model: nn.Module) -> dict:
    """The inverse of :func:`from_flax`: a nested dict of numpy arrays."""
    flat: dict[tuple, np.ndarray] = {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy().copy()
        if mods[-2:] == ["embed", "tables"]:
            mods = mods[:-1]
        path = tuple(_MODULES_BACK.get(m, m) for m in mods)
        if leaf in _STATS_BACK:
            flat[("batch_stats",) + path + (_STATS_BACK[leaf],)] = arr
            continue
        if leaf == "weight" and arr.ndim == 1:  # BatchNorm / LayerNorm
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        flat[("params",) + path + (leaf,)] = arr
    return _unflatten(flat)


def read_best(model_dir: str) -> list[tuple[float, int]]:
    """The (auc, step) pairs of ``best_exports.json``, best first."""
    best_path = os.path.join(model_dir, "best_exports.json")
    if not os.path.exists(best_path):
        return []
    with open(best_path) as f:
        return [(float(a), int(s)) for a, s in json.load(f)]


def save_export(model_dir: str, step: int, auc: float, model: nn.Module,
                keep: int | None = None) -> str:
    """Write ``export/best_<step>/`` (weights + metrics.json) and record it
    in ``best_exports.json``; with ``keep``, only the ``keep`` highest-AUC
    exports stay listed and on disk (BestExporter(exports_to_keep) parity).
    Returns the export directory."""
    export_dir = os.path.join(model_dir, "export", f"best_{int(step)}")
    os.makedirs(export_dir, exist_ok=True)
    flat = _flatten(to_flax(model))
    np.savez(os.path.join(export_dir, EXPORT_FILE),
             **{"/".join(p): v for p, v in flat.items()})
    with open(os.path.join(export_dir, "metrics.json"), "w") as f:
        json.dump({"auc": auc, "step": int(step)}, f)
    best = sorted(set(read_best(model_dir)) | {(auc, int(step))}, reverse=True)
    if keep is not None:
        for _, old_step in best[keep:]:
            if old_step != int(step):
                shutil.rmtree(os.path.join(model_dir, "export", f"best_{old_step}"),
                              ignore_errors=True)
        best = best[:keep]
    with open(os.path.join(model_dir, "best_exports.json"), "w") as f:
        json.dump(best, f)
    return export_dir


def load_export(export_dir: str) -> dict[str, torch.Tensor]:
    """The torch state_dict of an export written by :func:`save_export`."""
    with np.load(os.path.join(export_dir, EXPORT_FILE)) as z:
        flat = {tuple(k.split("/")): z[k] for k in z.files}
    return from_flax(_unflatten(flat))
