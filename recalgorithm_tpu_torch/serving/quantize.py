"""Post-training int8 quantization of embedding tables for serving.

Counterpart of ``recalgorithm_tpu/serving/quantize.py``.  Symmetric per-row
int8, q = rint(x / s) with s = max|row| / 127 (1.0 for an all-zero row),
computed in numpy exactly as the JAX package computes it, so the int8
values and scales are the same bits.  A quantized table serves from two
buffers of its ``EmbeddingCollection``, ``<name>__q`` int8 (rows, dim) and
``<name>__scale`` f32 (rows, 1); its f32 parameter leaves the module, so
neither the served model nor an exported program (``serving/export.py``)
holds it.

Only gather-path tables are quantized (more than ``DENSE_LOOKUP_MAX_ROWS``
rows): the small dense-lookup tables stay f32.  Which tables qualify is
decided on the flax layout of the weights (``convert.to_flax``) by
:func:`is_embedding_table_path`, the JAX package's rule, so
:func:`build_qtables` selects the same tables as the JAX function of that
name.  Training never quantizes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.embed.tables import DENSE_LOOKUP_MAX_ROWS, EmbeddingCollection

# Gather-path tables only; dense-lookup tables stay f32 (see module doc).
MIN_QUANT_ROWS = DENSE_LOOKUP_MAX_ROWS + 1


def is_embedding_table_path(path: tuple) -> bool:
    """True for a leaf under an embedding-collection scope (own copy of
    ``recalgorithm_tpu/parallel/mesh.py::is_embedding_table_path``).

    Every collection's name contains 'embed' ('embed', 'embed_w', W&D's
    'wide_embed_w'), tested as a substring of the SCOPE entries
    (``path[:-1]``) only: the leaf is the table's vocab name, and leaf
    parameters such as BST's 'position_embedding' must not match."""
    return any("embed" in str(k) for k in path[:-1])


def quantize_table(x) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: returns (q int8 (R, K), scale f32 (R, 1)).

    Worst-case per-element error is scale / 2, at most 0.4% of the row's
    absmax; an all-zero row and a dim-1 table reconstruct exactly."""
    x = np.asarray(x, np.float32)
    absmax = np.max(np.abs(x), axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _leaves(tree: Mapping, path: tuple = ()):
    """(path, leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def build_qtables(params: Mapping) -> dict:
    """The JAX ``qtables`` collection of a flax-layout ``params`` tree: every
    embedding-table leaf with at least MIN_QUANT_ROWS rows becomes
    ``<name>__q`` + ``<name>__scale`` at the same scope."""
    out: dict = {}
    for path, leaf in _leaves(params):
        leaf = np.asarray(leaf)
        if not (is_embedding_table_path(path) and leaf.ndim == 2
                and leaf.shape[0] >= MIN_QUANT_ROWS):
            continue
        q, scale = quantize_table(leaf)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[f"{path[-1]}__q"] = q
        node[f"{path[-1]}__scale"] = scale
    return out


def quantize_model(model: nn.Module) -> dict:
    """Serve ``model``'s qualifying tables as int8 (the torch counterpart of
    ``build_qtables`` + ``strip_quantized``): each table's collection gets
    its ``__q``/``__scale`` buffers on the table's device and drops the f32
    parameter.  Returns the qtables tree (numpy)."""
    qtables = build_qtables(convert.to_flax(model)["params"])
    leaves = dict(_leaves(qtables))
    for path, q in leaves.items():
        if not path[-1].endswith("__q"):
            continue
        scope, table = path[:-1], path[-1][: -len("__q")]
        coll = model.get_submodule(convert.torch_module_name(scope))
        if not isinstance(coll, EmbeddingCollection):
            raise TypeError(f"{'/'.join(scope)} holds a quantizable leaf {table!r} "
                            f"but is a {type(coll).__name__}, not an EmbeddingCollection")
        coll.quantize_(table, torch.from_numpy(q),
                       torch.from_numpy(leaves[scope + (f"{table}__scale",)]))
    return qtables


def quantized_bytes(qtables: Mapping) -> int:
    """Total payload bytes of a qtables tree."""
    return sum(np.asarray(leaf).nbytes for _, leaf in _leaves(qtables))
