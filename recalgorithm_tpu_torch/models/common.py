"""Shared model scaffolding: configs, field groupings, the model registry.

Counterpart of ``recalgorithm_tpu/models/common.py`` (the parts DIN, BST,
AutoInt, PNN, xDeepFM and FiBiNET use).  "W&D family" models (Wide&Deep,
DeepCrossing, DCN, DIN, BST, MMOE, PLE) use fixed per-field dims
(wide_and_deep.py:108-114, mmoe.py:103-109); the "FM family" (DeepFM, FFM,
FwFM, AFM, NFM, PNN, xDeepFM, FiBiNET, and AutoInt) one uniform
``embedding_dim`` for all fields (deepfm.py:83-89).  Every model's
``forward(batch)`` returns ``({task: (B,) logits}, {name: loss})``: the
second dict holds the regularisation terms the JAX models sow into their
``"losses"`` collection, keyed by the sowing module's path
(``inner_product.weight_l2``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch import nn

from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.features.schema import Schema

# Fixed per-vocab embedding dims of the W&D family (wide_and_deep.py:108-114).
WD_FAMILY_DIMS: dict[str, int] = {
    "userid": 16,
    "feedid": 16,
    "device": 2,
    "authorid": 4,
    "bgm_song_id": 4,
    "bgm_singer_id": 4,
    "manual_tag_id": 4,
}

SCALAR_CAT_FIELDS = (
    "userid",
    "feedid",
    "device",
    "authorid",
    "bgm_song_id",
    "bgm_singer_id",
)


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    """Common training flags (reference header, wide_and_deep.py:24-39).

    ``cli/main.py`` builds the trainer from them.  Only ``optimizer="adam"``
    and ``precision="f32"`` are ported.  The JAX package's
    ``scoped_vmem_limit_kib`` is an XLA-on-TPU compiler budget with no
    counterpart here and is not carried.
    """

    batch_size: int = 1024
    learning_rate: float = 0.005
    optimizer: str = "adam"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    train_steps: int = 10000
    num_epochs: int = 1
    shuffle_buffer_size: int = 10000
    save_checkpoints_steps: int = 1000
    # 'f32' only so far; 'bf16' (mixed-precision dense towers) is not ported
    precision: str = "f32"

    @property
    def compute_dtype(self):
        if self.precision == "f32":
            return None
        if self.precision == "bf16":
            raise NotImplementedError("precision='bf16' is not ported yet")
        raise ValueError(f"unknown precision {self.precision!r}")


def uniform_tables(schema: Schema, embedding_dim: int,
                   vocabs: Sequence[str]) -> dict[str, TableSpec]:
    """FM-family tables: one dim for every vocab in ``vocabs``."""
    return {v: TableSpec(v, schema.vocab_sizes[v], embedding_dim) for v in vocabs}


def wd_tables(schema: Schema) -> dict[str, TableSpec]:
    """W&D-family tables with the fixed per-field dims."""
    return {
        v: TableSpec(v, schema.vocab_sizes[v], d) for v, d in WD_FAMILY_DIMS.items()
    }


def stack_fields(field_list: list[torch.Tensor]) -> torch.Tensor:
    """list of (B, K) with equal K -> (B, F, K)."""
    return torch.stack(field_list, dim=1)


class FieldEmbedder(nn.Module):
    """One EmbeddingCollection (always ``embed``) plus declarative field
    specs: ``fields`` is a sequence of (batch_key, vocab, kind) with kind in
    {'scalar', 'mean'}; ``forward`` returns the embeddings in order."""

    def __init__(self, tables: Mapping[str, TableSpec],
                 fields: Sequence[tuple[str, str, str]],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fields = list(fields)
        self.embed = EmbeddingCollection(tables, generator)

    def forward(self, batch) -> list[torch.Tensor]:
        out = []
        for key, vocab, kind in self.fields:
            if kind == "scalar":
                out.append(self.embed.embed_scalar(vocab, batch[key]))
            elif kind == "mean":
                out.append(self.embed.embed_pooled(vocab, batch[key], "mean"))
            else:
                raise ValueError(f"unknown field kind {kind!r}")
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

MODEL_REGISTRY: dict[str, tuple[type, type]] = {}


def register_model(name: str, config_cls: type, model_cls: type) -> None:
    MODEL_REGISTRY[name] = (config_cls, model_cls)


def get_model(name: str) -> tuple[type, type]:
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name]
