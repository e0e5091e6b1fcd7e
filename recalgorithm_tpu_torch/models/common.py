"""Shared model scaffolding: configs, field groupings, the model registry.

Counterpart of ``recalgorithm_tpu/models/common.py``.  "W&D family" models (Wide&Deep,
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


def schema_fields(schema: Schema, *, sequences: str | None = "mean"
                  ) -> list[tuple[str, str, str]]:
    """Generic field list derived from a Schema: every categorical feature
    as a scalar field, every sequence feature pooled (``sequences`` kind,
    'mean'/'sum'; None drops them)."""
    fields = [(f.name, f.vocab, "scalar") for f in schema.categorical]
    if sequences:
        fields += [(f.name, f.vocab, sequences) for f in schema.sequence]
    return fields


def reference_or_schema_fields(schema: Schema, *, sequences: str | None = "mean"
                               ) -> list[tuple[str, str, str]]:
    """The reference's 6 scalar WeChat fields on a WeChat-shaped schema (so
    golden bands and parity hold), :func:`schema_fields` on any other
    (douban, ...)."""
    names = {f.name for f in schema.categorical}
    if set(SCALAR_CAT_FIELDS) <= names:
        return [(n, n, "scalar") for n in SCALAR_CAT_FIELDS]
    return schema_fields(schema, sequences=sequences)


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    """Common training flags (reference header, wide_and_deep.py:24-39).

    ``cli/main.py`` builds the trainer from them.  ``optimizer`` is one of
    adam, adagrad, rmsprop and sgd (``train/optimizers.build``).
    ``precision``: 'f32' or 'bf16', the dtype of the dense towers' and the
    experts' products (``ops/mlp.py``, ``ops/experts.py``); parameters, BN
    statistics, interaction ops, the attention kernels' inputs and the
    losses stay f32.  The JAX package's ``scoped_vmem_limit_kib`` is an
    XLA-on-TPU compiler budget with no counterpart here and is not carried.
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
    precision: str = "f32"

    def optimizer_options(self) -> dict:
        """Keyword options of ``optimizer`` beyond its rate, from the
        config's own fields (none: the optimizer's defaults)."""
        return {}

    @property
    def compute_dtype(self) -> torch.dtype | None:
        if self.precision == "f32":
            return None
        if self.precision == "bf16":
            return torch.bfloat16
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


def sigmoid_tasks(logits: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """{task: logits} -> {task: probabilities}."""
    return {k: torch.sigmoid(v) for k, v in logits.items()}


class FieldEmbedder(nn.Module):
    """One EmbeddingCollection (always ``embed``) plus declarative field
    specs: ``fields`` is a sequence of (batch_key, vocab, kind) with kind in
    {'scalar', 'mean', 'sum'}; ``forward`` returns the embeddings in order."""

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
            elif kind in ("mean", "sum"):
                out.append(self.embed.embed_pooled(vocab, batch[key], kind))
            else:
                raise ValueError(f"unknown field kind {kind!r}")
        return out


class FirstOrderLogit(nn.Module):
    """FM first-order term: a per-id scalar weight summed over ``fields``
    (batch_key, vocab, kind in {'scalar', 'sum', 'mean'}), plus ``bias``.

    The reference's one-hot indicators -> Dense(1) (deepfm.py:179-181) as a
    sparse lookup; PAD/OOV ids (0) contribute nothing.  The width-1 tables
    start at zero and sit in a collection named ``embed_w``, as in the JAX
    module (``params/first_order/embed_w/<vocab>``)."""

    def __init__(self, schema: Schema, fields: Sequence[tuple[str, str, str]]):
        super().__init__()
        self.fields = list(fields)
        self.embed_w = EmbeddingCollection({
            vocab: TableSpec(vocab, schema.vocab_sizes[vocab], 1, init="zeros")
            for _, vocab, _ in self.fields})
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, batch) -> torch.Tensor:  # (B,)
        out = torch.zeros((), device=self.bias.device, dtype=self.bias.dtype)
        for key, vocab, kind in self.fields:
            if kind == "scalar":
                w = self.embed_w.embed_scalar(vocab, batch[key])[:, 0]
            else:
                w = self.embed_w.embed_pooled(vocab, batch[key], kind)[:, 0]
            out = out + w
        return out + self.bias[0]


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
