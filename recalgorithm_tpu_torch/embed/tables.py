"""Embedding engine: one table store + lookups with TF-parity combiners.

Counterpart of ``recalgorithm_tpu/embed/tables.py``.  Each table is one
``(num_rows, dim)`` parameter; row 0 is the PAD/OOV row, zero in effect
(outputs are masked on ``id == 0``).  Rows are padded to ``ROW_ALIGN`` so a
checkpoint of either package loads into the other unchanged.

Two lookup rules, kept exactly as the JAX package has them because they give
different answers for ids outside ``[1, num_rows)``:

  * small tables (``num_rows <= DENSE_LOOKUP_MAX_ROWS``) look up as a masked
    one-hot product there: id 0, negative ids and ids ``>= num_rows`` all
    give a zero row.  Here that is a gather of the clamped id times the
    validity mask, which is the same sum with the zero terms left out;
  * large tables gather with ``mode="clip"``: an id ``>= num_rows`` reads the
    LAST padding row (initialised like every row, so not zero), a negative id
    reads row 0, and the result is multiplied by ``ids > 0``.

``embed_sequence`` always takes the gather rule, whatever the table's size,
as the JAX package does.  ``embed_pooled`` counts every ``id > 0`` in the
mean/sqrtn denominator, including out-of-range ids whose rows are zero on the
dense rule.

Initialiser: TF's ``embedding_column`` default ``truncated_normal(1/sqrt(dim))``
in the form the JAX package draws it (``jax.nn.initializers.truncated_normal``):
a standard normal cut at +-2, times ``stddev``.  So the cut is at +-2 stddev
and, despite that initializer's docstring, nothing rescales the draw: its std
is 0.88 stddev.  ``torch.nn.init.trunc_normal_`` takes absolute bounds, so
they are written out as +-2 stddev.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

# Table rows are padded up to a multiple of this (the JAX package row-shards
# tables over up to 256 chips); padding rows are unreachable by valid ids.
ROW_ALIGN = 256

# Tables with at most this many (padded) rows take the dense lookup rule.
DENSE_LOOKUP_MAX_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table: ``vocab_size`` real rows + 1 PAD/OOV row,
    row-padded to ROW_ALIGN.  init: 'normal' (truncated normal, std
    1/sqrt(dim)) or 'zeros'."""

    name: str
    vocab_size: int
    dim: int
    init: str = "normal"

    @property
    def num_rows(self) -> int:
        needed = self.vocab_size + 1
        return ((needed + ROW_ALIGN - 1) // ROW_ALIGN) * ROW_ALIGN


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``truncated_normal(stddev)``: N(0, stddev) cut at +-2 stddev."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                     2.0 * stddev, generator=generator)


class EmbeddingCollection(nn.Module):
    """All embedding tables of one model, keyed by table name."""

    def __init__(self, tables: Mapping[str, TableSpec],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.specs = dict(tables)
        self.tables = nn.ParameterDict()
        for name, spec in self.specs.items():
            t = torch.zeros(spec.num_rows, spec.dim)
            if spec.init != "zeros":
                truncated_normal_(t, 1.0 / spec.dim**0.5, generator)
            self.tables[name] = nn.Parameter(t)

    def _is_dense(self, table: str) -> bool:
        return self.specs[table].num_rows <= DENSE_LOOKUP_MAX_ROWS

    def _clip_gather(self, table: str, ids: torch.Tensor) -> torch.Tensor:
        """``jnp.take(tab, ids, mode='clip')``: ids clamped into the table.

        ``F.embedding`` rather than ``tab[ids]``: the same rows, but its
        backward sums the rows of repeated ids by segments, where the
        indexing backward walks each id's duplicates in one thread.  A
        WeChat-shaped batch repeats the PAD id about 170k times at B=4096
        (sequences are mostly padding), which took that backward 51 ms on
        an H100 (PERF.md)."""
        tab = self.tables[table]
        return F.embedding(ids.long().clamp(0, tab.shape[0] - 1), tab)

    def _dense_rows(self, table: str, ids: torch.Tensor) -> torch.Tensor:
        """Masked one-hot rule: rows of ids in [1, num_rows), zero elsewhere."""
        valid = (ids > 0) & (ids < self.tables[table].shape[0])
        return self._clip_gather(table, ids) * valid[..., None].to(
            self.tables[table].dtype)

    def embed_scalar(self, table: str, ids: torch.Tensor) -> torch.Tensor:
        """(B,) int ids -> (B, dim); id 0 (PAD/OOV) -> zero vector."""
        if self._is_dense(table):
            return self._dense_rows(table, ids)
        emb = self._clip_gather(table, ids)
        return emb * (ids > 0)[:, None].to(emb.dtype)

    def embed_sequence(self, table: str, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) padded ids -> (B, T, dim) with zero rows at PAD positions."""
        emb = self._clip_gather(table, ids)
        return emb * (ids > 0)[..., None].to(emb.dtype)

    def embed_pooled(self, table: str, ids: torch.Tensor,
                     combiner: str = "mean") -> torch.Tensor:
        """(B, T) padded ids -> (B, dim) pooled over valid (id > 0) positions;
        all-padding rows -> zeros rather than NaN."""
        if self._is_dense(table):
            total = self._dense_rows(table, ids).sum(dim=1)
        else:
            total = self.embed_sequence(table, ids).sum(dim=1)
        if combiner == "sum":
            return total
        count = (ids > 0).to(total.dtype).sum(dim=1, keepdim=True)
        if combiner == "mean":
            return total / count.clamp(min=1.0)
        if combiner == "sqrtn":
            return total / count.clamp(min=1.0).sqrt()
        raise ValueError(f"unknown combiner: {combiner!r}")
