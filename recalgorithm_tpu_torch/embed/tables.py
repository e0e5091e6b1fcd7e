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
as the JAX package does.  Inside :func:`compact_grad_scatter` (the trainer's
train step) a long sequence gather of a whole f32 table takes
``ops/compact_scatter.take_compact_bwd``: the same rows, and a table
gradient that scatters only the live (non-PAD) entries.  Inside
:func:`row_sparse_grads` (the trainer's eager step under an optimizer that
applies row gradients) a lookup of a whole f32 table makes a row gradient
instead of a dense ``(num_rows, dim)`` one: a sparse COO tensor, uncoalesced,
of each clamped id beside its gradient row (``F.embedding(sparse=True)``;
nothing counts or merges its rows, so nothing waits on the device).  A
second lookup of the table in one step concatenates onto it.  The compacted
branch is not taken there: the row gradient makes nothing dense.

A gather-path table quantized for serving
(:meth:`EmbeddingCollection.quantize_`) gathers int8 rows and their per-row
scales with the same clip rule and multiplies them (the JAX package's
``qtables`` lookup).  ``embed_pooled`` counts every ``id > 0`` in the
mean/sqrtn denominator, including out-of-range ids whose rows are zero on the
dense rule.

Under a process mesh (:meth:`EmbeddingCollection.shard_`) each rank holds rows
``[r V/N, (r+1) V/N)`` of every table, and every rule gathers through the
explicit exchange of ``embed/sharded.py`` (the JAX package's ``shard_map``
lookups; torch has no partitioner to derive them).  The rules themselves are
unchanged: they read the full row count, not the shard's.

Initialiser: TF's ``embedding_column`` default ``truncated_normal(1/sqrt(dim))``
in the form the JAX package draws it (``jax.nn.initializers.truncated_normal``):
a standard normal cut at +-2, times ``stddev``.  So the cut is at +-2 stddev
and, despite that initializer's docstring, nothing rescales the draw: its std
is 0.88 stddev.  ``torch.nn.init.trunc_normal_`` takes absolute bounds, so
they are written out as +-2 stddev.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from recalgorithm_tpu_torch.embed.sharded import sharded_lookup
from recalgorithm_tpu_torch.ops import compact_scatter as cs
from recalgorithm_tpu_torch.parallel import mesh as mesh_lib

# Table rows are padded up to a multiple of this (the JAX package row-shards
# tables over up to 256 chips); padding rows are unreachable by valid ids.
ROW_ALIGN = 256

# Tables with at most this many (padded) rows take the dense lookup rule.
DENSE_LOOKUP_MAX_ROWS = 2048

# When True (compact_grad_scatter), a (B, T) sequence gather of at least
# cs.MIN_IDS ids with T >= cs.LONG_SEQ_T takes cs.take_compact_bwd.  Its
# backward drops live entries beyond the cap: the caller routes a batch that
# overflows it (cs.batch_fits_compact, on the host) to a step with this off.
_COMPACT_SCATTER = False

# When True (row_sparse_grads), a lookup of a whole f32 table (no process
# mesh, not int8) makes a row gradient; see the module docstring.
_ROW_SPARSE = False


@contextlib.contextmanager
def compact_grad_scatter(enabled: bool = True):
    """Turn the PAD-compacted sequence gradient on (or off) for the lookups
    made inside this context; a backward keeps the choice of its forward."""
    global _COMPACT_SCATTER
    prev, _COMPACT_SCATTER = _COMPACT_SCATTER, enabled
    try:
        yield
    finally:
        _COMPACT_SCATTER = prev


@contextlib.contextmanager
def row_sparse_grads(enabled: bool = True):
    """Turn the tables' row gradients on (or off) for the lookups made
    inside this context; a backward keeps the choice of its forward."""
    global _ROW_SPARSE
    prev, _ROW_SPARSE = _ROW_SPARSE, enabled
    try:
        yield
    finally:
        _ROW_SPARSE = prev


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
        self.mesh = None  # a ProcessMesh once shard_ ran

    def shard_(self, mesh) -> dict[str, str]:
        """Keep only this rank's rows of every table, f32 or int8 with its
        scales (row-sharded over all of ``mesh``'s ranks); lookups become
        the sharded exchange.  The rows of a table divide the ranks
        (ROW_ALIGN padding) or this raises.  Returns the state_dict names
        it split, each ``mesh_lib.TABLE``."""
        split = {}
        for name, spec in self.specs.items():
            if spec.num_rows % mesh.world:
                raise ValueError(f"table {name!r}: {spec.num_rows} rows do not divide "
                                 f"{mesh.world} ranks")
            rows = spec.num_rows // mesh.world
            part = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
            if name in self.tables:
                self.tables[name].data = self.tables[name].data[part].clone()
                split[f"tables.{name}"] = mesh_lib.TABLE
            for key in (f"{name}__q", f"{name}__scale"):
                if key in self._buffers:
                    self._buffers[key] = self._buffers[key][part].clone()
                    split[key] = mesh_lib.TABLE
        self.mesh = mesh
        return split

    def _is_dense(self, table: str) -> bool:
        return self.specs[table].num_rows <= DENSE_LOOKUP_MAX_ROWS

    def _gather(self, table: str, weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (in range) of ``weight``, a table or this rank's shard
        (under :func:`row_sparse_grads` a whole f32 table's gradient is rows)."""
        if self.mesh is None:
            return F.embedding(idx, weight,
                               sparse=_ROW_SPARSE and weight.dtype == torch.float32)
        return sharded_lookup(weight, idx, self.mesh, self.specs[table].num_rows)

    def _clip_gather(self, table: str, ids: torch.Tensor,
                     compact: bool = False) -> torch.Tensor:
        """``jnp.take(tab, ids, mode='clip')``: ids clamped into the table.

        ``F.embedding`` rather than ``tab[ids]``: the same rows, but its
        backward sums the rows of repeated ids by segments, where the
        indexing backward walks each id's duplicates in one thread.  A
        WeChat-shaped batch repeats the PAD id about 170k times at B=4096
        (sequences are mostly padding), which took that backward 51 ms on
        an H100 (PERF.md).

        ``compact`` (a sequence lookup): under :func:`compact_grad_scatter`
        the gather of a whole f32 table (no process mesh, not int8) with at
        least ``cs.MIN_IDS`` ids and ``T >= cs.LONG_SEQ_T`` is
        ``cs.take_compact_bwd``, the JAX engine's gate, unless
        :func:`row_sparse_grads` is on."""
        if (compact and _COMPACT_SCATTER and not _ROW_SPARSE and self.mesh is None
                and ids.dim() == 2
                and table in self.tables and ids.numel() >= cs.MIN_IDS
                and ids.shape[-1] >= cs.LONG_SEQ_T):
            return cs.take_compact_bwd(self.tables[table], ids)
        idx = ids.long().clamp(0, self.specs[table].num_rows - 1)
        q = self._buffers.get(f"{table}__q")
        if q is not None:  # int8 rows times their f32 scales, as gathered
            if self.mesh is None:
                return q[idx].to(torch.float32) * self._buffers[f"{table}__scale"][idx]
            return (self._gather(table, q.to(torch.float32), idx)
                    * self._gather(table, self._buffers[f"{table}__scale"], idx))
        return self._gather(table, self.tables[table], idx)

    def quantize_(self, table: str, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Serve ``table`` from int8 rows ``q`` (rows, dim) and per-row f32
        ``scale`` (rows, 1) (``serving/quantize.py``): both become buffers
        ``<table>__q`` / ``<table>__scale`` on the table's device and the f32
        parameter leaves the module.  Serving only; a gather-path table only."""
        tab = self.tables[table]
        if self._is_dense(table) or q.shape != tab.shape or scale.shape != (tab.shape[0], 1):
            raise ValueError(f"quantize_ {table!r}: a gather-path table of shape "
                             f"{tuple(tab.shape)} takes q of that shape and (rows, 1) "
                             f"scales, got {tuple(q.shape)} and {tuple(scale.shape)}")
        del self.tables[table]
        self.register_buffer(f"{table}__q", q.to(tab.device, torch.int8))
        self.register_buffer(f"{table}__scale", scale.to(tab.device, torch.float32))

    def _dense_rows(self, table: str, ids: torch.Tensor) -> torch.Tensor:
        """Masked one-hot rule: rows of ids in [1, num_rows), zero elsewhere."""
        valid = (ids > 0) & (ids < self.specs[table].num_rows)
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
        emb = self._clip_gather(table, ids, compact=True)
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
