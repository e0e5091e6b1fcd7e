"""PAD-compacted table gradient for long padded sequence lookups.

Counterpart of ``recalgorithm_tpu/ops/compact_scatter.py``.  The backward of
a (B, T) sequence gather is a scatter-add of B*T cotangent rows into the
table, and a 7-day behaviour sequence is mostly PAD (the engine zeroes those
rows, so they add nothing to any row but the PAD row 0).  This module
scatters only the live entries, with static shapes and no host sync:

  * sequences are valid-prefix padded (row b holds ids[b, :len_b] then 0s),
    and a running count over the live prefixes gives each live entry its
    slot in row-major order (the JAX module finds the same entry of each
    slot with a searchsorted over the rows' offsets; a cumsum and one
    scatter of positions take fewer launches here);
  * the first ``cap`` live entries are gathered into a ``cap``-row buffer
    (ids and cotangent rows) and reduced into the (num_rows, K) gradient by
    ``torch.ops.aten.embedding_dense_backward``, the reduction
    ``F.embedding``'s own backward runs: a stable sort of the ids, then a
    sum of each id's rows in position order.  No atomics, so the result is
    the same in every run, and every row but the PAD row 0 sums the same
    terms in the same order as the full gradient;
  * whether a batch fits the cap is decided on the HOST from its ``*_len``
    columns (:func:`batch_fits_compact`); the trainer runs a batch that does
    not fit with compaction off (``embed/tables.compact_grad_scatter``), so
    the gradient is exact at every density.

:func:`take_compact_bwd` is the gather behind that switch: the forward is
the clip-mode gather, the backward :func:`scatter_grad`.  It is plain torch:
the JAX module is XLA code, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The compact buffer holds B*T // CAP_DIVISOR entries (at least 256); a batch
# whose live count exceeds it runs with compaction off.  Only long sequences
# (T >= LONG_SEQ_T) compact, and only lookups of at least MIN_IDS ids: the
# engine (embed/tables.py) and the host check below read these same values.
CAP_DIVISOR = 4
LONG_SEQ_T = 32
MIN_IDS = 16384


def _live_lens(ids: torch.Tensor) -> torch.Tensor:
    """Per-row live length: (highest position with id > 0) + 1.

    Not ``(ids > 0).sum(1)``: an interior PAD hole must stay inside the
    walked range so that every id > 0 is covered; a hole scatters its
    (engine-masked, zero) cotangent into row 0, as the full gradient does."""
    pos = torch.arange(1, ids.shape[1] + 1, device=ids.device)
    return torch.where(ids > 0, pos, 0).amax(dim=1)


def _compact_scatter(ids: torch.Tensor, g: torch.Tensor, num_rows: int,
                     cap: int) -> torch.Tensor:
    """The (num_rows, K) gradient from the first ``cap`` live entries of the
    (B, T) valid-prefix ``ids`` (already in ``[0, num_rows)``) and their
    (B, T, K) cotangent ``g`` (the caller ensures the live count fits
    ``cap``)."""
    b, t = ids.shape
    n, k = b * t, g.shape[-1]
    live = (torch.arange(t, device=ids.device) < _live_lens(ids)[:, None]).reshape(-1)
    # each live entry's 1-based slot in row-major order; 0 for the rest and
    # cap + 1 past the cap (both spare slots, dropped)
    slot = (torch.cumsum(live, 0) * live).clamp_(max=cap + 1)
    src = torch.full((cap + 2,), -1, dtype=torch.long, device=ids.device)
    flat_idx = src.scatter_(0, slot, torch.arange(n, device=ids.device))[1:cap + 1]
    valid = flat_idx >= 0  # a prefix of the slots: the live count's
    flat_idx.clamp_(min=0)
    idv = torch.where(valid, ids.reshape(-1)[flat_idx], 0)
    gv = torch.where(valid[:, None], g.reshape(-1, k)[flat_idx], 0.0)
    return torch.ops.aten.embedding_dense_backward(gv, idv, num_rows, -1, False)


def scatter_grad(ids: torch.Tensor, g: torch.Tensor, num_rows: int,
                 cap_divisor: int | None = None) -> torch.Tensor:
    """The table gradient of a (B, T) valid-prefix id batch, scattering only
    the first ``max(256, B*T // cap_divisor)`` live entries.

    CONTRACT: the batch's live count fits that cap; entries beyond it are
    dropped.  The check is :func:`batch_fits_compact`, on the host: a branch
    on the device would need the count on the host first."""
    if cap_divisor is None:
        cap_divisor = CAP_DIVISOR
    return _compact_scatter(ids.long().clamp(0, num_rows - 1), g, num_rows,
                            max(256, ids.numel() // cap_divisor))


def eligible_seq_features(schema) -> list:
    """The schema's sequence features whose lookups the engine may compact
    (the engine checks ``ids.shape[-1] >= LONG_SEQ_T`` on the lookup)."""
    return [f for f in schema.sequence if f.max_length >= LONG_SEQ_T]


def batch_fits_compact(batch, schema, min_ids: int | None = None) -> bool:
    """Host-side check: every compact-eligible lookup of this host batch fits
    its compact buffer.

    Every (B, T) lookup the engine may compact reads a schema sequence
    feature, so checking sum(lens) <= B*T // cap_divisor for each of them
    bounds them all.  A batch without a ``*_len`` column counts live
    prefixes from the id array itself (the engine still compacts that
    lookup)."""
    if min_ids is None:
        min_ids = MIN_IDS
    for f in eligible_seq_features(schema):
        lens = batch.get(f.name + "_len")
        if lens is None:
            ids = batch.get(f.name)
            if ids is None:
                continue  # feature absent: the engine gets no lookup
            a = np.asarray(ids) > 0
            # (highest position with id > 0) + 1, as _live_lens
            lens = np.where(a.any(axis=1), a.shape[1] - np.argmax(a[:, ::-1], axis=1), 0)
        n = np.asarray(lens).shape[0] * f.max_length
        if n >= min_ids and int(np.sum(lens)) > n // CAP_DIVISOR:
            return False
    return True


class TakeCompactBwd(torch.autograd.Function):
    """``table[ids.clamp(0, rows - 1)]`` whose backward is the PAD-compacted
    gradient (:func:`scatter_grad`) for the table and none for the ids.

    The forward equals the clip gather for any input.  The table gradient
    is bitwise the full one on every row but row 0 whenever the live count
    fits the cap and every non-prefix position carries a zero cotangent (the
    engine multiplies PAD rows by 0)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        idx = ids.long().clamp(0, table.shape[0] - 1)
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return _compact_scatter(idx, g.contiguous(), ctx.num_rows,
                                max(256, idx.numel() // CAP_DIVISOR)), None


take_compact_bwd = TakeCompactBwd.apply
