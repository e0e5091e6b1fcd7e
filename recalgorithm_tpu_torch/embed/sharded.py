"""Row-sharded embedding lookup: an explicit exchange on torch.distributed.

Counterpart of ``recalgorithm_tpu/embed/sharded.py`` (the ``shard_map``
exchange).  Rank ``r`` of an N-rank mesh holds rows ``[r V/N, (r+1) V/N)`` of
the table; a data row of the mesh (the ranks that share a data shard) holds
the same ids.

  forward:  all_gather(the local ids over the data group)   # (D n,) ints
            masked gather from the shard                    # rows elsewhere -> 0
            reduce_scatter(SUM over all ranks)              # chunk r of the rows
            all_gather(the chunks over the model group)     # this data row's rows
  backward: this rank's chunk of the output gradient
            all_gather(the chunks over all ranks)           # the global gradient
            masked index_add_ into the shard's gradient     # never (V, K) dense

Each row lives on exactly one rank, so the sum is the exchange.  The chunk
of rank ``r = d M + m`` is rows ``[m c, (m+1) c)`` of data row ``d`` (``c =
n / M``), so the model group's chunks, in order, are that data row's rows.
Backward takes only this rank's chunk because every rank of a data row holds
the same output gradient; the result is the gradient of the sum of the data
rows' losses, which the trainer scales to the global mean.

Where a data row's ``n`` ids do not divide the model axis, the ids are padded
with -1 (a zero row, no gradient) and the padding is dropped after the
exchange: the JAX package's caller falls back to the plain gather there.
Out-of-range ids give zero rows.  The plain version beside it is the
one-process gather (:func:`plain_lookup`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recalgorithm_tpu_torch.parallel import multihost


def plain_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The one-process lookup: rows of ids in [0, V), zero rows elsewhere."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = F.embedding(ids.long().clamp(0, table.shape[0] - 1), table)
    return rows * valid[..., None].to(rows.dtype)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ids, mesh):
        rows, n_pad = shard.shape[0], ids.shape[0]
        d, m = mesh.data_size, mesh.num_model
        ids_global = multihost.all_gather_rows(ids, mesh.data_group, d)      # (D n,)
        local = ids_global - mesh.rank * rows
        in_range = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        part = F.embedding(local, shard) * in_range[:, None].to(shard.dtype)
        chunk = multihost.reduce_scatter_rows(part, None, mesh.world)      # (n / M, K)
        ctx.save_for_backward(local, in_range)
        ctx.mesh, ctx.rows, ctx.n_pad = mesh, rows, n_pad
        return multihost.all_gather_rows(chunk, mesh.model_group, m)       # (n, K)

    @staticmethod
    def backward(ctx, g):
        local, in_range = ctx.saved_tensors
        mesh = ctx.mesh
        c = ctx.n_pad // mesh.num_model
        mine = g[mesh.model_index * c:(mesh.model_index + 1) * c].contiguous()
        g_full = multihost.all_gather_rows(mine, None, mesh.world)         # (D n, K)
        g_full = g_full * in_range[:, None].to(g_full.dtype)
        dshard = torch.zeros(ctx.rows, g.shape[1], dtype=g.dtype, device=g.device)
        dshard.index_add_(0, local, g_full)
        return dshard, None, None


def sharded_lookup(shard: torch.Tensor, ids: torch.Tensor, mesh, num_rows: int
                   ) -> torch.Tensor:
    """Row-sharded gather: ``ids`` (any shape, this data row's ids, equal in
    shape on every rank) -> ``ids.shape + (K,)``.  ``shard`` is this rank's
    ``(num_rows / N, K)`` rows of a ``(num_rows, K)`` table; every rank of
    the mesh calls it at once (it is collective).  Raises ValueError when
    ``num_rows`` does not divide the N ranks or the shard is not its share."""
    if num_rows % mesh.world:
        raise ValueError(f"table rows {num_rows} not divisible by shard count {mesh.world}")
    if shard.dim() != 2 or shard.shape[0] != num_rows // mesh.world:
        raise ValueError(f"a shard of a ({num_rows}, K) table over {mesh.world} ranks is "
                         f"({num_rows // mesh.world}, K), got {tuple(shard.shape)}")
    if ids.dtype.is_floating_point:
        raise ValueError(f"ids must be integers, got {ids.dtype}")
    flat = ids.reshape(-1).long()
    n = flat.shape[0]
    pad = (-n) % mesh.num_model
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), -1)])
    out = _Exchange.apply(shard, flat, mesh)
    return out[:n].reshape(*ids.shape, shard.shape[1])
