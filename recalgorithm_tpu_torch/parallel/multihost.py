"""Several processes: process-group start, per-process input, agreed decisions.

Counterpart of ``recalgorithm_tpu/parallel/multihost.py`` on
``torch.distributed``.  One process drives one device (a "rank"); the JAX
package's host is this package's rank, and its process index/count are the
rank and world size.

  * :func:`initialize` starts the default process group from explicit
    arguments or from torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``); a no-op for one process.
    The backend follows the devices: NCCL when each rank has a card of its
    own, gloo when ranks share one card (NCCL refuses two ranks on one
    device) or run on the CPU.  Over gloo the tensors stay on the card;
  * :func:`host_shard_range` / :func:`data_shard`: which slice of a global
    range this process reads (its data row of the mesh);
  * :func:`global_batch` puts this rank's rows on its device after checking
    that they are its share of the global batch; nothing global is built;
  * :func:`agreed_flag`, :func:`agreed_all`, :func:`aligned_iterator` and
    :func:`synchronized_iterator` keep every process's host-side decisions
    the same, so that no rank enters a collective the others skip.  Their
    reduce functions are injectable for tests, with the JAX package's window
    semantics.
"""

from __future__ import annotations

import itertools
import os
from typing import Collection, Iterable, Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist

from recalgorithm_tpu_torch.utils.device import to_device


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str | torch.device = "cuda") -> str | None:
    """Start the default process group once; returns its backend, or None
    for a single process.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``); without it, torchrun's environment is read, and a
    world size of 1 (or none) starts nothing.  ``device`` is where this
    run's tensors live: ``cpu`` takes gloo; ``cuda`` takes NCCL when the
    host has a card for each of its ranks (``LOCAL_WORLD_SIZE``, else the
    world size) and gloo when they must share one."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return None
        backend = choose_backend(device, world)
        dist.init_process_group(backend, init_method="env://")
        return backend
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator_address needs num_processes and process_id")
    if num_processes <= 1:
        return None
    backend = choose_backend(device, num_processes)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return backend


def shutdown() -> None:
    """Destroy the default process group, if one was started (a gloo rank
    that exits without it can abort in the group's threads)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def choose_backend(device: str | torch.device, world: int) -> str:
    """NCCL when each rank on this host has a card of its own, gloo otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when the ranks have a card
    each (NCCL), the one shared card otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized() or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def data_shard(mesh=None) -> tuple[int, int]:
    """(index, count) of this process's input shard: its row of ``mesh``
    (the ranks of one row share a data shard), else its rank."""
    if mesh is not None:
        return mesh.data_index, mesh.data_size
    return process_index(), process_count()


def host_shard_range(total: int, mesh=None) -> tuple[int, int]:
    """[start, end) of a length-``total`` global range owned by this
    process's data shard; the last shard takes the remainder."""
    index, count = data_shard(mesh)
    per = total // count
    start = index * per
    return start, total if index == count - 1 else start + per


def global_batch(local_batch: Mapping[str, np.ndarray], mesh, global_batch_size: int,
                 device: str | torch.device,
                 columns: Collection[str] | None = None) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch (its ``columns``; all where None),
    on ``device``.  Each data shard holds ``global_batch_size /
    mesh.data_size`` rows; no global tensor is built (the collectives of the
    step see the others' rows)."""
    batch = to_device(local_batch, device, columns)
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"columns of unequal length: {sorted(rows)}")
    local_rows = rows.pop()
    if local_rows * mesh.data_size != global_batch_size:
        raise ValueError(f"{local_rows} local rows x {mesh.data_size} data shards != "
                         f"global batch {global_batch_size}")
    return batch


def all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The group's ``x`` (equal shapes) stacked along dim 0 in group-rank
    order.  Every collective of the port goes through this module; each one
    it uses runs on CUDA tensors over gloo as well as NCCL
    (``tools/collective_probe.py``)."""
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's ``1/size`` of its rows."""
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOver(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradients:
    every rank's loss reads the sum, so each rank's input gets all of them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (global batch statistics)."""
    return _SumOver.apply(x, group)


class _SumGrads(torch.autograd.Function):
    """The identity whose backward sums the gradient over the group: the
    input of a computation the group's ranks split between them (expert
    shards), each of which sees only its own part of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, with its gradient summed over ``group`` in backward."""
    return _SumGrads.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0.  With ``replicated`` the gathered tensor is
    consumed identically by every rank of the group (a data row gathering
    its experts): backward takes this rank's rows of its own gradient.
    Otherwise each rank's loss reads all rows (a data column gathering its
    items): backward sums the group's gradients, then takes this rank's
    rows."""

    @staticmethod
    def forward(ctx, x, group, size, index, replicated):
        ctx.group, ctx.size, ctx.index, ctx.replicated = group, size, index, replicated
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group, size)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            return reduce_scatter_rows(g, ctx.group, ctx.size), None, None, None, None
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None, None


def gather_rows(x: torch.Tensor, group, size: int, index: int,
                replicated: bool) -> torch.Tensor:
    """Differentiable all_gather of ``x`` along dim 0 over ``group`` (of
    ``size`` ranks, this one at ``index``); see :class:`_GatherRows`."""
    return _GatherRows.apply(x, group, size, index, replicated)


def collective_device() -> torch.device:
    """The device a host-side decision's tensor lives on: the rank's card
    under NCCL (which takes no CPU tensors), the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agreed_flag(flag: bool) -> bool:
    """Process 0's ``flag``, on every process (a broadcast).  For decisions
    that must be the same everywhere but come from one host's state (the
    wall clock of ``eval_throttle_secs``).  Every process calls it at the
    same point of its step sequence."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int32, device=collective_device())
    dist.broadcast(t, src=0)
    return bool(t.item())


def _all_reduce_ints(values: np.ndarray, op) -> np.ndarray:
    t = torch.from_numpy(np.asarray(values, np.int64)).to(collective_device())
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def agreed_all(flags, window: int | None = None, reduce_fn=None) -> np.ndarray:
    """Elementwise AND of per-batch booleans across processes (one
    collective); ``window`` pads a short list with True so the collective's
    shape stays fixed.  ``reduce_fn`` (int32 array -> elementwise global
    min) is injectable for tests; one process passes through."""
    arr = np.asarray(flags, np.int32)
    n = len(arr)
    if window is not None and n < window:
        arr = np.concatenate([arr, np.ones(window - n, np.int32)])
    if reduce_fn is None:
        if process_count() == 1:
            return arr.astype(bool)[:n]
        reduce_fn = lambda a: _all_reduce_ints(a, dist.ReduceOp.MIN)
    return np.asarray(reduce_fn(arr)).astype(bool)[:n]


def _global_count(op):
    return lambda count: int(_all_reduce_ints(np.asarray([count]), op)[0])


def aligned_iterator(it: Iterable, make_pad, reduce_max=None, window: int = 8) -> Iterator:
    """Eval lock-step that pads short processes instead of dropping rows:
    per window of ``window`` items, every process yields the global maximum
    count, topping up with ``make_pad()`` (a zero-weight batch), so each
    process enters the same number of collective eval steps and every real
    row is scored once.  ``reduce_max`` (local count -> global max) is
    injectable; one process passes through."""
    it = iter(it)
    if reduce_max is None:
        if process_count() == 1:
            yield from it
            return
        reduce_max = _global_count(dist.ReduceOp.MAX)
    while True:
        buf = list(itertools.islice(it, window))
        m = reduce_max(len(buf))
        if m == 0:
            return
        yield from buf
        for _ in range(m - len(buf)):
            yield make_pad()
        if m < window:
            return


def synchronized_iterator(it: Iterable, reduce_min=None, window: int = 8) -> Iterator:
    """Training lock-step at the end of per-process input: per window of
    ``window`` items, every process yields the global minimum count, so no
    process leaves the step loop while the others enter a collective step
    (one collective a window; an end-of-data tail under ``window`` items is
    dropped, as drop_remainder drops it).  ``reduce_min`` is injectable; one
    process passes through."""
    it = iter(it)
    if reduce_min is None:
        if process_count() == 1:
            yield from it
            return
        reduce_min = _global_count(dist.ReduceOp.MIN)
    while True:
        buf = list(itertools.islice(it, window))
        m = reduce_min(len(buf))
        yield from buf[:m]
        if m < window:
            return
