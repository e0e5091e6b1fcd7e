"""Where the port runs, and how a host batch reaches it.

:func:`resolve_device` names the device; :func:`to_device` is the one put
of a host batch's columns (dicts of numpy arrays, or of the lists a JSON
request gives) onto it, for the trainer (its eager and its graph steps),
``parallel/multihost.global_batch``, the ``Predictor``, the artifact call
and the ``Retriever``.

On the CPU a column is taken as it is (:func:`host_tensor`), or copied into
``out``.  On a card the put is staged (span ``put.stage``): the columns are
packed into a pinned host buffer, in one :class:`Layout` a batch layout
(columns in name order, each at an offset aligned to 16 bytes), then copied
to the card in one non-blocking copy on the caller's current stream, and
handed out as typed views of one device buffer: a new one from the caching
allocator, or ``out``'s, which :func:`empty_batch` made.  Each thread keeps
a ring of :data:`SLOTS` staging buffers a layout; an event recorded after
each copy is waited on (span ``put.wait``) before the host writes into that
buffer again, so no bytes are overwritten while their copy is in flight,
and the host runs at most :data:`SLOTS` puts of a layout ahead of the card.
Every put packs the batch's bytes anew: nothing is cached by array and no
caller's memory is registered, so a caller may change or reuse its arrays
once the put returns.
"""

from __future__ import annotations

import collections
import threading
from typing import Collection, Mapping, NamedTuple

import numpy as np
import torch

from recalgorithm_tpu_torch.utils.summary import span

ALIGN = 16          # bytes; each column's offset in a packed buffer
SLOTS = 2           # staging buffers a layout, per thread
LAYOUTS_KEPT = 16   # rings a thread keeps, the least recently used dropped

_local = threading.local()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


def host_tensor(column) -> torch.Tensor:
    """A column as a CPU tensor, with ``np.asarray``'s dtype: over the
    array's own memory, or over a host copy where torch cannot take that
    memory (a negative stride, or a read-only buffer, whose tensor torch
    does not support)."""
    a = np.asarray(column)
    if not a.flags.writeable or min(a.strides, default=0) < 0:
        a = np.array(a)
    return torch.from_numpy(a)


class Layout(NamedTuple):
    """Where each column of a batch lies in one packed buffer."""

    key: tuple      # (name, shape, numpy dtype string) a column, in name order
    columns: tuple  # (name, byte offset, bytes, numpy dtype, torch dtype, shape)
    nbytes: int     # the buffer's size, a multiple of ALIGN


def _key(arrays: Mapping[str, np.ndarray]) -> tuple:
    return tuple(sorted((k, a.shape, a.dtype.str) for k, a in arrays.items()))


def layout(key: tuple) -> Layout:
    """The packed layout of a batch :func:`_key`: the columns in name
    order, each at an offset aligned to :data:`ALIGN` bytes.  A dtype torch
    has no tensor for raises as ``torch.from_numpy`` does."""
    columns, offset = [], 0
    for name, shape, dtype in key:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        columns.append((name, offset, n, dt, torch.from_numpy(np.empty(0, dt)).dtype, shape))
        offset += -(-n // ALIGN) * ALIGN
    return Layout(key, tuple(columns), offset)


def _views(flat: torch.Tensor, lay: Layout) -> dict[str, torch.Tensor]:
    """``lay``'s columns as typed views of the flat byte tensor ``flat``."""
    return {name: flat[o:o + n].view(tdt).view(shape)
            for name, o, n, _, tdt, shape in lay.columns}


class Packed(dict):
    """Columns that are typed views of one flat byte tensor, ``flat``, laid
    out as ``layout`` (:func:`empty_batch`): a put fills them all with one
    copy."""

    def __init__(self, flat: torch.Tensor, lay: Layout):
        super().__init__(_views(flat, lay))
        self.flat, self.layout = flat, lay


def empty_batch(batch: Mapping, device: str | torch.device) -> Packed:
    """Uninitialised columns shaped as ``batch``'s put on ``device``, as
    views of one buffer (a step graph's static inputs)."""
    lay = layout(_key({k: np.asarray(v) for k, v in batch.items()}))
    return Packed(torch.empty(lay.nbytes, dtype=torch.uint8, device=device), lay)


class _Ring:
    """One layout's staging buffers, host memory pinned on a card, each with
    the event recorded after its last copy (none on the CPU, where a copy
    has ended when it returns)."""

    def __init__(self, lay: Layout, device: torch.device):
        cuda = device.type == "cuda"
        self.layout = lay
        self.slots = [torch.empty(lay.nbytes, dtype=torch.uint8, pin_memory=cuda)
                      for _ in range(SLOTS)]
        self.hosts = [{name: s.numpy()[o:o + n].view(dt).reshape(shape)
                       for name, o, n, dt, _, shape in lay.columns} for s in self.slots]
        self.events = [torch.cuda.Event() if cuda else None for _ in range(SLOTS)]
        self.next = 0

    def put(self, arrays: Mapping[str, np.ndarray], dst: torch.Tensor) -> None:
        """Packs ``arrays`` into the next slot, once the copy last made from
        it has read it, and copies the slot into ``dst`` without blocking,
        on ``dst``'s device's current stream."""
        i = self.next
        self.next = (i + 1) % SLOTS
        event = self.events[i]
        if event is not None:
            with span("put.wait"):  # at once, unless the host is SLOTS puts ahead
                event.synchronize()
        for name, view in self.hosts[i].items():
            np.copyto(view, arrays[name])
        dst.copy_(self.slots[i], non_blocking=True)
        if event is not None:
            event.record(torch.cuda.current_stream(dst.device))


def _ring(key: tuple, device: torch.device) -> _Ring:
    """This thread's ring of ``key`` on ``device``, made at first sight."""
    rings = getattr(_local, "rings", None)
    if rings is None:
        rings = _local.rings = collections.OrderedDict()
    ring = rings.get((device, key))
    if ring is None:
        ring = rings[(device, key)] = _Ring(layout(key), device)
        if len(rings) > LAYOUTS_KEPT:
            # a dropped slot is not reused while a copy from it is in flight:
            # torch's pinned-memory cache holds it until the copy's event
            rings.popitem(last=False)
    else:
        rings.move_to_end((device, key))
    return ring


def staged_put(batch: Mapping, device: torch.device,
               columns: Collection[str] | None = None,
               out: Packed | None = None) -> dict[str, torch.Tensor]:
    """The put through this thread's staging ring (:func:`to_device` on a
    card; on the CPU, unpinned and without events, for its tests)."""
    names = out.keys() if out is not None else [
        k for k in batch if columns is None or k in columns]
    arrays = {k: np.asarray(batch[k]) for k in names}
    key = _key(arrays)
    if out is not None and (not isinstance(out, Packed) or out.layout.key != key):
        raise ValueError("out is not empty_batch's columns of this batch's layout")
    ring = _ring(key, device)
    dst = out.flat if out is not None else torch.empty(
        ring.layout.nbytes, dtype=torch.uint8, device=device)
    ring.put(arrays, dst)
    if out is not None:
        return out
    views = _views(dst, ring.layout)
    return {k: views[k] for k in names}  # the caller's order (an export's input spec)


def to_device(batch: Mapping, device: str | torch.device,
              columns: Collection[str] | None = None,
              out: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """``batch``'s columns on ``device``: those ``columns`` names (all where
    None) as new tensors, or with ``out`` copied in place into its tensors
    (a step graph's static inputs; on a card :func:`empty_batch`'s), one a
    column of ``out``'s names.  On a card the copy is staged and
    asynchronous (module docstring); the caller may change its arrays as
    soon as this returns."""
    device = torch.device(device)
    if device.type == "cuda":
        with span("put.stage"):
            return staged_put(batch, device, columns, out)
    if out is not None:
        for k, x in out.items():
            x.copy_(host_tensor(batch[k]))
        return out
    return {k: host_tensor(v).to(device) for k, v in batch.items()
            if columns is None or k in columns}
