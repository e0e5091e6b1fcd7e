"""Adagrad on a table's touched rows: the CUDA kernel's wrapper and its plain twin.

Replaces no kernel of the JAX package, which updates every row of a table
with optax's dense Adagrad.  A table's step touches only the rows its ids
reach, and an untouched row does not move under Adagrad, so
``train/optimizers.Adagrad`` applies a row gradient (``embed/tables.
row_sparse_grads``: the ids beside one gradient row each, uncoalesced) to
those rows alone.  The kernel is ``csrc/row_adagrad.cu`` (its source note
gives the design; the bound is bytes).  :func:`row_adagrad` launches it for
CUDA tensors after sorting the ids on the device, and takes
:func:`row_adagrad_reference`, the same update in plain torch, for CPU
tensors.  On the card there is no fallback: the kernel runs or the call
raises.  Nothing here waits on the device.
"""

from __future__ import annotations

import ctypes

import torch

from recalgorithm_tpu_torch.ops.cuda import _build

# sorted positions a warp of the kernel takes (CHUNK of csrc/row_adagrad.cu):
# the scratch holds one row a chunk
CHUNK = 32
# the widest row the kernel takes on its float4 path (4 float4 a lane) and
# on its scalar path (4 floats a lane)
MAX_DIM, MAX_DIM_SCALAR = 512, 128


def row_adagrad_reference(param: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                          values: torch.Tensor, lr: float, eps: float) -> None:
    """Plain torch, in place: each distinct id's rows of ``values`` summed
    in position order, then the dense chain's ops (``optimizers.Adagrad``)
    on those rows of ``param`` and ``acc``.  The CPU path and the kernel's
    oracle."""
    rows, inverse = torch.unique(ids, return_inverse=True)
    g = values.new_zeros(len(rows), values.shape[1]).index_add_(0, inverse, values)
    a = acc[rows]
    a.add_(g * g)
    scale = torch.rsqrt(a + eps)
    scale.mul_(torch.sign(a))
    p = param[rows]
    p.add_(scale * g, alpha=-lr)
    acc[rows] = a
    param[rows] = p


def _fn():
    fn = _build.load("row_adagrad").row_adagrad
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(param, acc, ids, values) -> None:
    rows, dim = param.shape
    for name, x in (("param", param), ("acc", acc), ("values", values)):
        if x.dtype != torch.float32:
            raise TypeError(f"row_adagrad: {name} is {x.dtype}, not float32")
        if not x.is_contiguous():
            raise ValueError(f"row_adagrad: {name} is not contiguous")
        if x.device != param.device:
            raise ValueError(f"row_adagrad: {name} on {x.device}, param on {param.device}")
    if acc.shape != param.shape:
        raise ValueError(f"row_adagrad: acc {tuple(acc.shape)} beside param "
                         f"{tuple(param.shape)}")
    if ids.dim() != 1 or values.shape != (ids.shape[0], dim) or ids.device != param.device:
        raise ValueError(f"row_adagrad: ids {tuple(ids.shape)} on {ids.device} and values "
                         f"{tuple(values.shape)} for a table of {dim} columns")
    if dim > (MAX_DIM if dim % 4 == 0 else MAX_DIM_SCALAR):
        raise ValueError(f"row_adagrad: rows of {dim} floats; the kernel takes up to "
                         f"{MAX_DIM} (a multiple of 4) or {MAX_DIM_SCALAR}")
    if rows >= 2**31 or ids.shape[0] >= 2**31 - 2 * CHUNK:
        raise ValueError(f"row_adagrad: {rows} rows or {ids.shape[0]} ids beyond 32-bit indices")
    if dim % 4 == 0 and any(x.data_ptr() % 16 for x in (param, acc, values)):
        raise ValueError("row_adagrad: param, acc and values must be 16-byte aligned")


def row_adagrad(param: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                values: torch.Tensor, lr: float, eps: float) -> None:
    """Adagrad on the rows ``ids`` (1-d, in ``[0, rows)``, repeats summed)
    of ``param`` and its accumulator ``acc`` ((rows, dim) f32, in place),
    with ``values`` (len(ids), dim) the gradient row of each id; the rate
    ``lr`` is a host float.  CPU tensors: the plain twin.  CUDA tensors:
    the ids sorted (stable) and one kernel launch, counted in
    ``row_adagrad.launches``."""
    if param.device.type == "cpu":
        row_adagrad_reference(param, acc, ids, values, lr, eps)
        return
    if param.device.type != "cuda":
        raise ValueError(f"row_adagrad: no kernel for device {param.device}")
    values = values.contiguous()
    _check(param, acc, ids, values)
    n, (rows, dim) = ids.shape[0], param.shape
    keys, order = torch.sort(ids.to(torch.int32), stable=True)
    chunks = -(-n // CHUNK)
    # one zeroed buffer: a row of partial sums a chunk, then a counter a chunk
    scratch = torch.zeros(chunks * (dim + 1), device=param.device, dtype=torch.float32)
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream(param.device).cuda_stream
        rc = _fn()(keys.data_ptr(), order.data_ptr(), values.data_ptr(), param.data_ptr(),
                   acc.data_ptr(), scratch.data_ptr(),
                   scratch.data_ptr() + 4 * chunks * dim, n, rows, dim, lr, eps, stream)
    if rc != 0:
        raise RuntimeError(f"row_adagrad kernel launch failed: CUDA error {rc}")
    row_adagrad.launches += 1


row_adagrad.launches = 0
