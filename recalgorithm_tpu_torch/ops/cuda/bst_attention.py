"""BST masked multi-head attention: the CUDA kernels' wrappers and their plain twin.

Counterpart of ``recalgorithm_tpu/ops/pallas/bst_attention.py``.  One
``(B, H, T, d)`` layout stands for both of its entry points
(``bst_mha_fused`` and the TPU-layout ``bst_mha_fused_t``).  The kernels are
``csrc/bst_attention.cu`` (its source note gives the design and the bound):

  * :func:`bst_attention_forward`: softmax(mask(q kᵀ/√d)) v, P kept on chip;
  * :func:`bst_attention_forward_save`: the same, and P written out (f32, or
    bf16 under ``save_bf16``) for the backward;
  * :func:`bst_attention_backward`: dq, dk, dv from the saved P.

:func:`bst_mha` is the entry point the model calls.  With no gradient
wanted (``no_grad``, ``inference_mode``, an exported graph) it calls the op
``recalgorithm_torch::bst_mha_forward``: the forward without P on CUDA
tensors, the plain twin :func:`bst_mha_reference` on CPU tensors.  With a
gradient wanted CPU tensors take the twin (autograd through it gives the
gradients), CUDA tensors the forward with P inside a
``torch.autograd.Function`` whose backward is the backward kernel.  There is
no fallback on the card: a kernel runs or the call raises.

Semantics are ``mha_reference``'s: key-side mask j < len, a row with
``len = 0`` attends uniformly over all T keys and passes no gradient to q or
k, lengths above T clip to T.  ``save_bf16`` changes the gradients only (P is
rounded to bf16 between the kernels); the twin ignores it.
"""

from __future__ import annotations

import ctypes

import torch

from recalgorithm_tpu_torch.ops.cuda import _build

NEG_INF = -(2.0**32) + 1  # the reference's masking constant

# shapes the kernels are compiled for (constants of csrc/bst_attention.cu)
KERNEL_D, KERNEL_T_MAX = 16, 64


def attention_probs_reference(q: torch.Tensor, k: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """P = softmax(mask(q kᵀ/√d)), (B, H, T, T): what the saving forward writes."""
    b, h, t, d = q.shape
    logits = torch.einsum("bhik,bhjk->bhij", q, k) / d**0.5
    mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    return torch.softmax(logits, dim=-1)


def bst_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of ``mha_reference``: the CPU path and the kernels'
    oracle."""
    return torch.einsum("bhij,bhjk->bhik", attention_probs_reference(q, k, lengths), v)


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("bst_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 9 + [_I] * 4 + [_P]


def _check(lengths: torch.Tensor, **tensors: torch.Tensor) -> tuple[int, int, int]:
    """Raise on what the kernels do not take; returns (B, H, T)."""
    shape = tuple(tensors["q"].shape)
    if len(shape) != 4 or shape[3] != KERNEL_D:
        raise ValueError(f"bst_attention: q has shape {shape}, the kernels take "
                         f"(B, H, T, {KERNEL_D})")
    b, h, t, _ = shape
    if not 1 <= t <= KERNEL_T_MAX:
        raise ValueError(f"bst_attention: sequence length {t} outside [1, {KERNEL_T_MAX}]")
    dev = tensors["q"].device
    for name, x in tensors.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"bst_attention: {name} has shape {tuple(x.shape)}, q {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"bst_attention: {name} is {x.dtype}, not float32")
        if x.device != dev:
            raise ValueError(f"bst_attention: {name} on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"bst_attention: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"bst_attention: {name} is not 16-byte aligned")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"bst_attention: lengths must be int32 of shape ({b},), "
                        f"got {lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != dev or not lengths.is_contiguous():
        raise ValueError(f"bst_attention: lengths on {lengths.device} (q on {dev}) "
                         "or not contiguous")
    return b, h, t


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def bst_attention_forward(q, k, v, lengths) -> torch.Tensor:
    """The inference forward kernel, (B, H, T, d); counted in ``.launches``."""
    b, h, t = _check(lengths, q=q, k=k, v=v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn("bst_attention_forward", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None, b, h, t, 0, _stream(q))
    _raise_on(rc, "bst_attention_forward")
    bst_attention_forward.launches += 1
    return out


def bst_attention_forward_save(q, k, v, lengths, save_bf16: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward kernel: (o, P), P (B, H, T, T) in f32 or bf16;
    counted in ``.launches``."""
    b, h, t = _check(lengths, q=q, k=k, v=v)
    out = torch.empty_like(q)
    probs = torch.empty(b, h, t, t, device=q.device,
                        dtype=torch.bfloat16 if save_bf16 else torch.float32)
    with torch.cuda.device(q.device):
        rc = _fn("bst_attention_forward", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), probs.data_ptr(), b, h, t, 2 if save_bf16 else 1,
            _stream(q))
    _raise_on(rc, "bst_attention_forward_save")
    bst_attention_forward_save.launches += 1
    return out, probs


def bst_attention_backward(q, k, v, probs, dout, lengths
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: (dq, dk, dv) from the saved P; counted in
    ``.launches``."""
    b, h, t = _check(lengths, q=q, k=k, v=v, dout=dout)
    if (tuple(probs.shape) != (b, h, t, t) or probs.device != q.device
            or probs.dtype not in (torch.float32, torch.bfloat16)
            or not probs.is_contiguous()):
        raise ValueError(f"bst_attention_backward: P must be contiguous f32 or bf16 "
                         f"of shape {(b, h, t, t)} on {q.device}, got {probs.dtype} "
                         f"{tuple(probs.shape)} on {probs.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        rc = _fn("bst_attention_backward", _BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), probs.data_ptr(),
            dout.data_ptr(), lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, t, int(probs.dtype == torch.bfloat16), _stream(q))
    _raise_on(rc, "bst_attention_backward")
    bst_attention_backward.launches += 1
    return dq, dk, dv


bst_attention_forward.launches = 0
bst_attention_forward_save.launches = 0
bst_attention_backward.launches = 0


class _BSTAttention(torch.autograd.Function):
    """Forward kernel with P saved; backward kernel from it."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, save_bf16):
        out, probs = bst_attention_forward_save(q, k, v, lengths, save_bf16)
        ctx.save_for_backward(q, k, v, probs, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, probs, lengths = ctx.saved_tensors
        dq, dk, dv = bst_attention_backward(q, k, v, probs, dout.contiguous(), lengths)
        return dq, dk, dv, None, None


def bst_mha(q: torch.Tensor,        # (B, H, T, d) f32
            k: torch.Tensor,
            v: torch.Tensor,
            lengths: torch.Tensor,  # (B,) int32, valid KEY positions
            save_bf16: bool = False) -> torch.Tensor:
    """Masked multi-head attention, (B, H, T, d).  CPU: the twin; CUDA: the
    kernels (with P saved and the backward kernel when a gradient is wanted).
    Without a gradient both devices go through the op
    ``recalgorithm_torch::bst_mha_forward``, so a traced graph holds one op
    node that dispatches on the device it runs on."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bst_mha: no kernel for device {q.device}")
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))):
        return bst_mha_forward(q, k, v, lengths)
    if q.device.type == "cpu":
        return bst_mha_reference(q, k, v, lengths)
    return _BSTAttention.apply(q, k, v, lengths, save_bf16)


@torch.library.custom_op("recalgorithm_torch::bst_mha_forward", mutates_args=(),
                         device_types="cuda")
def bst_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The inference forward as a torch op: :func:`bst_attention_forward` (the
    kernel, checked and counted) on the card, the twin on the CPU (registered
    below), a shape-only fake for tracing."""
    return bst_attention_forward(q, k, v, lengths)


@bst_mha_forward.register_kernel("cpu")
def _bst_mha_forward_cpu(q, k, v, lengths):
    return bst_mha_reference(q, k, v, lengths)


@bst_mha_forward.register_fake
def _bst_mha_forward_fake(q, k, v, lengths):
    return torch.empty_like(q)
