"""DIN target attention: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``recalgorithm_tpu/ops/pallas/din_attention.py``.  The kernel
is ``csrc/din_attention.cu`` (its source note gives the design and the
bound); :func:`din_attention` launches it for CUDA tensors and takes
:func:`din_attention_reference`, the same math in plain torch, for CPU
tensors.  On the card there is no fallback: the kernel runs or the call
raises.  The inference forward is also the op
``recalgorithm_torch::din_attention`` (:func:`din_attention_op`), which a
``torch.export`` graph holds as one node.

Weights are in torch ``Linear`` layout: w1 (64, 4H), b1 (64,), w2 (32, 64),
b2 (32,), w3 (1, 32), b3 (1,).  On the card the forward is the kernel and
the backward is autograd through a recompute of the twin, as the JAX
package's ``_fused_bwd`` takes ``jax.vjp`` of ``din_attention_reference``
(the JAX package has no backward kernel for DIN attention).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from recalgorithm_tpu_torch.ops.cuda import _build

NEG_INF = -(2.0**32) + 1  # the reference's masking constant

# shapes the kernel is compiled for (constants of csrc/din_attention.cu)
KERNEL_H, KERNEL_A1, KERNEL_A2, KERNEL_T_MAX = 16, 64, 32, 64


def din_attention_reference(query, keys, lengths, w1, b1, w2, b2, w3, b3,
                            use_softmax: bool = False) -> torch.Tensor:
    """Plain torch (identical math to ops.attention.DINAttention in the JAX
    package): the CPU path and the kernel's oracle."""
    b, t, h = keys.shape
    q = query[:, None, :].expand(b, t, h)
    x = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    x = torch.relu(F.linear(x, w1, b1))
    x = torch.relu(F.linear(x, w2, b2))
    w = F.linear(x, w3, b3)[..., 0]
    mask = torch.arange(t, device=keys.device)[None, :] < lengths[:, None]
    if use_softmax:
        w = torch.where(mask, w, torch.full_like(w, NEG_INF))
        w = torch.softmax(w / h**0.5, dim=1)
    else:
        w = w * mask.to(w.dtype)
    return torch.einsum("bt,bth->bh", w, keys)


def _forward_fn():
    fn = _build.load("din_attention").din_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(query, keys, lengths, weights):
    b, t, h = keys.shape
    want = {
        "query": (query, (b, KERNEL_H)), "keys": (keys, (b, t, KERNEL_H)),
        "w1": (weights[0], (KERNEL_A1, 4 * KERNEL_H)), "b1": (weights[1], (KERNEL_A1,)),
        "w2": (weights[2], (KERNEL_A2, KERNEL_A1)), "b2": (weights[3], (KERNEL_A2,)),
        "w3": (weights[4], (1, KERNEL_A2)), "b3": (weights[5], (1,)),
    }
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"din_attention: {name} has shape {tuple(x.shape)}, "
                             f"the kernel takes {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"din_attention: {name} is {x.dtype}, not float32")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"din_attention: lengths must be int32 of shape ({b},), "
                        f"got {lengths.dtype} {tuple(lengths.shape)}")
    if not 1 <= t <= KERNEL_T_MAX:
        raise ValueError(f"din_attention: sequence length {t} outside "
                         f"[1, {KERNEL_T_MAX}]")
    for name, x in [("query", query), ("keys", keys), ("lengths", lengths),
                    *zip(("w1", "b1", "w2", "b2", "w3", "b3"), weights)]:
        if x.device != keys.device:
            raise ValueError(f"din_attention: {name} on {x.device}, keys on {keys.device}")
        if not x.is_contiguous():
            raise ValueError(f"din_attention: {name} is not contiguous")
    for name, x in (("query", query), ("keys", keys)):
        if x.data_ptr() % 16:
            raise ValueError(f"din_attention: {name} is not 16-byte aligned")


def _launch(query, keys, lengths, weights, use_softmax: bool) -> torch.Tensor:
    _check(query, keys, lengths, weights)
    b, t, _ = keys.shape
    out = torch.empty(b, KERNEL_H, device=keys.device, dtype=torch.float32)
    fn = _forward_fn()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = fn(query.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                *(x.data_ptr() for x in weights), out.data_ptr(),
                b, t, int(use_softmax), stream)
    if rc != 0:
        raise RuntimeError(f"din_attention kernel launch failed: CUDA error {rc}")
    din_attention.launches += 1
    return out


@torch.library.custom_op("recalgorithm_torch::din_attention", mutates_args=(),
                         device_types="cuda")
def din_attention_op(query: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                     use_softmax: bool) -> torch.Tensor:
    """The inference forward as a torch op: the kernel on the card (checked
    and counted by ``_launch``), the twin on the CPU (registered below), a
    shape-only fake for tracing."""
    return _launch(query, keys, lengths, (w1, b1, w2, b2, w3, b3), use_softmax)


@din_attention_op.register_kernel("cpu")
def _din_attention_op_cpu(query, keys, lengths, w1, b1, w2, b2, w3, b3, use_softmax):
    return din_attention_reference(query, keys, lengths, w1, b1, w2, b2, w3, b3,
                                   use_softmax)


@din_attention_op.register_fake
def _din_attention_op_fake(query, keys, lengths, w1, b1, w2, b2, w3, b3, use_softmax):
    return keys.new_empty((keys.shape[0], keys.shape[2]))


class _DINAttention(torch.autograd.Function):
    """Kernel forward; backward by autograd through the twin's recompute."""

    @staticmethod
    def forward(ctx, query, keys, lengths, use_softmax, *weights):
        ctx.use_softmax = use_softmax
        ctx.save_for_backward(query, keys, lengths, *weights)
        return _launch(query, keys, lengths, weights, use_softmax)

    @staticmethod
    def backward(ctx, grad):
        query, keys, lengths, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        inputs = [x.detach().requires_grad_(n) for x, n in
                  zip((query, keys, *weights), (need[0], need[1], *need[4:]))]
        with torch.enable_grad():
            out = din_attention_reference(inputs[0], inputs[1], lengths, *inputs[2:],
                                          use_softmax=ctx.use_softmax)
        wanted = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad))
        grads = [next(got) if x.requires_grad else None for x in inputs]
        return grads[0], grads[1], None, None, *grads[2:]


def din_attention(query: torch.Tensor,    # (B, H) f32
                  keys: torch.Tensor,     # (B, T, H) f32
                  lengths: torch.Tensor,  # (B,) int32
                  w1, b1, w2, b2, w3, b3,
                  use_softmax: bool = False) -> torch.Tensor:
    """DIN attention pooling, (B, H).  CPU tensors: the plain twin.  CUDA
    tensors: the kernel, counted in ``din_attention.launches``, inside an
    autograd Function when a gradient is wanted.  Without a gradient both
    devices go through the op ``recalgorithm_torch::din_attention``, so a
    traced graph (``serving/export.py``) holds one op node that dispatches
    on the device it runs on."""
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"din_attention: no kernel for device {keys.device}")
    weights = (w1, b1, w2, b2, w3, b3)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (query, keys, *weights))):
        return din_attention_op(query, keys, lengths, *weights, use_softmax)
    if keys.device.type == "cpu":
        return din_attention_reference(query, keys, lengths, *weights, use_softmax)
    return _DINAttention.apply(query, keys, lengths, use_softmax, *weights)


din_attention.launches = 0
