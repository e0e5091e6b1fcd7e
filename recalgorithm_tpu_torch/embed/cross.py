"""Hashed cross features, computed on the device from integer ids.

Counterpart of ``recalgorithm_tpu/embed/cross.py``, bit for bit.  It
replaces ``fc.crossed_column([userid, manual_tag_list],
hash_bucket_size=100000)`` (reference wide_and_deep.py:121-124): the
reference hashes the crossed *strings* with FarmHash64, here the integer id
pair goes through a 32-bit splitmix finalizer, as in the JAX package.

The JAX function computes in uint32.  torch has no uint32 arithmetic, so the
values live in int64 and every step keeps the low 32 bits: each product by a
32-bit constant is split into its low and high 16-bit halves so that no
intermediate leaves int64's range, and sums and shifts are masked with
``& 0xFFFFFFFF``.

The cross of a scalar field with a padded sequence field gives one bucket
per sequence slot; PAD slots (either side 0) map to bucket 0, which the
lookups mask (id 0 = PAD, as for every table).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit splitmix-style avalanche of x in [0, 2^32) (int64 in and out)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hashed_cross(a_ids: torch.Tensor, b_ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Cross two id arrays into hash buckets in [1, num_buckets].

    a_ids: (B,) scalar ids (0 = missing); b_ids: (B,) or (B, T) ids (0 =
    PAD/missing).  Returns int32 of ``b_ids``'s shape; positions where either
    side is 0 map to 0.  An id's uint32 value is its int32 bits, as the JAX
    package's ``astype(uint32)`` reads them."""
    a = a_ids.to(torch.int64) & _MASK
    b = b_ids.to(torch.int64) & _MASK
    valid_a = a_ids > 0
    if b.ndim == a.ndim + 1:
        a, valid_a = a[..., None], valid_a[..., None]
    h = _mix32((_mul32(a, _GOLDEN) + _mix32(b)) & _MASK)
    bucket = (h % num_buckets).to(torch.int32) + 1
    return torch.where(valid_a & (b_ids > 0), bucket, torch.zeros_like(bucket))
