"""Behaviour-sequence attention: DIN target attention and the BST transformer.

Counterpart of ``recalgorithm_tpu/ops/attention.py``.  ``DINAttention`` owns
the f1/f2/f3 attention MLP and hands its weights to ``ops/cuda/din_attention``;
``BSTTransformerBlock`` owns the projections and hands q, k, v to
``ops/cuda/bst_attention``.  Both run the hand-written CUDA kernels on CUDA
tensors and the plain torch twins on CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from recalgorithm_tpu_torch.ops.activations import leakyrelu
from recalgorithm_tpu_torch.ops.cuda.bst_attention import bst_mha
from recalgorithm_tpu_torch.ops.cuda.din_attention import NEG_INF, din_attention
from recalgorithm_tpu_torch.ops.mlp import Dense, glorot_param

__all__ = ["NEG_INF", "sequence_mask", "DINAttention", "BSTTransformerBlock"]

LAYER_NORM_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, T) bool, True for positions < length (tf.sequence_mask)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


class DINAttention(nn.Module):
    """DIN target-vs-history attention pooling (reference din_attention.py:4-43).

    weights = MLP_64_32_1(concat(q, k, q-k, q*k)) per position; masked by
    sequence length; optionally scaled-softmax'd (flag parity with
    --use_softmax); output = weight-weighted sum over the sequence.
    """

    def __init__(self, embed_dim: int, use_softmax: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_softmax = use_softmax
        self.f1_att = Dense(4 * embed_dim, 64, generator)
        self.f2_att = Dense(64, 32, generator)
        self.f3_att = Dense(32, 1, generator)

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        return din_attention(
            query, keys, lengths,
            self.f1_att.weight, self.f1_att.bias,
            self.f2_att.weight, self.f2_att.bias,
            self.f3_att.weight, self.f3_att.bias,
            use_softmax=self.use_softmax,
        )


class BSTTransformerBlock(nn.Module):
    """One BST transformer block (reference transformer_layer.py:6-81).

    Learned position embedding (slot 0 is the target item) added to the Q
    and K inputs only, not V; per-head projections ``w_q/w_k/w_v`` (H, d, d)
    and the concat projection ``w_o`` (H*d, d), raw parameters under the
    flax names; scaled dot-product attention with the key-side mask
    (B, 1, 1, T); residual + ``ln1``; a single leakyrelu ``ffn``; residual +
    ``ln2``.  The attention core is :func:`bst_mha` (kernels on the card).
    """

    def __init__(self, dim: int, num_heads: int, max_length: int,
                 use_position_embedding: bool = True, save_attn_bf16: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.save_attn_bf16 = save_attn_bf16
        shapes = {"w_q": (num_heads, dim, dim), "w_k": (num_heads, dim, dim),
                  "w_v": (num_heads, dim, dim), "w_o": (num_heads * dim, dim)}
        if use_position_embedding:
            shapes = {"position_embedding": (max_length, dim), **shapes}
        for name, shape in shapes.items():
            self.register_parameter(name, glorot_param(*shape, generator=generator))
        self.use_position_embedding = use_position_embedding
        self.ln1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ffn = Dense(dim, dim, generator)
        self.ln2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor,        # (B, T, d) target + sequence
                lengths: torch.Tensor) -> torch.Tensor:  # (B,) incl. the target
        b, t, d = x.shape
        q_in = k_in = x
        if self.use_position_embedding:
            pos = self.position_embedding[:t][None, :, :]
            q_in = q_in + pos
            k_in = k_in + pos
        q = torch.einsum("btk,hkj->bhtj", q_in, self.w_q).contiguous()
        k = torch.einsum("btk,hkj->bhtj", k_in, self.w_k).contiguous()
        v = torch.einsum("btk,hkj->bhtj", x, self.w_v).contiguous()
        score = bst_mha(q, k, v, lengths, self.save_attn_bf16)  # (B, H, T, d)
        heads = score.transpose(1, 2).reshape(b, t, self.num_heads * d)
        net = self.ln1(heads @ self.w_o + x)
        return self.ln2(leakyrelu(self.ffn(net)) + net)
