"""Feature-interaction ops of the FM / cross / attention families.

Counterpart of ``recalgorithm_tpu/ops/interactions.py``: the compute cores of
DeepFM/NFM (sum-square FM pooling), FwFM (pairwise dots), AFM (attention over
pair products), PNN (inner/outer product layers), DCN v1/v2 (cross
networks), xDeepFM (CIN), FiBiNET (SENET + bilinear), MaskNet (MaskBlock),
FinalMLP (BilinearFusion) and AutoInt (InteractingLayer, on the BST
attention kernels).

Everything runs on a stacked field tensor ``(B, F, K)``.  Pairs are always
enumerated in the row-major upper-triangle order (i, j), i < j, of
:func:`pair_indices`.  Each module takes the shapes of its inputs at
construction (torch allocates parameters eagerly, where flax infers them at
the first call) and keeps the flax parameter names and layouts, so
``convert.from_flax`` carries a JAX checkpoint across unchanged.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from recalgorithm_tpu_torch.ops.attention import LAYER_NORM_EPS
from recalgorithm_tpu_torch.ops.cuda import bst_attention
from recalgorithm_tpu_torch.ops.mlp import Dense, glorot_param

# ---------------------------------------------------------------------------
# FM-style pooling
# ---------------------------------------------------------------------------


def fm_pool(field_emb: torch.Tensor) -> torch.Tensor:
    """Bi-interaction / FM second-order pooling, (B, F, K) -> (B, K):
    0.5 * ((sum_f v_f)^2 - sum_f v_f^2)   (reference deepfm.py:192-200)."""
    return 0.5 * (field_emb.sum(dim=1).square() - field_emb.square().sum(dim=1))


@functools.lru_cache(maxsize=None)
def pair_indices(num_fields: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(i, j) of every pair i < j, row-major (``np.triu_indices(F, k=1)``)."""
    i, j = torch.triu_indices(num_fields, num_fields, offset=1).tolist()
    return tuple(i), tuple(j)


def pair_index(num_fields: int, device: torch.device) -> torch.Tensor:
    """:func:`pair_indices` as a (2, P) index tensor made on ``device``: an
    index read from the host would be a copy, which a CUDA graph of the
    train step cannot hold."""
    return torch.triu_indices(num_fields, num_fields, offset=1, device=device)


def pairwise_hadamard(field_emb: torch.Tensor) -> torch.Tensor:
    """(B, F, K) -> (B, P, K): every pair's elementwise product."""
    i, j = pair_index(field_emb.shape[1], field_emb.device)
    return field_emb[:, i, :] * field_emb[:, j, :]


def pairwise_dot(field_emb: torch.Tensor) -> torch.Tensor:
    """(B, F, K) -> (B, P): every pair's inner product, read off the Gram
    matrix."""
    gram = torch.einsum("bfk,bgk->bfg", field_emb, field_emb)
    i, j = pair_index(field_emb.shape[1], field_emb.device)
    return gram[:, i, j]


class AFMAttention(nn.Module):
    """AFM attention over pair products (reference afm.py:167-188):
    score = softmax_pairs(relu(attention_w(p)) @ attention_h); returns the
    score-weighted sum of the pair products, (B, P, K) -> (B, K)."""

    def __init__(self, embed_dim: int, attention_factor: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.attention_w = Dense(embed_dim, attention_factor, generator)
        self.attention_h = glorot_param(attention_factor, 1, generator=generator)

    def forward(self, pair_products: torch.Tensor) -> torch.Tensor:
        a = torch.relu(self.attention_w(pair_products))
        score = torch.softmax(a @ self.attention_h, dim=1)  # (B, P, 1)
        return (pair_products * score).sum(dim=1)


# ---------------------------------------------------------------------------
# PNN product layers (reference pnn.py:146-173)
# ---------------------------------------------------------------------------


def l2_penalty(weight_regularizer: float, w: torch.Tensor) -> torch.Tensor:
    """tf.contrib.layers.l2_regularizer(scale)(w) = scale * sum(w^2) / 2."""
    return 0.5 * weight_regularizer * w.square().sum()


class InnerProductLayer(nn.Module):
    """IPNN: lp_d = || sum_f theta[d, f] v_f ||^2 for each of D output units,
    (B, F, K) -> (B, D).  With ``weight_regularizer > 0``,
    :meth:`losses` gives the ``weight_l2`` term the JAX layer sows."""

    def __init__(self, num_fields: int, output_dim: int,
                 weight_regularizer: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight_regularizer = weight_regularizer
        self.inner_product_w = glorot_param(output_dim, num_fields, generator=generator)

    def losses(self) -> dict[str, torch.Tensor]:
        if self.weight_regularizer <= 0:
            return {}
        return {"weight_l2": l2_penalty(self.weight_regularizer, self.inner_product_w)}

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        delta = torch.einsum("df,bfk->bdk", self.inner_product_w, field_emb)
        return delta.square().sum(dim=-1)


class OuterProductLayer(nn.Module):
    """OPNN: lp_d = s^T W_d_sym s with s = sum_f v_f and W_d symmetrised from
    its upper triangle, (B, F, K) -> (B, D); :meth:`losses` as IPNN's."""

    def __init__(self, embed_dim: int, output_dim: int,
                 weight_regularizer: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight_regularizer = weight_regularizer
        self.outer_product_w = glorot_param(output_dim, embed_dim, embed_dim,
                                            generator=generator)

    def losses(self) -> dict[str, torch.Tensor]:
        if self.weight_regularizer <= 0:
            return {}
        return {"weight_l2": l2_penalty(self.weight_regularizer, self.outer_product_w)}

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        w = self.outer_product_w
        upper = torch.triu(w)
        w_sym = upper + upper.transpose(-1, -2) - torch.triu(torch.tril(w))
        s = field_emb.sum(dim=1)  # (B, K)
        return torch.einsum("bj,djk,bk->bd", s, w_sym, s)


# ---------------------------------------------------------------------------
# DCN cross networks
# ---------------------------------------------------------------------------


class CrossNetwork(nn.Module):
    """DCN-v1 stack (reference cross_layer.py:4-26):
    x_{l+1} = x0 * (x_l^T w_l) + b_l + x_l, with ``w_<l>`` and ``b_<l>`` (d, 1)."""

    def __init__(self, dim: int, num_layers: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.register_parameter(f"w_{layer}", glorot_param(dim, 1, generator=generator))
            self.register_parameter(f"b_{layer}", glorot_param(dim, 1, generator=generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:  # (B, d)
        xl = x0
        for layer in range(self.num_layers):
            w, b = getattr(self, f"w_{layer}"), getattr(self, f"b_{layer}")
            xl = x0 * (xl @ w) + b[:, 0] + xl
        return xl


class CrossNetworkV2(nn.Module):
    """DCN-v2 cross stack: x_{l+1} = x0 * (W_l x_l + b_l) + x_l, with
    ``low_rank r > 0`` factorising W_l = U_l V_l^T, and ``gated`` GDCN's
    x0 * (W_l x_l + b_l) * sigmoid(G_l x_l) + x_l."""

    def __init__(self, dim: int, num_layers: int, low_rank: int = 0,
                 gated: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers, self.low_rank, self.gated = num_layers, low_rank, gated
        for layer in range(num_layers):
            if low_rank > 0:
                self.register_parameter(
                    f"u_{layer}", glorot_param(dim, low_rank, generator=generator))
                self.register_parameter(
                    f"v_{layer}", glorot_param(dim, low_rank, generator=generator))
            else:
                self.register_parameter(f"w_{layer}", glorot_param(dim, dim, generator=generator))
            self.register_parameter(f"b_{layer}", nn.Parameter(torch.zeros(dim)))
            if gated:
                self.register_parameter(f"g_{layer}", glorot_param(dim, dim, generator=generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:  # (B, d)
        xl = x0
        for layer in range(self.num_layers):
            if self.low_rank > 0:
                w_xl = (xl @ getattr(self, f"v_{layer}")) @ getattr(self, f"u_{layer}").T
            else:
                w_xl = xl @ getattr(self, f"w_{layer}")
            cross = x0 * (w_xl + getattr(self, f"b_{layer}"))
            if self.gated:
                cross = cross * torch.sigmoid(xl @ getattr(self, f"g_{layer}"))
            xl = cross + xl
        return xl


# ---------------------------------------------------------------------------
# xDeepFM CIN (reference cin_layer.py:4-30)
# ---------------------------------------------------------------------------


class CINLayer(nn.Module):
    """One Compressed Interaction Network layer, x0 (B, m, K) and xk
    (B, h_k, K) -> (B, h_next, K): outer[b, k, i, j] = xk[b, i, k] x0[b, j, k]
    flattened to index i*m + j and compressed by the (h_k*m, h_next)
    ``filter``."""

    def __init__(self, num_fields: int, prev_maps: int, num_feature_maps: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.filter = glorot_param(prev_maps * num_fields, num_feature_maps,
                                   generator=generator)

    def forward(self, x0: torch.Tensor, xk: torch.Tensor) -> torch.Tensor:
        b, m, k = x0.shape
        outer = torch.einsum("bik,bjk->bkij", xk, x0).reshape(b, k, xk.shape[1] * m)
        return torch.einsum("bkf,fh->bhk", outer, self.filter)


# ---------------------------------------------------------------------------
# FiBiNET: SENET + bilinear interaction (reference senet.py, bilinear_*.py)
# ---------------------------------------------------------------------------


class SENet(nn.Module):
    """Squeeze-and-excitation field reweighting (reference senet.py:4-36).
    As the reference: the bottleneck is K // reduction_ratio (the embedding
    dim, not the field count) and the excitation is relu, not sigmoid."""

    def __init__(self, num_fields: int, embed_dim: int, reduction_ratio: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        reduction_dim = max(1, embed_dim // reduction_ratio)
        self.w1 = glorot_param(num_fields, reduction_dim, generator=generator)
        self.w2 = glorot_param(reduction_dim, num_fields, generator=generator)

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:  # (B, F, K)
        z = field_emb.mean(dim=-1)
        a = torch.relu(torch.relu(z @ self.w1) @ self.w2)
        return field_emb * a[..., None]


class BilinearInteraction(nn.Module):
    """FiBiNET bilinear pair interaction p_ij = (v_i W) * v_j, (B, F, K) ->
    (B, P, K).  ``interaction_type``: 'all' (one shared ``w_all`` (K, K)),
    'each' (``w_each`` (F', K, K), indexed by the left field i), or
    'interaction' (``w_interaction`` (P, K, K), one a pair).

    ``drop_last_field=True`` (the default) reproduces the reference's
    ``combinations(range(F-1), 2)``, which leaves the last field out of every
    pair: F' = F - 1 fields, 21 pairs at F = 8."""

    def __init__(self, num_fields: int, embed_dim: int, interaction_type: str = "all",
                 drop_last_field: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        f_eff = num_fields - 1 if drop_last_field else num_fields
        self.num_pair_fields = f_eff
        self.pairs = pair_indices(f_eff)
        self.interaction_type = interaction_type
        k = embed_dim
        if interaction_type == "all":
            self.w_all = glorot_param(k, k, generator=generator)
        elif interaction_type == "each":
            self.w_each = glorot_param(f_eff, k, k, generator=generator)
        elif interaction_type == "interaction":
            self.w_interaction = glorot_param(len(self.pairs[0]), k, k, generator=generator)
        else:
            raise ValueError(f"interaction_type must be all/each/interaction, "
                             f"got {interaction_type!r}")

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        i, j = pair_index(self.num_pair_fields, field_emb.device)
        if self.interaction_type == "all":
            return (field_emb @ self.w_all)[:, i, :] * field_emb[:, j, :]
        w = self.w_each[i] if self.interaction_type == "each" else self.w_interaction
        return torch.einsum("bpk,pkl->bpl", field_emb[:, i, :], w) * field_emb[:, j, :]


# ---------------------------------------------------------------------------
# MaskNet and FinalMLP blocks (beyond the reference)
# ---------------------------------------------------------------------------


class MaskBlock(nn.Module):
    """MaskNet's instance-guided mask block (arXiv:2102.07619 §3.2-3.3):
    mask = mask_proj(relu(mask_agg(mask_input))); out = relu(ln(hidden(mask
    * hidden_in))), ``hidden`` bias-free and ``ln`` flax's LayerNorm (eps
    1e-6)."""

    def __init__(self, hidden_dim: int, mask_input_dim: int, output_size: int,
                 agg_size: int, generator: torch.Generator | None = None):
        super().__init__()
        self.mask_agg = Dense(mask_input_dim, agg_size, generator)
        self.mask_proj = Dense(agg_size, hidden_dim, generator)
        self.hidden = Dense(hidden_dim, output_size, generator, bias=False)
        self.ln = nn.LayerNorm(output_size, eps=LAYER_NORM_EPS)

    def forward(self, hidden: torch.Tensor, mask_input: torch.Tensor) -> torch.Tensor:
        mask = self.mask_proj(torch.relu(self.mask_agg(mask_input)))
        return torch.relu(self.ln(self.hidden(mask * hidden)))


class BilinearFusion(nn.Module):
    """FinalMLP's multi-head bilinear fusion (arXiv:2304.00902 §3.3), (B, D1)
    and (B, D2) -> (B,): bias + o1.w1 + o2.w2 + sum_k o1_k^T w3_k o2_k, with
    ``w3`` (k, D1/k, D2/k) starting at zero."""

    def __init__(self, dim1: int, dim2: int, num_heads: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = num_heads
        if dim1 % k or dim2 % k:
            raise ValueError(f"stream dims {dim1}/{dim2} not divisible by num_heads={k}")
        self.num_heads = k
        self.bias = nn.Parameter(torch.zeros(1))
        self.w1 = glorot_param(dim1, 1, generator=generator)
        self.w2 = glorot_param(dim2, 1, generator=generator)
        self.w3 = nn.Parameter(torch.zeros(k, dim1 // k, dim2 // k))

    def forward(self, o1: torch.Tensor, o2: torch.Tensor) -> torch.Tensor:
        b, k = o1.shape[0], self.num_heads
        bilinear = torch.einsum("bkd,kde,bke->b", o1.reshape(b, k, -1), self.w3,
                                o2.reshape(b, k, -1))
        return self.bias[0] + (o1 @ self.w1)[:, 0] + (o2 @ self.w2)[:, 0] + bilinear


# ---------------------------------------------------------------------------
# AutoInt field attention
# ---------------------------------------------------------------------------


class InteractingLayer(nn.Module):
    """AutoInt multi-head self-attention over fields (arXiv:1810.11921 §3.4),
    (B, F, k_in) -> (B, F, H*d): per head, score(f, g) = <W_q e_f, W_k e_g>
    (the unscaled inner product), softmax over g, heads concatenated, plus
    the residual projection ``w_res`` and a relu.  ``w_query``, ``w_key``,
    ``w_value`` and ``w_res`` are raw (k_in, H*d) parameters.

    The attention core is :func:`bst_attention.bst_mha` with every field a
    valid key: the BST kernels on CUDA tensors, their plain twin on the CPU,
    one code path for both.  q is multiplied by sqrt(d) first, which cancels
    the kernels' 1/sqrt(d) exactly (4.0 at d = 16, a power of two), so the
    scores are AutoInt's unscaled ones.  The kernels take d = 16 only; any
    other ``head_dim`` raises on the card.  The JAX layer's ``fused``,
    ``interpret``, ``kernel_in`` and ``kernel_out`` have no counterpart: one
    (B, H, F, d) layout serves both devices.  ``bst_mha`` is called through
    its module, so a caller can wrap it to capture q, k and v.
    """

    def __init__(self, in_features: int, num_heads: int, head_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        for name in ("w_query", "w_key", "w_value", "w_res"):
            self.register_parameter(
                name, glorot_param(in_features, num_heads * head_dim, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, _ = x.shape
        h, d = self.num_heads, self.head_dim

        def heads(w: torch.Tensor) -> torch.Tensor:  # (B, F, H*d) -> (B, H, F, d)
            return (x @ w).reshape(b, f, h, d).transpose(1, 2).contiguous()

        q = heads(self.w_query) * d**0.5  # cancels the kernels' 1/sqrt(d)
        lengths = torch.full((b,), f, dtype=torch.int32, device=x.device)
        out = bst_attention.bst_mha(q, heads(self.w_key), heads(self.w_value), lengths)
        return torch.relu(out.transpose(1, 2).reshape(b, f, h * d) + x @ self.w_res)
