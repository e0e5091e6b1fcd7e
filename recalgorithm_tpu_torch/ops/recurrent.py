"""Recurrent cells for DIEN: GRU, AGRU and AUGRU over a padded sequence.

Counterpart of ``recalgorithm_tpu/ops/recurrent.py``, whose loop is a
``lax.scan`` (no Pallas kernel): here a Python loop over T of plain torch
ops.  Cell equations (reference custom_grucell.py):

  GRU   : r, u = sigmoid(x W_xg + h W_hg + b_g);  c = tanh(x W_xc + (r h) W_hc + b_c);
          h' = u h + (1 - u) c
  AGRU  : h' = (1 - a) h + a c
  AUGRU : u <- (1 - a) u;  h' = u h + (1 - u) c

with the gate bias initialised to 1.0 (the reference's bias_ones) and the
candidate bias to 0.  Length masking is ``tf.nn.dynamic_rnn(sequence_length)``'s:
steps at or past a row's length emit zeros and carry the state unchanged.
The input projections of all T steps are hoisted out of the loop into one
(B*T, in) matmul each; only the (B, H) x (H, *) recurrent products stay in
the loop.  Their rounding compounds over T, so they must run at full f32:
torch's default float32 matmul precision ("highest", TF32 off) does, and a
caller that lowers it (``torch.backends.cuda.matmul.allow_tf32``) lowers
it here too.
"""

from __future__ import annotations

import torch
from torch import nn

from recalgorithm_tpu_torch.ops.mlp import glorot_param

CELL_TYPES = ("GRU", "AGRU", "AUGRU")


class GRULoop(nn.Module):
    """A (A)(U)GRU of width ``num_units`` over (B, T, in_dim) inputs.  The
    parameters carry the flax names and layouts (``w_x_gates`` (in, 2H),
    ``w_h_gates`` (H, 2H), ``b_gates``, ``w_x_cand`` (in, H), ``w_h_cand``
    (H, H), ``b_cand``)."""

    def __init__(self, in_dim: int, num_units: int, cell_type: str = "GRU",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cell_type not in CELL_TYPES:
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.cell_type = cell_type
        h = num_units
        self.w_x_gates = glorot_param(in_dim, 2 * h, generator=generator)
        self.w_h_gates = glorot_param(h, 2 * h, generator=generator)
        self.b_gates = nn.Parameter(torch.ones(2 * h))
        self.w_x_cand = glorot_param(in_dim, h, generator=generator)
        self.w_h_cand = glorot_param(h, h, generator=generator)
        self.b_cand = nn.Parameter(torch.zeros(h))

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor,
                att_scores: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """inputs (B, T, in), lengths (B,), att_scores (B, T) for AGRU/AUGRU
        -> (outputs (B, T, H), final state (B, H))."""
        b, t, in_dim = inputs.shape
        h = self.w_h_cand.shape[0]
        if self.cell_type != "GRU" and att_scores is None:
            raise ValueError(f"{self.cell_type} requires att_scores")
        flat = inputs.reshape(b * t, in_dim)
        xg_all = (flat @ self.w_x_gates).reshape(b, t, 2 * h)
        xc_all = (flat @ self.w_x_cand).reshape(b, t, h)
        step_mask = (torch.arange(t, device=inputs.device)[None, :]
                     < lengths[:, None]).to(inputs.dtype)  # (B, T)
        state = inputs.new_zeros(b, h)
        outputs = []
        for s in range(t):
            gates = torch.sigmoid(xg_all[:, s] + state @ self.w_h_gates + self.b_gates)
            r, u = gates[:, :h], gates[:, h:]
            c = torch.tanh(xc_all[:, s] + (r * state) @ self.w_h_cand + self.b_cand)
            if self.cell_type == "GRU":
                new_h = u * state + (1.0 - u) * c
            else:
                a = att_scores[:, s, None].to(inputs.dtype)
                if self.cell_type == "AGRU":
                    new_h = (1.0 - a) * state + a * c
                else:  # AUGRU
                    u = (1.0 - a) * u
                    new_h = u * state + (1.0 - u) * c
            m = step_mask[:, s, None]
            state = m * new_h + (1.0 - m) * state  # carried through past the length
            outputs.append(m * new_h)              # zero output past the length
        return torch.stack(outputs, dim=1), state
