"""Wide&Deep: hashed-cross wide part + MLP deep part with dual optimizers.

Counterpart of ``recalgorithm_tpu/models/wide_and_deep.py``.  Reference:
algorithm/WideAndDeep/wide_and_deep.py.

  * wide part (L121-124, 208-210): the indicator of crossed_column(userid x
    manual_tag, 100k buckets) -> Dense(1).  Here the on-device hashed cross
    of the integer ids (``embed/cross.py``) sums one weight a bucket, plus
    ``wide_bias``: the same linear map without (B, 100000) one-hots.  The
    weights sit in column 0 of a width-8 zero-init table in the collection
    ``wide_embed_w``, the JAX package's layout (it chose width 8 for the
    TPU's gather; columns 1-7 get zero gradients and stay zero), so weights
    carry across both ways;
  * deep part (L213-222): dense + the W&D-family embeddings -> MLPTower
    ``deep`` (relu -> dropout -> BN) -> Dense(1);
  * dual optimizer (L251-276): FTRL on the wide parameters, the configured
    optimizer on the deep ones (``wide_param_predicate`` +
    ``train.optimizers.dual_wide_deep``).

The reference's wide_and_deep_builtin.py is the canned
DNNLinearCombinedClassifier over the same features, so ``WideAndDeepBuiltin``
registers this class again.  In train mode the forward keeps the summaries
the JAX model sows (``wide_part_kernel`` and its L2 norm, tf.summary
parity, L288-291) in ``sown`` for the trainer to log.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.embed.cross import hashed_cross
from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.models.dcn import wd_embedder
from recalgorithm_tpu_torch.ops.mlp import MLPTower

WIDE_TABLE_DIM = 8  # the JAX package's width; column 0 carries the weights


@dataclasses.dataclass(frozen=True)
class WideAndDeepConfig(common.TrainFlags):
    wide_part_learning_rate: float = 0.005
    deep_part_learning_rate: float = 0.001
    deep_part_optimizer: str = "adam"
    hidden_units: tuple[int, ...] = (512, 256, 128)
    batch_norm: bool = True
    dropout_rate: float = 0.0
    cross_hash_buckets: int = 100_000
    task_names: tuple[str, ...] = ("read_comment",)


class WideAndDeep(nn.Module):
    """Submodules carry the flax names: ``wide_embed_w``, ``wide_bias``,
    ``embedder``, ``deep``."""

    def __init__(self, config: WideAndDeepConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        # the cross spec (fields, bucket count) is the schema's; the config's
        # cross_hash_buckets overrides the count
        self.cross = schema.cross[0]
        self.num_buckets = config.cross_hash_buckets or self.cross.num_buckets
        self.wide_embed_w = EmbeddingCollection({self.cross.name: TableSpec(
            self.cross.name, self.num_buckets, WIDE_TABLE_DIM, init="zeros")})
        self.wide_bias = nn.Parameter(torch.zeros(1))
        self.embedder, width = wd_embedder(schema, generator)
        self.deep = MLPTower(width, config.hidden_units, config.dropout_rate,
                             config.batch_norm, logits_dim=1, generator=generator,
                             compute_dtype=dt)
        self.sown: dict[str, torch.Tensor] = {}

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        name = self.cross.name
        cross_ids = hashed_cross(batch[self.cross.keys[0]], batch[self.cross.keys[1]],
                                 self.num_buckets)  # (B, T_tag)
        wide_logit = (self.wide_embed_w.embed_pooled(name, cross_ids, "sum")[:, 0]
                      + self.wide_bias[0])
        if self.training:
            kernel = self.wide_embed_w.tables[name][:, 0].detach().clone()
            mesh = self.wide_embed_w.mesh
            if mesh is not None:  # the whole row-sharded kernel, as JAX gathers it
                kernel = multihost.all_gather_rows(kernel, None, mesh.world)
            self.sown = {"wide_part_kernel": kernel,
                         "wide_part_kernel_l2_norm": kernel.square().sum().sqrt()}
        deep_in = torch.cat([batch["dense"], *self.embedder(batch)], dim=-1)
        deep_logit = self.deep(deep_in)[:, 0]
        return {"read_comment": wide_logit + deep_logit}, {}

    @staticmethod
    def wide_param_predicate(name: str) -> bool:
        """Selects the wide part's parameters (by dotted name) for FTRL."""
        return any(k.startswith("wide") for k in name.split("."))


common.register_model("WideAndDeep", WideAndDeepConfig, WideAndDeep)
common.register_model("WideAndDeepBuiltin", WideAndDeepConfig, WideAndDeep)
