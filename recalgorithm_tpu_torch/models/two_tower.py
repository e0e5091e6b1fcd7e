"""TwoTower: a dual-encoder retrieval model with an in-batch sampled softmax.

Counterpart of ``recalgorithm_tpu/models/two_tower.py`` (beyond the
reference, whose zoo is ranking only: this is the candidate-generation stage
that feeds it; Covington et al. 2016, Yi et al. 2019).  On the WeChat
surface:

  * user tower: userid and device embeddings, the mean-pooled 7-day
    behaviour sequence (sharing the feedid table with the item tower) and
    the ``u_*`` dense features;
  * item tower: feedid, authorid, the bgm ids, the mean-pooled manual tags
    and the other dense features.

Both towers end in an L2-normalised ``output_dim`` vector
(``user_embedding``, ``item_embedding``); the logit is their cosine over the
temperature.  Losses, returned beside the logits when the batch has labels
(a serving batch has none and gets the logit only):

  * ``in_batch_softmax``: the softmax over the (B, B) score matrix with the
    positives on the diagonal, rows weighted by the click label, and
    same-feedid off-diagonal collisions set to -1e9 so a duplicate item is
    never its own false negative;
  * with ``logq_correction``, each candidate's score less log(p_item), p from
    an EMA of per-feedid counts kept in the buffer ``feedid_freq`` (the JAX
    model's ``batch_stats``), which a train-mode forward updates, as
    BatchNorm updates its statistics;
  * the trainer's per-task sigmoid CE on the logit, which
    ``task_loss_weights=(("read_comment", 0.0),)`` turns off.

Under a process mesh the softmax, the collision mask, the label sum and the
``feedid_freq`` counts span the global batch, as under the JAX package's: each
rank scores its users against every data shard's items, gathered with their
gradient.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.models import common
from recalgorithm_tpu_torch.ops.mlp import MLPTower
from recalgorithm_tpu_torch.parallel import multihost

SEQ = "his_read_comment_7d_seq"


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig(common.TrainFlags):
    embedding_dim: int = 16
    hidden_units: tuple[int, ...] = (128,)  # per-tower hidden stack
    output_dim: int = 64
    temperature: float = 0.07
    softmax_weight: float = 1.0  # weight of the in-batch softmax loss
    # subtract log(p_item) from each candidate logit (sampled-softmax
    # correction for popularity-biased in-batch negatives)
    logq_correction: bool = False
    freq_decay: float = 0.99  # EMA decay of the item-frequency estimator
    batch_norm: bool = False  # towers feed a normalised dot — keep them lean
    dropout_rate: float = 0.0
    # (task, weight) pairs for the trainer's sigmoid-CE sum; 1.0 keeps the
    # calibrated-logit hybrid, 0.0 = pure in-batch-softmax training
    task_loss_weights: tuple[tuple[str, float], ...] = (("read_comment", 1.0),)
    task_names: tuple[str, ...] = ("read_comment",)


def _dense_split(schema: Schema) -> tuple[list[int], list[int]]:
    """Indices of the user-side (u_*) and item-side (the rest) dense features."""
    user, item = [], []
    for i, f in enumerate(schema.dense):
        (user if f.name.startswith("u_") else item).append(i)
    return user, item


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-6)


class TwoTower(nn.Module):
    """Submodules carry the flax names: ``embed``, ``user_tower``,
    ``item_tower``; with ``logq_correction`` the buffer ``feedid_freq``."""

    def __init__(self, config: TwoTowerConfig, schema: Schema,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = config.compute_dtype  # None (f32) or bf16 towers
        self.config = config
        self.schema = schema
        k = config.embedding_dim
        vocabs = tuple(common.SCALAR_CAT_FIELDS) + ("manual_tag_id",)
        self.embed = EmbeddingCollection(
            {v: TableSpec(v, schema.vocab_sizes[v], k) for v in vocabs}, generator)
        self._user_dense, self._item_dense = _dense_split(schema)
        # the same indices on the model's device (not state: not saved), so
        # a step reads no index from the host (a CUDA graph cannot hold that)
        self.register_buffer("user_dense_index", torch.tensor(self._user_dense),
                             persistent=False)
        self.register_buffer("item_dense_index", torch.tensor(self._item_dense),
                             persistent=False)
        tower = dict(dropout_rate=config.dropout_rate, batch_norm=config.batch_norm,
                     logits_dim=config.output_dim, generator=generator, compute_dtype=dt)
        self.user_tower = MLPTower(3 * k + len(self._user_dense), config.hidden_units, **tower)
        self.item_tower = MLPTower(5 * k + len(self._item_dense), config.hidden_units, **tower)
        if config.logq_correction:  # a uniform prior
            self.register_buffer("feedid_freq", torch.ones(schema.vocab_sizes["feedid"]))
        self.mesh = None  # under a process mesh the softmax spans the global batch

    def user_embedding(self, batch) -> torch.Tensor:
        """(B, output_dim) L2-normalised user vector."""
        x = torch.cat([
            self.embed.embed_scalar("userid", batch["userid"]),
            self.embed.embed_scalar("device", batch["device"]),
            self.embed.embed_pooled("feedid", batch[SEQ], "mean"),
            batch["dense"][:, self.user_dense_index],
        ], dim=-1)
        return _l2_normalise(self.user_tower(x))

    def item_embedding(self, batch) -> torch.Tensor:
        """(B, output_dim) L2-normalised item vector."""
        x = torch.cat([
            self.embed.embed_scalar("feedid", batch["feedid"]),
            self.embed.embed_scalar("authorid", batch["authorid"]),
            self.embed.embed_scalar("bgm_song_id", batch["bgm_song_id"]),
            self.embed.embed_scalar("bgm_singer_id", batch["bgm_singer_id"]),
            self.embed.embed_pooled("manual_tag_id", batch["manual_tag_list"], "mean"),
            batch["dense"][:, self.item_dense_index],
        ], dim=-1)
        return _l2_normalise(self.item_tower(x))

    def forward(self, batch) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.config
        u = self.user_embedding(batch)
        v = self.item_embedding(batch)
        logit = (u * v).sum(dim=-1) / cfg.temperature  # (B,)
        losses = {}
        if cfg.softmax_weight > 0 and "labels" in batch:
            feed = batch["feedid"].reshape(-1)
            y = batch["labels"][:, self.schema.labels.index("read_comment")].to(u.dtype)
            mesh = self.mesh
            if mesh is not None and mesh.data_size > 1:
                # the candidates are the global batch's items, with their
                # gradient; this rank's loss share makes the trainer's mean
                # over data shards the global loss
                d, size, group = mesh.data_index, mesh.data_size, mesh.data_group
                v_all = multihost.gather_rows(v, group, size, d, replicated=False)
                feed_all = multihost.all_gather_rows(feed, group, size)
                y_sum = multihost.all_reduce_sum(y.sum(), group)
                share = float(size)
            else:
                d, v_all, feed_all, y_sum, share = 0, v, feed, y.sum(), 1.0
            scores = (u @ v_all.T) / cfg.temperature  # (B, B_global)
            if cfg.logq_correction:
                scores = scores - self._log_q(feed_all)[None, :]
            same = feed[:, None] == feed_all[None, :]
            own = torch.arange(len(feed), device=feed.device) + d * len(feed)
            # each row's own column, compared on the device (an indexed
            # write of True would copy the value from the host)
            eye = torch.arange(len(feed_all), device=feed.device)[None, :] == own[:, None]
            scores = torch.where(same & ~eye, torch.full_like(scores, -1e9), scores)
            logp = torch.log_softmax(scores, dim=-1)
            # only clicked (positive) pairs anchor a softmax row
            loss = -(logp[torch.arange(len(feed), device=feed.device), own] * y).sum() \
                * share / y_sum.clamp(min=1.0)
            losses["in_batch_softmax"] = cfg.softmax_weight * loss
        return {"read_comment": logit}, losses

    def _log_q(self, feed: torch.Tensor) -> torch.Tensor:
        """(B,) log sampling probability of each in-batch candidate.  A
        train-mode call first folds the batch's counts into ``feedid_freq``
        (freq = decay * freq + counts); ids outside the buffer add nothing and
        read its last entry, as the JAX scatter and gather treat them."""
        freq = self.feedid_freq
        idx = feed.long().clamp(0, freq.shape[0] - 1)
        if self.training:
            with torch.no_grad():
                valid = ((feed >= 0) & (feed < freq.shape[0])).to(freq.dtype)
                hist = torch.zeros_like(freq).index_add_(0, idx, valid)
                freq.copy_(self.config.freq_decay * freq + hist)
        p = freq[idx] / freq.sum()
        return torch.log(p.clamp(min=1e-12))


common.register_model("TwoTower", TwoTowerConfig, TwoTower)
