"""Brute-force retrieval for two-tower models.

Counterpart of ``recalgorithm_tpu/serving/retrieval.py`` (beyond the
reference, which serves rankers only).  Scoring a (B, D) block of user
vectors against an (N, D) corpus is one matmul, and ``torch.topk`` over the
score rows is one device reduction: exact exhaustive retrieval, with no
index to build or tune.

Usage:
    retr = Retriever(model, device="cuda")   # model holds its weights
    retr.build_corpus(item_batches)          # dedup by feedid, embed, stack
    ids, scores = retr.retrieve(user_batch, k=100)

``quantize_corpus=True`` keeps the corpus as per-row int8 with f32 scales
(4x less memory), picks candidates by an int8 x int8 coarse score and
rescores ``k * overfetch`` of them exactly (:func:`quantized_top_k`).
``Retriever(..., mesh=...)`` scores with :func:`sharded_top_k` instead: the
corpus rows sharded over every rank of a process mesh, one all-gather of the
candidates.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.serving.quantize import quantize_table
from recalgorithm_tpu_torch.utils.device import resolve_device, to_device

# the largest width whose int8 x int8 row products are exact in an f32
# matmul: |sum| <= 127^2 * D must stay below 2^24
EXACT_INT8_DIM = 1024


def brute_force_top_k(user_vecs: torch.Tensor, corpus: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus: (B, D) x (N, D) -> (B, k) scores and row
    indices, scores descending.  The scores are raw dot products: the towers
    emit L2-normalised vectors, so this is the cosine, monotone in the
    serving temperature."""
    return torch.topk(user_vecs @ corpus.T, k, dim=-1)


def sharded_top_k(user_vecs: torch.Tensor, corpus: torch.Tensor, k: int, mesh
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the corpus rows sharded over every rank of ``mesh``
    (the tables' layout): each rank scores the (B, D) users, the same on
    every rank, against its ``[r n, (r+1) n)`` rows of the corpus padded to
    a multiple of the rank count (padding rows score -inf), takes a local
    top-k capped at its shard's size, and one all-gather of the (B, N k)
    candidates feeds the merge.  Exact, because every global winner is a
    winner on its own shard.  Returns (B, k) scores and global row indices,
    the same on every rank (collective)."""
    n = corpus.shape[0]
    k = min(k, n)  # no more rows than the corpus holds
    n_loc = -(-n // mesh.world)
    k_loc = min(k, n_loc)
    base = mesh.rank * n_loc
    rows = corpus[base:base + n_loc]
    scores = user_vecs @ rows.T  # (B, rows on this shard)
    if rows.shape[0] < n_loc:  # the padding rows can never win
        scores = torch.cat([scores, scores.new_full(
            (scores.shape[0], n_loc - rows.shape[0]), float("-inf"))], dim=1)
    s, i = torch.topk(scores, k_loc, dim=-1)
    cand_s = multihost.all_gather_rows(s.T, None, mesh.world).T  # (B, N k_loc)
    cand_i = multihost.all_gather_rows((base + i).T, None, mesh.world).T
    out_s, pos = torch.topk(cand_s, k, dim=-1)
    return out_s, torch.gather(cand_i, 1, pos)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (the torch twin of ``quantize_table``)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def quantized_top_k(user_vecs: torch.Tensor, corpus_q: torch.Tensor,
                    corpus_scale: torch.Tensor, k: int, overfetch: int = 4
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 corpus (``corpus_q`` (N, D) int8, ``corpus_scale``
    (N, 1) f32): the user rows quantized alike, an int8 x int8 coarse score
    times each corpus row's scale picks ``k * overfetch`` candidates, which
    are rescored as the f32 user times the dequantized rows.  The user-side
    scale is a positive per-row factor, so it cannot change a user's ranking
    and is left out.

    The int8 products are computed exactly as an f32 matmul of the int8
    values: every product and partial sum is an integer below 2^24 for
    D <= EXACT_INT8_DIM, so any summation order gives the JAX package's
    int32 result (``torch._int_mm`` would do the same within its shape
    rules, which a serving batch of 1-16 rows breaks)."""
    n, d = corpus_q.shape
    if d > EXACT_INT8_DIM:
        raise ValueError(f"quantized_top_k: D = {d} > {EXACT_INT8_DIM}, where the f32 "
                         "matmul of int8 values stops being exact")
    k = min(k, n)
    m = min(k * overfetch, n)
    uq, _ = _quantize_rows(user_vecs)
    coarse = (uq.to(torch.float32) @ corpus_q.to(torch.float32).T) * corpus_scale[:, 0][None, :]
    cand = torch.topk(coarse, m, dim=-1).indices  # (B, m) corpus rows
    cvecs = corpus_q[cand].to(torch.float32) * corpus_scale[cand]  # (B, m, D)
    rescore = torch.einsum("bd,bmd->bm", user_vecs, cvecs)
    scores, pos = torch.topk(rescore, k, dim=-1)
    return scores, torch.gather(cand, 1, pos)


class Retriever:
    """Embeds a corpus with the item tower and serves exact top-k to users.

    ``model`` exposes ``user_embedding`` / ``item_embedding`` (TwoTower) and
    holds its weights; it is moved to ``device`` (``cuda`` unless the caller
    asks for the CPU; raises without a card) and put in eval mode.  With a
    process ``mesh`` scoring is :func:`sharded_top_k` (every rank of the mesh
    retrieves the same users at once); it excludes ``quantize_corpus``."""

    def __init__(self, model: nn.Module, device: str | torch.device | None = None,
                 serve_k: int = 100, quantize_corpus: bool = False, overfetch: int = 4,
                 mesh=None):
        if quantize_corpus and mesh is not None:
            raise ValueError("quantize_corpus and mesh are mutually exclusive")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.serve_k = serve_k
        self.quantize_corpus = quantize_corpus
        self.overfetch = overfetch
        self.corpus: torch.Tensor | None = None        # (N, D) f32
        self.corpus_q: torch.Tensor | None = None      # (N, D) int8 when quantized
        self.corpus_scale: torch.Tensor | None = None  # (N, 1) f32 when quantized
        self.corpus_ids: np.ndarray | None = None      # (N,) feedids
        self._inputs = frozenset(model.schema.batch_spec(1))

    def _embed(self, method, batch: Mapping) -> torch.Tensor:
        tb = to_device(batch, self.device, self._inputs)
        with torch.no_grad():
            return method(tb)

    def build_corpus(self, item_batches: Iterable[Mapping]) -> int:
        """Embed item batches (standard batches; only the item columns are
        read), dedup by feedid (first occurrence wins) and keep the result.
        Id 0 (PAD/OOV: padded eval tails, stale vocabularies) never enters
        the corpus.  Returns the corpus size N."""
        seen: set[int] = set()
        ids_out: list[np.ndarray] = []
        vec_out: list[np.ndarray] = []
        for batch in item_batches:
            feed = np.asarray(batch["feedid"]).reshape(-1)
            vecs = self._embed(self.model.item_embedding, batch).cpu().numpy()
            _, first = np.unique(feed, return_index=True)
            fresh = np.zeros(feed.shape[0], dtype=bool)
            fresh[first] = True
            fresh &= feed > 0
            fresh &= np.array([f not in seen for f in feed])
            if fresh.any():
                seen.update(feed[fresh].tolist())
                ids_out.append(feed[fresh])
                vec_out.append(vecs[fresh])
        if not ids_out:
            raise ValueError("build_corpus: no items")
        self.corpus_ids = np.concatenate(ids_out)
        vecs = np.concatenate(vec_out)
        if self.quantize_corpus:
            q, scale = quantize_table(vecs)
            self.corpus_q = torch.from_numpy(q).to(self.device)
            self.corpus_scale = torch.from_numpy(scale).to(self.device)
            self.corpus = None  # the f32 corpus is never kept
            return len(q)
        self.corpus = torch.from_numpy(vecs).to(self.device)
        return len(vecs)

    @staticmethod
    def _snapshot_path(path: str) -> str:
        # np.savez appends .npz to a path without it; both sides normalise
        return path if path.endswith(".npz") else path + ".npz"

    def save_corpus(self, path: str) -> str:
        """Write the built index as one .npz (ids and the vectors: int8 and
        scales when quantized, f32 otherwise), the JAX package's layout, for
        serving replicas to load without re-embedding.  Returns the path
        written (.npz appended when missing)."""
        if self.corpus is None and self.corpus_q is None:
            raise ValueError("call build_corpus first")
        arrays = {"corpus_ids": self.corpus_ids}
        if self.quantize_corpus:
            arrays["corpus_q"] = self.corpus_q.cpu().numpy()
            arrays["corpus_scale"] = self.corpus_scale.cpu().numpy()
        else:
            arrays["corpus"] = self.corpus.cpu().numpy()
        path = self._snapshot_path(path)
        np.savez(path, **arrays)
        return path

    def load_corpus(self, path: str) -> int:
        """Load a :meth:`save_corpus` snapshot, whose kind (int8 or f32) must
        be this Retriever's; returns N."""
        with np.load(self._snapshot_path(path)) as z:
            if self.quantize_corpus:
                if "corpus_q" not in z:
                    raise ValueError("snapshot is f32 but quantize_corpus=True")
                self.corpus_q = torch.from_numpy(z["corpus_q"]).to(self.device)
                self.corpus_scale = torch.from_numpy(z["corpus_scale"]).to(self.device)
                n = len(self.corpus_q)
            else:
                if "corpus" not in z:
                    raise ValueError("snapshot is int8 but quantize_corpus=False")
                self.corpus = torch.from_numpy(z["corpus"]).to(self.device)
                n = len(self.corpus)
            self.corpus_ids = z["corpus_ids"]
        return n

    def retrieve(self, user_batch: Mapping, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """Top-k feedids and cosine scores of each user row: (B, k), (B, k)."""
        if self.corpus is None and self.corpus_q is None:
            raise ValueError("call build_corpus first")
        u = self._embed(self.model.user_embedding, user_batch)
        if self.quantize_corpus:
            scores, idx = quantized_top_k(u, self.corpus_q, self.corpus_scale, k,
                                          self.overfetch)
        elif self.mesh is not None:
            scores, idx = sharded_top_k(u, self.corpus, k, self.mesh)
        else:
            scores, idx = brute_force_top_k(u, self.corpus, k)
        return self.corpus_ids[idx.cpu().numpy()], scores.cpu().numpy()

    def predict_batch(self, batch: Mapping) -> dict[str, np.ndarray]:
        """The batch interface of ``serving.server.BatchingPredictor``:
        {'feedids': (B, serve_k), 'scores': (B, serve_k)}, so single-user
        retrieval requests co-batch through the same dynamic batcher as
        ranking traffic (the batcher slices its padding rows away)."""
        ids, scores = self.retrieve(batch, self.serve_k)
        return {"feedids": ids, "scores": scores}

    def recall_at_k(self, batches: Iterable[Mapping], k: int, label_index: int = 0) -> float:
        """Offline Recall@K: over the positive rows (labels[:, label_index] >
        0, real rows, a known feedid), the share whose own feedid is in the
        user's top k.  A random tower's is about k/N."""
        hits, total = 0, 0
        for batch in batches:
            y = np.asarray(batch["labels"])[:, label_index] > 0
            w = batch.get("_weights")
            if w is not None:
                y &= np.asarray(w) > 0
            feed = np.asarray(batch["feedid"]).reshape(-1)
            y &= feed > 0
            if not y.any():
                continue
            ids, _ = self.retrieve(batch, k)
            hits += int(np.sum((ids[y] == feed[y, None]).any(axis=1)))
            total += int(y.sum())
        return hits / max(total, 1)
