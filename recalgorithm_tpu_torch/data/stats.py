"""Dataset statistics reporter: the reference EDA notebook's numbers as code.

Counterpart of ``recalgorithm_tpu/data/stats.py``, on the port's
``data/pipeline.py`` (numpy only):

  python -m recalgorithm_tpu_torch.data.stats --tfrecord <file> --vocabulary_dir <dir>

prints example counts, per-label positive rates, dense means, sequence-length
statistics, OOV shares and vocabulary sizes (reference
dataset/wechat_algo_data1/EDA.ipynb's headline outputs) as JSON.
``--plots_dir <dir>`` also renders the notebook's charts as PNGs; it imports
matplotlib there and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from recalgorithm_tpu_torch.data import pipeline
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore


def compute_stats(data, schema) -> dict:
    """The statistics of a loaded split (``pipeline.load_dataset``'s
    ``DatasetArrays``), keyed as the JAX reporter keys them."""
    stats: dict = {"num_examples": data.num_examples}
    stats["label_positive_rate"] = {
        name: round(float(data.labels[:, i].mean()), 6) for i, name in enumerate(schema.labels)}
    stats["dense_mean"] = {
        name: round(float(data.dense[:, i].mean()), 4) for i, name in enumerate(schema.dense_names)}
    for name, (_, lens) in data.sequences.items():
        stats[f"{name}_length"] = {
            "mean": round(float(lens.mean()), 3),
            "p50": int(np.percentile(lens, 50)),
            "p99": int(np.percentile(lens, 99)),
            "max": int(lens.max()) if len(lens) else 0,
            "empty_frac": round(float((lens == 0).mean()), 4),
        }
    for name, arr in data.categorical.items():
        stats[f"{name}_oov_frac"] = round(float((arr == 0).mean()), 6)
    return stats


def render_plots(data, schema, out_dir: str) -> list[str]:
    """The EDA notebook's charts (behaviour rates, sequence lengths, dense
    distributions, activity skew) as PNGs; returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    def save(fig, name):
        path = os.path.join(out_dir, name)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)

    rates = [float(data.labels[:, i].mean()) for i in range(len(schema.labels))]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.bar(schema.labels, rates, color="#4878d0")
    ax.set_ylabel("positive rate")
    ax.set_title("behaviour rates")
    ax.tick_params(axis="x", rotation=30)
    save(fig, "behaviour_rates.png")

    for name, (_, lens) in data.sequences.items():
        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.hist(lens, bins=np.arange(0, lens.max() + 2) - 0.5, color="#4878d0")
        ax.set_xlabel("length")
        ax.set_ylabel("examples")
        ax.set_title(f"{name} length distribution")
        save(fig, f"{name}_lengths.png")

    n = len(schema.dense_names)
    cols = 4
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.4 * rows))
    for i, name in enumerate(schema.dense_names):
        ax = axes.flat[i]
        ax.hist(data.dense[:, i], bins=40, color="#4878d0")
        ax.set_title(name, fontsize=8)
        ax.tick_params(labelsize=7)
    for j in range(n, rows * cols):
        axes.flat[j].axis("off")
    save(fig, "dense_distributions.png")

    for col in ("userid", "feedid"):  # impressions per user / feed, rank-frequency
        if col not in data.categorical:
            continue
        counts = np.bincount(data.categorical[col])
        counts = np.sort(counts[counts > 0])[::-1]
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.loglog(np.arange(1, len(counts) + 1), counts, color="#4878d0")
        ax.set_xlabel(f"{col} rank")
        ax.set_ylabel("impressions")
        ax.set_title(f"{col} activity skew")
        save(fig, f"{col}_skew.png")
    return written


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--tfrecord", required=True)
    p.add_argument("--vocabulary_dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--plots_dir", default=None,
                   help="also render the EDA notebook's charts as PNGs here")
    args = p.parse_args(argv)
    vocabs = VocabularyStore.from_dir(args.vocabulary_dir)
    schema = wechat_schema(vocabs.sizes())
    data = pipeline.load_dataset(args.tfrecord, schema, vocabs, limit=args.limit)
    stats = compute_stats(data, schema)
    stats["vocab_sizes"] = vocabs.sizes()
    if args.plots_dir:
        stats["plots"] = render_plots(data, schema, args.plots_dir)
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
