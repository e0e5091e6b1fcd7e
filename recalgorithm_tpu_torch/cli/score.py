"""Offline batch scoring with a deployed artifact, no model code.

    python -m recalgorithm_tpu_torch.cli.score --stablehlo <artifact> --data \\
        <split.tfrecord> --vocabulary_dir <dir> --out predictions.csv [--device cpu]

Counterpart of ``recalgorithm_tpu/cli/score.py``, the hermetic twin of the
reference's ``estimator.predict`` -> predictions.csv step
(wide_and_deep.py:370-375): scores a TFRecord split with an artifact of
serving/export.py (``--stablehlo`` keeps the JAX CLI's flag name; the file
is a ``torch.export`` program) and writes the trainer's CSV layout: the
userid/feedid string tokens through the inverse vocabulary, one
``<task>_probabilities`` column a task to 6 decimals, then the label
columns.  The padded tail of the last batch is dropped.  Runs on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stablehlo", required=True, help="artifact of serving/export.py")
    p.add_argument("--data", required=True, help="TFRecord split to score")
    p.add_argument("--vocabulary_dir", required=True)
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np

    from recalgorithm_tpu_torch.data import pipeline
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.features.vocab import VocabularyStore
    from recalgorithm_tpu_torch.serving.predictor import HLOPredictor

    pred = HLOPredictor(args.stablehlo, device=args.device)
    vocabs = VocabularyStore.from_dir(args.vocabulary_dir)
    schema = wechat_schema(vocabs.sizes())
    data = pipeline.load_dataset(args.data, schema, vocabs, limit=args.limit)
    probs = pred.predict(pipeline.batches(data, pred.batch_size, num_epochs=1, shuffle=False))

    ids = {}
    for k in ("userid", "feedid"):
        if k in data.categorical:
            toks = np.asarray([""] + vocabs[schema.vocab_of(k)].tokens(), dtype=object)
            ids[k] = toks[data.categorical[k]]
    n = len(next(iter(probs.values())))
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        header = sorted(ids) + [f"{t}_probabilities" for t in pred.tasks]
        header += list(schema.labels)
        w.writerow(header)
        for i in range(n):
            row = [str(ids[c][i]) for c in sorted(ids)]
            row += [f"{probs[t][i]:.6f}" for t in pred.tasks]
            row += [f"{v:g}" for v in data.labels[i]]
            w.writerow(row)
    print(f"wrote {args.out} ({n} rows, artifact {pred.manifest['model']} "
          f"b{pred.batch_size}, device {pred.device})")


if __name__ == "__main__":
    main()
