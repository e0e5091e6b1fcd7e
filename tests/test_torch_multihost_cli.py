"""2-process ``cli.main`` of the port on the CPU (gloo), whole-load and
``--stream``: the cases of tests/test_multihost_cli.py.  Two ranks train
DeepCrossing on reference-format TFRecords on disk, each on its shard, and
evaluate the eval split split between them (53 rows: uneven shards and
padded tails); process 0's predictions.csv must hold exactly the eval rows,
once each, in file order, and both processes report the same exact AUC and
GAUC."""

import csv
import json
import os

import numpy as np
import pytest

from recalgorithm_tpu_torch.data import tfrecord
from recalgorithm_tpu_torch.features.schema import wechat_schema

from torch_dist_common import start_world

N_TRAIN, N_EVAL = 160, 53  # odd eval count: uneven host shards + padded tails
MODES = ("whole", "stream")


def _write_dataset(root):
    """tests/test_multihost_cli.py's split: reference-format SequenceExample
    TFRecords and a vocabulary dir; returns the eval rows' (userid, feedid)."""
    schema = wechat_schema()
    vocab_dir = root / "vocabulary"
    vocab_dir.mkdir()
    vocab_tokens = {
        "userid": [f"userid_{i}" for i in range(12)],
        "feedid": [f"feedid_{i}" for i in range(30)],
        "device": ["device_1", "device_2"],
        "authorid": [f"authorid_{i}" for i in range(6)],
        "bgm_song_id": [f"bgm_song_id_{i}" for i in range(5)],
        "bgm_singer_id": [f"bgm_singer_id_{i}" for i in range(5)],
        "manual_tag_id": [f"manual_tag_id_{i}" for i in range(8)],
    }
    for name, toks in vocab_tokens.items():
        (vocab_dir / f"{name}.txt").write_text("\n".join(toks) + "\n")
    rng = np.random.default_rng(7)

    def write(path, n, offset):
        payloads, ids = [], []
        for i in range(n):
            context = {d: ("float", [float(rng.random())]) for d in schema.dense_names}
            context.update({lab: ("float", [float(rng.integers(0, 2))])
                            for lab in schema.labels})
            u, f = (i + offset) % 12, (i * 7 + offset) % 30
            cats = {"userid": f"userid_{u}", "feedid": f"feedid_{f}", "device": "device_1",
                    "authorid": f"authorid_{i % 6}", "bgm_song_id": f"bgm_song_id_{i % 5}",
                    "bgm_singer_id": f"bgm_singer_id_{i % 5}"}
            context.update({c: ("bytes", [t.encode()]) for c, t in cats.items()})
            fl = {"his_read_comment_7d_seq": ("bytes", [f"feedid_{j % 30}" for j in range(i % 5)]),
                  "manual_tag_list": ("bytes", [f"manual_tag_id_{j}" for j in range(1 + i % 3)])}
            payloads.append(tfrecord.encode_sequence_example(context, fl))
            ids.append((cats["userid"], cats["feedid"]))
        tfrecord.write_records(str(path), payloads)
        return ids

    write(root / "train.tfrecord", N_TRAIN, 0)
    return write(root / "eval.tfrecord", N_EVAL, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost_cli")
    eval_ids = _write_dataset(tmp)
    started = {mode: start_world(tmp, f"cli_{mode}", 2, tmp) for mode in MODES}
    return eval_ids, {mode: finish() for mode, finish in started.items()}


@pytest.mark.parametrize("mode", MODES)
def test_two_process_cli_eval_predict(runs, mode):
    eval_ids, out = runs
    out = out[mode]
    # exact AUC and GAUC computed, the same on both processes (the same
    # gathered global rows)
    finals = []
    for rank in (0, 1):
        with open(os.path.join(out, f"final.r{rank}.json")) as f:
            finals.append(json.load(f))
        assert "read_comment_exact_auc" in finals[-1], sorted(finals[-1])
        assert "read_comment_gauc" in finals[-1], sorted(finals[-1])
    assert finals[0]["read_comment_exact_auc"] == pytest.approx(
        finals[1]["read_comment_exact_auc"], rel=1e-9)
    assert finals[0]["read_comment_auc"] == finals[1]["read_comment_auc"]
    # process 0 wrote predictions.csv with exactly the eval rows, once each,
    # in file order (contiguous shards, or strided chunks with --stream, put
    # back through the global _index)
    with open(os.path.join(out, "predictions.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == N_EVAL, len(rows)
    assert [(r["userid"], r["feedid"]) for r in rows] == eval_ids
    for r in rows:
        assert 0.0 <= float(r["read_comment_probabilities"]) <= 1.0
        assert r["read_comment"] in ("0", "1")
    # only process 0 writes the summaries
    assert os.path.exists(os.path.join(out, "model", "summaries", "scalars.jsonl"))
