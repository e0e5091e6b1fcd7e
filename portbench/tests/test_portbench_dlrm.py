"""The DLRM-DCNv2 cell (``kinds/train_dlrm.py``): its files resolve, its
weights are the program's leaves, its traffic is the seed's, its FLOP and
byte counts are the hand counts, its readers read a synthetic trace, and
with the timed path broken underneath its ``correct`` comes out false (run
on the CPU at a small size)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import flops_dlrm, harness, weights_dlrm
from portbench.trace import Trace
from portbench.traffic import criteo

CELL = "dlrm-dcnv2-train-multihot"
METRICS = ["dlrm_train_mfu", "dlrm_gemm_roofline", "dlrm_tables_roofline",
           "dlrm_embed_ms.train", "dlrm_interaction_ms.train"]
BENCH = harness.benchmark()


def full_cfg() -> dict:
    return harness.config(harness.cell(CELL)["config"])


def small_cfg() -> dict:
    cfg = full_cfg()
    cfg.update(embedding_dim=8, batch_size=64, dense_arch_layer_sizes=[16, 8],
               over_arch_layer_sizes=[16, 16, 8, 4, 1], dcn_low_rank_dim=4,
               num_embeddings_per_feature=[min(n, 3000) for n in
                                           cfg["num_embeddings_per_feature"]])
    return cfg


def test_cell_resolves():
    entry = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    cell = harness.cell(CELL)
    assert cell["kind"] == "train_dlrm" and cell["chips"] == entry["chips"] == 1
    assert cell["config"] == entry["config"] and cell["why"] == entry["why"]
    assert len(entry["why"]) <= 200
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    cfg = harness.config(entry["config"])
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    assert cfg["source"] == conf["source"] and cfg["reduced"] == conf["reduced"]
    assert set(cfg["reduced"]) == set(cfg["sliced"]) and len(cfg["reduced"]) <= 16
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "grad_gap_median", "change_gap",
                                   "change_gap_worst"}
    assert {m["name"] for m in harness.end_to_end(CELL, BENCH)} == {"train_ex_s", "setup_s"}
    assert set(METRICS) <= {m["name"] for m in harness.per_layer(CELL, BENCH)}


@pytest.mark.parametrize("name", METRICS)
def test_metric_file_agrees(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    module = harness.metric_module(name)
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES, module.KIND) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"], "train_dlrm")
    assert entry["workloads"] == [CELL]


def test_weights_spec_is_the_programs_state_dict():
    """At the configuration's full widths, built on the meta device."""
    import torch

    from portbench.kinds import train_dlrm
    from recalgorithm_tpu_torch.models.dlrm import DLRM

    cfg = full_cfg()
    with torch.device("meta"):
        model = DLRM(train_dlrm.model_config(cfg), train_dlrm.schema(cfg))
    assert [(n, tuple(s)) for n, s, _ in weights_dlrm.spec(cfg)] == [
        (k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert sum(v.numel() for v in model.state_dict().values()) > 3.28e9


def test_leaves_drawn_again_are_equal():
    cfg = small_cfg()
    a = weights_dlrm.make(cfg, 2147483999, "cpu")
    name = "embedder.embed.tables.cat_20"
    assert a[name].equal(weights_dlrm.leaf(cfg, 2147483999, name, "cpu"))
    assert not a[name].equal(weights_dlrm.leaf(cfg, 2147484000, name, "cpu"))
    assert weights_dlrm.norm_of_change(cfg, 2147483999, name, a[name]) == 0.0


def test_traffic_is_the_seeds():
    cfg, tr = full_cfg(), {"num_batches": 2, "dense_poisson_lam": 3.0, "label_rate": 0.034}
    a, b = criteo.batches(cfg, tr, 256, 5_000_000_001), criteo.batches(cfg, tr, 256, 5_000_000_001)
    c = criteo.batches(cfg, tr, 256, 5_000_000_002)
    assert all(np.array_equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])
    assert not np.array_equal(a[0]["cat_20"], c[0]["cat_20"])
    assert not np.array_equal(a[0]["cat_20"], a[1]["cat_20"])
    assert a[0]["dense"].shape == (256, 13) and a[0]["labels"].shape == (256, 1)
    assert a[0]["cat_20"].shape == (256, 100) and (a[0]["cat_20_len"] == 100).all()


def test_flops_are_the_hand_count():
    cfg = full_cfg()
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    cross = 3 * 2 * 3456 * 512
    over = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1
    assert flops_dlrm.cross_width(cfg) == 3456
    assert flops_dlrm.forward_per_row(cfg) == 2 * (bottom + cross + over) == 32_060_928
    assert flops_dlrm.train_step(cfg, 8192) == 3 * 32_060_928 * 8192


def test_table_bytes_are_the_hand_count():
    cfg = small_cfg()
    batch = {f"cat_{i}": np.ones((4, h) if h > 1 else (4,), np.int32)
             for i, h in enumerate(cfg["multi_hot_sizes"])}
    batch["cat_0"] = np.array([[1, 2, 2], [3, 1, 1], [1, 1, 1], [2, 2, 2]], np.int32)
    batch["labels"] = np.zeros((4, 1), np.float32)
    dim = 8
    ids = 4 * 214
    distinct = 3 + 25  # cat_0 holds 1, 2 and 3; every other table id 1 alone
    want = ids * dim * 4 + 2 * (4 * 26 * dim * 4) + 6 * distinct * dim * 4
    assert flops_dlrm.distinct_rows(cfg, batch) == distinct
    assert flops_dlrm.table_bytes(cfg, batch) == want


def _trace(cfg, events, data):
    return Trace(kind="train", cfg=cfg, window_s=2.0, busy_s=1.5, events=events,
                 breakdown={}, data=data)


def test_readers_on_a_synthetic_trace(monkeypatch):
    cfg = full_cfg()
    work = flops_dlrm.train_step(cfg, 3 * 8192)
    gemm_ms = work / 67e12 * 1e3 * 2  # the products at half their peak
    events = [("sm90_xmma_gemm_f32f32_f32f32_f32_nn", 0, gemm_ms * 1e3 / 2),
              ("ampere_sgemm_128x64_tn", 10, gemm_ms * 1e3 / 2),
              ("indexSelectLargeIndex", 20, 4000.0), ("Memset (Device)", 30, 1000.0)]
    data = {"steps": 3, "examples": 3 * 8192, "table_bytes": int(3.35e12 * 0.001)}
    trace = _trace(cfg, events, data)
    read = {m: harness.metric_module(m).read(trace) for m in METRICS[:3]}
    assert read["dlrm_train_mfu"] == pytest.approx(100 * work / 2.0 / 67e12)
    assert read["dlrm_gemm_roofline"] == pytest.approx(50.0)
    assert read["dlrm_tables_roofline"] == pytest.approx(100 * 1.0 / 5.0)

    from portbench import spans
    from recalgorithm_tpu_torch.utils.summary import SpanRecord

    records = [SpanRecord("train.step", 1, None, 0.0, 0.1),
               SpanRecord("train.step", 2, None, 0.1, 0.2),
               SpanRecord("train.forward", 3, 2, 0.1, 0.15),
               SpanRecord("dlrm.embed", 4, 3, 0.1, 0.104),
               SpanRecord("dlrm.embed", 5, 3, 0.15, 0.152),
               SpanRecord("dlrm.interaction", 6, 3, 0.104, 0.105)]
    monkeypatch.setattr(spans, "recorded", lambda: records)
    assert harness.metric_module("dlrm_embed_ms.train").read(trace) == pytest.approx(3.0)
    assert harness.metric_module("dlrm_interaction_ms.train").read(trace) == pytest.approx(0.5)
    # another model's trace, or no spans: nothing read
    other = _trace({"model": "BST"}, events, data)
    assert all(harness.metric_module(m).read(other) is None for m in METRICS)
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert harness.metric_module("dlrm_embed_ms.train").read(trace) is None


def _small_run(monkeypatch, tmp_path, seed=2147483999):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench.kinds import kind

    cell = harness.cell(CELL)
    cell["traffic"]["num_batches"] = 4
    run = harness.Run(CELL, cell, small_cfg(), seed, 1.0, False, device="cpu",
                      started=time.perf_counter())
    return kind(cell["kind"]).run(run)


def test_small_run_is_correct(monkeypatch, tmp_path):
    res = _small_run(monkeypatch, tmp_path)
    assert res.correct, res.checks
    assert res.attempted > 0 and set(res.e2e) == {"train_ex_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state", "table_unmoved"])
def test_fault_is_caught(monkeypatch, tmp_path, fault):
    from portbench import control_dlrm

    control_dlrm.FAULTS[fault](monkeypatch.setattr)
    res = _small_run(monkeypatch, tmp_path)
    assert not res.correct, res.checks


def test_modules_load_no_jax_and_reference_none_of_the_program():
    code = ("import portbench.reference.dlrm, portbench.traffic.criteo, "
            "portbench.weights_dlrm, portbench.flops_dlrm\n"
            "import sys, json\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0].startswith(("recalgorithm_tpu", "jax"))]
    code = ("import portbench.kinds.train_dlrm, portbench.control_dlrm\n"
            "import recalgorithm_tpu_torch.models.dlrm\n"
            "import sys, json\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not top & set(harness.FORBIDDEN)
