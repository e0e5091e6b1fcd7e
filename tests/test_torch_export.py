"""Port parity for the serving artifact (serving/export.py, HLOPredictor,
cli/serve.py --stablehlo, cli/score.py), on the CPU.

The artifact is a ``torch.export`` program; served by ``HLOPredictor`` it
must give the live ``Predictor``'s probabilities within rtol = atol = 1e-5
(the same ops on the same weights: summation order at most), f32 and with
int8 tables, and hold one op node for each hand kernel the model calls.  Its
manifest carries the JAX package's keys and values, but for ``outputs``,
which is the resolved task list where the JAX export writes the raw
``task_names`` (``()`` for DeepFM)."""

import argparse
import csv
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.serving.export import export_stablehlo as jax_export
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.cli import score as tscore
from recalgorithm_tpu_torch.cli import serve as tserve
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.serving.export import export_stablehlo
from recalgorithm_tpu_torch.serving.predictor import HLOPredictor, Predictor
from tests.torch_zoo_common import TOL, build_pair, jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.05  # feedid and W&D's cross take the gather rule: int8 under quantize
B = 16
SMALL = dict(hidden_units=(16,), dropout_rate=0.0)
KERNEL_OPS = {"DIN": "recalgorithm_torch.din_attention.default",
              "BST": "recalgorithm_torch.bst_mha_forward.default"}


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=5, vocab_scale=SCALE))


def _model(name, gen, seed=0):
    """The port's ``name`` at small widths with random weights: every
    parameter (the zero-init wide table too) uniform, BN statistics drawn."""
    cfg_cls, cls = get_model(name)
    cfg = cfg_cls(**{k: v for k, v in SMALL.items() if k in cfg_cls.__dataclass_fields__})
    model = cls(cfg, t_wechat_schema(gen.vocab_sizes()), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=g) - 0.5)
        for n, buf in model.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model


def _export(name, gen, tmp_path, quantize=False, batch_size=B, seed=0):
    model = _model(name, gen, seed)
    path = str(tmp_path / f"{name}{'_int8' if quantize else ''}.pt2")
    export_stablehlo(model, model.schema, batch_size, path, quantize_embeddings=quantize)
    return model, path


def _nodes(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", ["BST", "DIN", "DeepFM", "WideAndDeep"])
def test_artifact_matches_the_live_predictor(gen, tmp_path, name, quantize):
    model, path = _export(name, gen, tmp_path, quantize)
    export_dir = convert.save_export(str(tmp_path / "model_dir"), 1, 0.5, model)
    cfg_cls, cls = get_model(name)
    live = Predictor(cls(model.config, model.schema), export_dir, device="cpu",
                     quantize=quantize)
    pred = HLOPredictor(path, device="cpu")
    hb = gen.batch(B, 3)
    hb["his_read_comment_7d_seq"][0], hb["his_read_comment_7d_seq_len"][0] = 0, 0
    got, want = pred.predict_batch(hb), live.predict_batch(hb)
    assert pred.tasks == list(want) == ["read_comment"]
    np.testing.assert_allclose(got["read_comment"], want["read_comment"], **TOL)
    nodes = _nodes(pred.program)
    kernel_ops = [n for n in nodes if n.startswith("recalgorithm_torch.")]
    assert kernel_ops == ([KERNEL_OPS[name]] if name in KERNEL_OPS else []), kernel_ops
    state = pred.program.state_dict
    quantized = sorted(k for k in state if k.endswith("__q"))
    if quantize:  # the int8 tables are in the program, their f32 tables are not
        assert quantized and all(state[k].dtype == torch.int8 for k in quantized)
        for k in quantized:
            module, table = k[: -len("__q")].rsplit(".", 1)
            assert f"{module}.tables.{table}" not in state, k
    else:
        assert not quantized
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)
    assert manifest["quantized_embeddings"] is quantize
    assert manifest["artifact_bytes"] == os.path.getsize(path)


def test_int8_artifact_of_wide_and_deep_is_smaller(gen, tmp_path):
    """The 100k-bucket cross table dominates W&D's artifact: int8 makes it
    < 0.45x the f32 bytes (the JAX package's bound); the probabilities stay
    within 0.02."""
    _, f32 = _export("WideAndDeep", gen, tmp_path)
    _, int8 = _export("WideAndDeep", gen, tmp_path, quantize=True)
    assert os.path.getsize(int8) < 0.45 * os.path.getsize(f32)
    hb = gen.batch(B, 4)
    p32 = HLOPredictor(f32, device="cpu").predict_batch(hb)["read_comment"]
    p8 = HLOPredictor(int8, device="cpu").predict_batch(hb)["read_comment"]
    assert 0 < np.max(np.abs(p32 - p8)) < 0.02


def test_manifest_matches_jax(gen, tmp_path):
    """Key by key the JAX manifest, but ``outputs``: the resolved task list,
    where the JAX export writes DeepFM's raw ``task_names`` ``()``."""
    jschema = wechat_schema(gen.vocab_sizes())
    jmodel, model = build_pair("DeepFM", SMALL, {}, jschema, t_wechat_schema(gen.vocab_sizes()))
    hb = gen.batch(B, 0)
    variables = jax_variables(jmodel, hb, seed=1)
    model.load_state_dict(convert.from_flax(variables))
    jpath, path = str(tmp_path / "m.stablehlo"), str(tmp_path / "m.pt2")
    jax_export(jmodel, variables, jschema, batch_size=B, out_path=jpath)
    export_stablehlo(model, model.schema, B, path)
    with open(jpath + ".manifest.json") as f:
        want = json.load(f)
    with open(path + ".manifest.json") as f:
        got = json.load(f)
    assert set(got) == set(want)
    for key in ("model", "batch_size", "quantized_embeddings", "inputs"):
        assert got[key] == want[key], key
    assert "labels" not in got["inputs"]
    assert want["outputs"] == [] and got["outputs"] == ["read_comment"]
    assert got["artifact_bytes"] == os.path.getsize(path)
    # and the JAX model's probabilities
    jprobs = jax.jit(lambda b: jax.nn.sigmoid(jmodel.apply(variables, b)["read_comment"]))
    with jax.default_matmul_precision("highest"):
        jp = np.asarray(jprobs({k: jnp.asarray(v) for k, v in hb.items()}))
    np.testing.assert_allclose(HLOPredictor(path, device="cpu").predict_batch(hb)[
        "read_comment"], jp, **TOL)


def test_hlo_predictor_pads_slices_and_drops_padded_rows(gen, tmp_path):
    _, path = _export("DeepFM", gen, tmp_path)
    pred = HLOPredictor(path, device="cpu")
    assert pred.batch_size == B and pred.device == torch.device("cpu")
    full = gen.batch(B, 1)
    whole = pred.predict_batch(full)["read_comment"]
    part = pred.predict_batch({k: v[:5] for k, v in full.items()})["read_comment"]
    assert part.shape == (5,)
    np.testing.assert_array_equal(part, whole[:5])
    with pytest.raises(ValueError, match="exceeds"):
        pred.predict_batch(gen.batch(B + 1, 2))
    with pytest.raises(KeyError, match="feedid"):
        pred.predict_batch({k: v for k, v in full.items() if k != "feedid"})
    tail = dict(full, _weights=(np.arange(B) < 5).astype(np.float32))
    out = pred.predict([full, tail])["read_comment"]
    np.testing.assert_array_equal(out, np.concatenate([whole, whole[:5]]))


def test_entry_points_raise_without_a_gpu(gen, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    _, path = _export("DeepFM", gen, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HLOPredictor(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_server(_serve_args([path], device=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscore.main(["--stablehlo", path, "--data", "unused", "--vocabulary_dir", "unused"])


def _serve_args(stablehlo, device="cpu"):
    args = argparse.Namespace(
        stablehlo=stablehlo, model=None, vocabulary_dir=None, synthetic_vocab_scale=SCALE,
        host="127.0.0.1", port=0, max_batch_size=256, max_delay_ms=2.0)
    if device is not None:
        args.device = device
    return args


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_several_artifacts_routed_over_http(gen, tmp_path):
    """``--stablehlo a=... --stablehlo b=...``: each at /predict/<name>,
    answering as its artifact's predict_batch; a bare /predict is refused as
    ambiguous."""
    _, din = _export("DIN", gen, tmp_path)
    _, bst = _export("BST", gen, tmp_path, batch_size=8)
    httpd, batchers = tserve.build_server(_serve_args([f"din={din}", f"bst={bst}"]))
    assert set(batchers) == {"din", "bst"}
    assert batchers["bst"].buckets == (8,)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    hb = gen.batch(6, 9)
    schema = t_wechat_schema(gen.vocab_sizes())
    try:
        for name, path in (("din", din), ("bst", bst)):
            want = HLOPredictor(path, device="cpu").predict_batch(hb)["read_comment"]
            for i in range(6):
                payload = {"dense": hb["dense"][i].tolist(),
                           **{f.name: int(hb[f.name][i]) for f in schema.categorical},
                           **{f.name: hb[f.name][i][: hb[f.name + "_len"][i]].tolist()
                              for f in schema.sequence}}
                code, body = _post(f"{url}/predict/{name}", payload)
                assert code == 200, body
                np.testing.assert_allclose(body["predictions"]["read_comment"], want[i], **TOL)
        code, body = _post(f"{url}/predict", {})
        assert code == 404 and "several models" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        for b in batchers.values():
            b.close()


_PROBE = r"""
import json, os, signal, socket, sys, threading, time, urllib.request
from recalgorithm_tpu_torch.cli import serve

s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
out = {}

def client():
    url = f"http://127.0.0.1:{port}"
    for _ in range(600):
        try:
            urllib.request.urlopen(url + "/healthz", timeout=2).read()
            break
        except OSError:
            time.sleep(0.2)
    req = urllib.request.Request(url + "/predict", data=b"{}",
                                 headers={"Content-Type": "application/json"})
    out["body"] = json.loads(urllib.request.urlopen(req, timeout=60).read())
    out["models"] = sorted(m for m in sys.modules
                           if m.startswith("recalgorithm_tpu_torch.models"))
    os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=client, daemon=True).start()
serve.main(["--stablehlo", sys.argv[1], "--device", "cpu", "--port", str(port),
            "--synthetic_vocab_scale", sys.argv[2]])
print(json.dumps(out))
"""


def test_artifact_serves_without_model_code(gen, tmp_path):
    """cli.serve --stablehlo in a process of its own answers a request and
    drains on SIGTERM without ever importing recalgorithm_tpu_torch.models."""
    _, path = _export("DIN", gen, tmp_path)
    out = subprocess.run([sys.executable, "-c", _PROBE, path, str(SCALE)],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["models"] == []
    example = tserve.make_example(t_wechat_schema(gen.vocab_sizes()), {})
    want = HLOPredictor(path, device="cpu").predict_batch(
        {k: v[None] for k, v in example.items()})
    np.testing.assert_allclose(result["body"]["predictions"]["read_comment"],
                               want["read_comment"][0], **TOL)


def test_serve_cli_needs_a_model_or_an_artifact(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu"])
    assert "one of --model or --stablehlo is required" in capsys.readouterr().err


@pytest.fixture(scope="module")
def etl_split(tmp_path_factory):
    """data.synth_raw's raw CSVs at scale 0.001 through data.etl: (train,
    test, vocabulary dir)."""
    from recalgorithm_tpu_torch.data.etl import WeChatETL
    from recalgorithm_tpu_torch.data.synth_raw import RawConfig, generate_raw_csvs

    root = tmp_path_factory.mktemp("etl")
    generate_raw_csvs(str(root / "raw"), RawConfig(scale=0.001, seed=3))
    WeChatETL(str(root / "raw") + "/", str(root / "out") + "/").run()
    tf = root / "out" / "tfrecord"
    return str(tf / "train.tfrecord"), str(tf / "test.tfrecord"), str(root / "out" / "vocabulary")


def test_score_cli_writes_the_trainers_predictions(etl_split, tmp_path):
    """W&D trained by cli.main on the ETL's files exports its artifact;
    cli.score on the test split writes the trainer's predictions.csv: the
    same header, id tokens and labels, the probabilities within the CSV's
    last decimal, every row once (the padded tail dropped)."""
    train, test, vocab_dir = etl_split
    artifact = str(tmp_path / "wd.pt2")
    tmain.main(["--model", "WideAndDeep", "--train_data", train, "--eval_data", test,
                "--vocabulary_dir", vocab_dir, "--batch_size", "64", "--train_steps", "4",
                "--hidden_units", "16", "--log_every", "2", "--device", "cpu",
                "--model_dir", str(tmp_path / "md"), "--predictions_csv",
                str(tmp_path / "pred.csv"), "--export_stablehlo", artifact])
    out = str(tmp_path / "scored.csv")
    tscore.main(["--stablehlo", artifact, "--data", test, "--vocabulary_dir", vocab_dir,
                 "--out", out, "--device", "cpu"])
    with open(tmp_path / "pred.csv") as f:
        want = list(csv.reader(f))
    with open(out) as f:
        got = list(csv.reader(f))
    assert got[0] == want[0] == ["feedid", "userid", "read_comment_probabilities",
                                 *t_wechat_schema().labels]
    assert len(got) == len(want) > 65  # more rows than one batch: a padded tail
    g, w = np.array(got[1:], dtype=object), np.array(want[1:], dtype=object)
    np.testing.assert_array_equal(g[:, [0, 1, *range(3, g.shape[1])]],
                                  w[:, [0, 1, *range(3, w.shape[1])]])
    np.testing.assert_allclose(g[:, 2].astype(float), w[:, 2].astype(float), rtol=0, atol=1e-6)
