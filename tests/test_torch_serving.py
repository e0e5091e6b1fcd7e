"""Port parity for serving: a JAX export carried across by convert, the
port's Predictor against the JAX Predictor, the dynamic batcher, and the
HTTP server built by the port's build_server, all on the CPU."""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.din import DIN as JaxDIN, DINConfig as JaxDINConfig
from recalgorithm_tpu.serving.predictor import Predictor as JaxPredictor
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import serve as tserve
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models.din import DIN, DINConfig
from recalgorithm_tpu_torch.serving.predictor import Predictor
from recalgorithm_tpu_torch.serving.server import BatchingPredictor

SCALE = 0.002
HIDDEN = (32, 16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX DIN export (params.msgpack, as the train loop writes it) and
    the same weights exported by the port into a model_dir."""
    tmp = tmp_path_factory.mktemp("serve")
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=0, vocab_scale=SCALE))
    jmodel = JaxDIN(config=JaxDINConfig(hidden_units=HIDDEN),
                    schema=wechat_schema(gen.vocab_sizes()))
    batch = {k: jnp.asarray(v) for k, v in gen.batch(16, 0).items()}
    variables = jmodel.init(jax.random.key(0), batch, train=False)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        variables["batch_stats"])
    jax_dir = str(tmp / "jax_export")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "params.msgpack"), "wb") as f:
        f.write(flax.serialization.to_bytes(
            {"params": variables["params"], "batch_stats": stats}))

    with open(os.path.join(jax_dir, "params.msgpack"), "rb") as f:
        restored = flax.serialization.msgpack_restore(f.read())
    schema = t_wechat_schema(gen.vocab_sizes())
    model = DIN(DINConfig(hidden_units=HIDDEN), schema)
    model.load_state_dict(convert.from_flax(restored))
    model_dir = str(tmp / "model_dir")
    convert.save_export(model_dir, 120, 0.61, model)
    convert.save_export(model_dir, 300, 0.74, model)  # the best one
    convert.save_export(model_dir, 200, 0.70, model)
    return gen, schema, jmodel, jax_dir, model_dir


def _port_predictor(exported):
    gen, schema, _, _, model_dir = exported
    model = DIN(DINConfig(hidden_units=HIDDEN), schema)
    return Predictor(model, Predictor.latest_best(model_dir), device="cpu")


def test_export_layout(exported):
    model_dir = exported[4]
    assert Predictor.latest_best(model_dir) == os.path.join(
        model_dir, "export", "best_300")
    with open(os.path.join(model_dir, "best_exports.json")) as f:
        assert [s for _, s in json.load(f)] == [300, 200, 120]
    with open(os.path.join(model_dir, "export", "best_300", "metrics.json")) as f:
        assert json.load(f) == {"auc": 0.74, "step": 300}
    with np.load(os.path.join(model_dir, "export", "best_300", "params.npz")) as z:
        assert z["params/FieldEmbedder_0/embed/feedid"].shape == (256, 16)
        assert z["batch_stats/fcn/dice_0/BatchNorm_0/var"].shape == (32,)


def test_predictor_matches_jax(exported):
    gen, _, jmodel, jax_dir, _ = exported
    hb = gen.batch(48, 5)
    want = JaxPredictor(jmodel, jax_dir).predict_batch(hb)["read_comment"]
    pred = _port_predictor(exported)
    assert pred.device == torch.device("cpu")
    assert pred.export_metrics == {"auc": 0.74, "step": 300}
    got = pred.predict_batch(hb)["read_comment"]
    assert got.shape == (48,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_predict_drops_padded_rows(exported):
    gen = exported[0]
    pred = _port_predictor(exported)
    full, tail = gen.batch(8, 1), gen.batch(8, 2)
    tail["_weights"] = (np.arange(8) < 5).astype(np.float32)
    out = pred.predict([full, tail])["read_comment"]
    assert out.shape == (13,)
    np.testing.assert_allclose(out[:8], pred.predict_batch(full)["read_comment"],
                               rtol=0, atol=1e-7)


def test_no_device_without_cuda_raises(exported):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    gen, schema, _, _, model_dir = exported
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(DIN(DINConfig(hidden_units=HIDDEN), schema),
                  Predictor.latest_best(model_dir))
    args = _args(model_dir)
    del args.device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_server(args)


def test_batching_predictor_buckets_and_padded_tail(exported):
    gen = exported[0]
    pred = _port_predictor(exported)
    hb = gen.batch(7, 9)
    direct = pred.predict_batch(hb)["read_comment"]
    bp = BatchingPredictor(pred, max_batch_size=16, max_delay_ms=200.0,
                           buckets=(4, 16))
    try:
        assert bp.buckets == (4, 16)
        futs = [bp.predict_async({k: v[i] for k, v in hb.items()}) for i in range(7)]
        got = np.array([f.result(timeout=60)["read_comment"] for f in futs])
        np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)
        st = bp.stats()
        assert st["requests"] == 7 and st["errors"] == 0
        # a malformed request fails its own batch only
        bad = bp.predict_async({"dense": np.zeros(3, np.float32)})
        with pytest.raises(Exception):
            bad.result(timeout=60)
        ok = bp.predict_one({k: v[0] for k, v in hb.items()})
        np.testing.assert_allclose(ok["read_comment"], direct[0], atol=1e-6)
    finally:
        bp.close()


def _args(model_dir, **kw):
    base = dict(model="DIN", model_dir=model_dir, export_dir=None,
                vocabulary_dir=None, synthetic_vocab_scale=SCALE,
                host="127.0.0.1", port=0, max_batch_size=32, max_delay_ms=1.0,
                hidden_units=HIDDEN, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _post(url, payload, path="/predict"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_round_trip(exported):
    gen, schema, _, _, model_dir = exported
    httpd, batchers = tserve.build_server(_args(model_dir))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok"
        hb = gen.batch(4, 11)
        direct = _port_predictor(exported).predict_batch(hb)["read_comment"]
        for i in range(4):
            payload = {
                "dense": hb["dense"][i].tolist(),
                **{f.name: int(hb[f.name][i]) for f in schema.categorical},
                **{f.name: hb[f.name][i][: int(hb[f.name + "_len"][i])].tolist()
                   for f in schema.sequence},
            }
            status, out = _post(url, payload)
            assert status == 200, out
            np.testing.assert_allclose(out["predictions"]["read_comment"],
                                       direct[i], rtol=0, atol=1e-6)
        status, out = _post(url, {"userid": "userid_1"})  # token, no vocab
        assert status == 400 and "error" in out
        status, out = _post(url, {"his_read_comment_7d_seq": "abc"})
        assert status == 400
        status, out = _post(url, {})  # all-PAD example still served
        assert status == 200 and 0.0 <= out["predictions"]["read_comment"] <= 1.0
        assert _post(url, {}, path="/predict/nope")[0] == 404
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["requests"] >= 5 and m["batches"] >= 1 and m["errors"] == 0
        assert "batch_latency_ms_p50" in m
    finally:
        httpd.shutdown()
        for b in batchers.values():
            b.close()


def test_make_example_coercion():
    schema = t_wechat_schema()
    seq = schema.sequence[0]
    ex = tserve.make_example(schema, {
        "userid": 7, seq.name: list(range(1, seq.max_length + 10)),
        "videoplayseconds": 3.5})
    assert ex["userid"] == 7
    assert ex[seq.name].shape == (seq.max_length,)
    assert int(ex[seq.name + "_len"]) == seq.max_length
    assert ex["dense"][0] == np.float32(3.5)


def test_serve_cli_sigterm_graceful(exported):
    """The real entry point on --device cpu: serves, then drains on SIGTERM."""
    model_dir = exported[4]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "recalgorithm_tpu_torch.cli.serve",
         "--model", "DIN", "--model_dir", model_dir, "--device", "cpu",
         "--synthetic_vocab_scale", str(SCALE), "--port", str(port),
         "--hidden_units", "32,16"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.3)
        assert _post(url, {})[0] == 200
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
        assert proc.returncode == 0, stderr[-500:]
        assert "device=cpu" in stdout and "shutdown:" in stdout
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_serve_cli_help_names_what_waits():
    out = subprocess.run(
        [sys.executable, "-m", "recalgorithm_tpu_torch.cli.serve", "--model",
         "DIN", "--help"], env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    text = " ".join(out.stdout.split()).lower()
    assert "not offered yet" not in text  # --quantize and --stablehlo are offered
    assert "--quantize" in text and "--stablehlo" in text
    assert "--device" in text and "--use_softmax" in text


def test_chip_smoke_needs_a_gpu():
    """The smoke run is a measurement path: without a card it fails and
    prints no result, it does not measure the CPU under a device metric's
    name."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
    assert "is_available() is False" in out.stderr
