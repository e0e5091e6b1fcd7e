"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole), the reference loads nothing of the program, and a run without a
card exits 1 with no result."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def _modules(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax():
    loaded = _modules("import runpy; runpy.run_path('portbench/run.py', run_name='x')\n"
                      "import portbench.kinds.train, portbench.kinds.serve, portbench.trace\n"
                      "import portbench.reference.bst, portbench.reference.din\n"
                      "import recalgorithm_tpu_torch.models, recalgorithm_tpu_torch.train.loop\n"
                      "import recalgorithm_tpu_torch.serving.server")
    assert "recalgorithm_tpu_torch" in loaded
    top = {m.split(".")[0] for m in loaded}
    assert not top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _modules("import portbench.reference.bst, portbench.reference.din\n"
                      "import portbench.traffic.train, portbench.traffic.serve\n"
                      "import portbench.weights, portbench.flops, portbench.roofline")
    assert not [m for m in loaded if m.split(".")[0].startswith("recalgorithm_tpu")]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    monkeypatch.setitem(sys.modules, "recalgorithm_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_no_card_exits_without_result(tmp_path):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bst-train-short",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
