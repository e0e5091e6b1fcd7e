"""The port stands alone: importing every module of recalgorithm_tpu_torch,
and chip_smoke.py, loads no jax, no flax, nothing of recalgorithm_tpu, and
no pandas (which only the two ETLs import, inside ``run``)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib.util, pkgutil, sys
import recalgorithm_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "recalgorithm_tpu", "pandas"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "chip_smoke.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 20  # every module of the slice was imported


_SEVERAL = r"""
import sys
import recalgorithm_tpu_torch.embed.sharded
import recalgorithm_tpu_torch.parallel.mesh
import recalgorithm_tpu_torch.parallel.multihost
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "recalgorithm_tpu"))
print(bad)
"""


def test_several_process_modules_import_no_jax():
    """parallel/ and embed/sharded.py, alone: no jax, flax or JAX-package
    import when loaded, and none in their sources."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _SEVERAL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout
    pkg = os.path.join(REPO, "recalgorithm_tpu_torch")
    paths = [os.path.join(pkg, "embed", "sharded.py")] + [
        os.path.join(pkg, "parallel", f) for f in os.listdir(os.path.join(pkg, "parallel"))
        if f.endswith(".py")]
    assert len(paths) >= 4
    for path in paths:
        with open(path) as f:
            imports = [ln.split() for ln in f if ln.lstrip().startswith(("import ", "from "))]
        roots = {words[1].split(".")[0] for words in imports}
        assert not roots & {"jax", "jaxlib", "flax", "recalgorithm_tpu"}, (path, roots)


_NEW = r"""
import sys
import recalgorithm_tpu_torch.ops.compact_scatter
import recalgorithm_tpu_torch.data.stats
import recalgorithm_tpu_torch.utils.benchmarking
import recalgorithm_tpu_torch.utils.summary
import recalgorithm_tpu_torch.cli.sweep
import recalgorithm_tpu_torch.cli.din
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "recalgorithm_tpu", "matplotlib",
                                                           "tensorboard", "tensorflow"))
print(bad)
"""


def test_utility_modules_import_no_jax():
    """ops/compact_scatter.py, data/stats.py, utils/, cli/sweep.py and the
    model aliases: no jax, flax or JAX-package import when loaded (and no
    matplotlib or tensorboard until a plot or a writer is made), and none
    in their sources."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NEW], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout
    pkg = os.path.join(REPO, "recalgorithm_tpu_torch")
    cli = os.path.join(pkg, "cli")
    paths = [os.path.join(pkg, *p) for p in (("ops", "compact_scatter.py"), ("data", "stats.py"),
                                             ("utils", "benchmarking.py"),
                                             ("utils", "summary.py"))]
    paths += [os.path.join(cli, f) for f in os.listdir(cli) if f.endswith(".py")]
    assert len(paths) >= 4 + 27
    for path in paths:
        with open(path) as f:
            imports = [ln.split() for ln in f if ln.lstrip().startswith(("import ", "from "))]
        roots = {words[1].split(".")[0] for words in imports}
        assert not roots & {"jax", "jaxlib", "flax", "recalgorithm_tpu"}, (path, roots)
