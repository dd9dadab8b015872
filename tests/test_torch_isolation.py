"""The port stands alone: nothing of JAX, flax, optax, orbax or the JAX
package.

``tests/conftest.py`` imports jax into the test process, so the import
check runs in a fresh interpreter: import every module of
``tensorflowonspark_tpu_torch`` and ``chip_smoke``, then neither ``jax``
nor ``tensorflowonspark_tpu`` (the exact name or a dotted child — the
port's own name shares that prefix) may be loaded. A static scan of the
sources (the package, ``chip_smoke.py`` and the port's
``scripts/torch_flash_ab.py`` and ``scripts/torch_paged_ab.py``, and the
node programs the cluster tests hand to spawned executors) backs it up for
imports a run might not reach. A spawned executor of a port cluster, and
its node program, load neither either.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tensorflowonspark_tpu")

_CHILD = r"""
import importlib, json, pkgutil, sys
import tensorflowonspark_tpu_torch as pkg
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _forbidden(name):
    return any(name == root or name.startswith(root + ".")
               for root in FORBIDDEN)


def test_forbidden_name_match_is_exact():
    assert _forbidden("tensorflowonspark_tpu")
    assert _forbidden("tensorflowonspark_tpu.serving.cache")
    assert _forbidden("jax.numpy")
    assert _forbidden("orbax.checkpoint")
    assert not _forbidden("tensorflowonspark_tpu_torch")
    assert not _forbidden("tensorflowonspark_tpu_torch.serving")
    assert not _forbidden("jaxtyping_free_module")


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tensorflowonspark_tpu_torch.serving.engine" in doc["imported"]
    for name in ("ops.paged_attention", "ops.flash_attention",
                 "ops.attention", "ops.fused_resnet_block", "models.resnet",
                 "models.factory", "models.transformer", "models.decoding",
                 "serving.scheduler", "serving.runner", "serving.cache",
                 "convert", "initializers", "fs", "util",
                 "train.trainer", "train.losses", "train.checkpoint",
                 "train.prefetch", "train.tbevents", "train.metrics",
                 "backend", "cluster", "feed", "manager", "marker", "node",
                 "paths", "reservation", "telemetry", "telemetry_store",
                 "parallel.mesh", "parallel.multihost"):
        assert "tensorflowonspark_tpu_torch." + name in doc["imported"]
    loaded = [m for m in doc["loaded"] if _forbidden(m)]
    assert loaded == []


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "torch_block_ab.py"),
             os.path.join(ROOT, "scripts", "torch_flash_ab.py"),
             os.path.join(ROOT, "scripts", "torch_paged_ab.py"),
             os.path.join(ROOT, "tests", "torch_cluster_programs.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "{}:{} imports {}".format(path, node.lineno, bad)


@pytest.mark.watchdog_timeout(120)
def test_spawned_cluster_executors_load_no_jax(tmp_path):
    """A FILES-mode port cluster: the executor process that runs the node
    program (spawned by ``LocalBackend``, fed a pickled task) reports the
    forbidden modules it has loaded."""
    import torch_cluster_programs as progs
    from tensorflowonspark_tpu_torch import backend, cluster

    pool = backend.LocalBackend(1, base_dir=str(tmp_path / "exec"))
    try:
        c = cluster.run(pool, progs.write_square_files,
                        {"outdir": str(tmp_path)}, num_executors=1,
                        input_mode=cluster.InputMode.FILES,
                        reservation_timeout=60)
        c.shutdown(timeout=60)
    finally:
        pool.stop()
    with open(os.path.join(tmp_path, "node_0.json")) as f:
        doc = json.load(f)
    assert doc["value"] == 4.0 and doc["forbidden"] == []
