"""The port stands alone: nothing of JAX, flax, optax, orbax, ml_dtypes or
the JAX package.

``tests/conftest.py`` imports jax into the test process, so the import
check runs in a fresh interpreter: import every module of
``tensorflowonspark_tpu_torch`` and ``chip_smoke``, then neither ``jax``
nor ``tensorflowonspark_tpu`` (the exact name or a dotted child — the
port's own name shares that prefix) may be loaded. A static scan of the
sources (the package, ``chip_smoke.py`` and the port's
``scripts/torch_flash_ab.py`` and ``scripts/torch_paged_ab.py``, the
node programs the cluster tests hand to spawned executors, and the decode
functions the data tests hand to decode workers) backs it up for
imports a run might not reach. A spawned executor of a port cluster, and
its node program, load neither either; nor do the processes of the
recovery paths: a supervised job's relaunched incarnation, an elastic
cluster's replacement node, and a remote agent (started with ``python -m
tensorflowonspark_tpu_torch.tools.agent``), its tasks and its compute
children.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
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
    assert _forbidden("ml_dtypes")
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
                 "serving.fleet", "serving.autoscaler",
                 "convert", "initializers", "fs", "util",
                 "train.trainer", "train.losses", "train.checkpoint",
                 "train.prefetch", "train.tbevents", "train.metrics",
                 "backend", "cluster", "feed", "manager", "marker", "node",
                 "paths", "reservation", "telemetry", "telemetry_store",
                 "parallel.mesh", "parallel.multihost", "supervisor",
                 "elastic", "backend_remote", "tools.agent",
                 "testing.faults", "testing.programs", "models.mlp",
                 "parallel.pipeline", "models.moe", "models.pipelined",
                 "data", "data._native", "data.tfrecord", "data.example",
                 "data.batch_decode", "data.dfutil", "data.packing",
                 "data.input_pipeline", "data.decode_pool",
                 "data.batch_cache", "data.image_preprocessing"):
        assert "tensorflowonspark_tpu_torch." + name in doc["imported"]
    loaded = [m for m in doc["loaded"] if _forbidden(m)]
    assert loaded == []


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "torch_bf16_routes.py"),
             os.path.join(ROOT, "scripts", "torch_block_ab.py"),
             os.path.join(ROOT, "scripts", "torch_flash_ab.py"),
             os.path.join(ROOT, "scripts", "torch_fork_scan.py"),
             os.path.join(ROOT, "scripts", "torch_paged_ab.py"),
             os.path.join(ROOT, "scripts", "torch_shard_run.py"),
             os.path.join(ROOT, "tests", "torch_cluster_programs.py"),
             os.path.join(ROOT, "tests", "torch_data_programs.py"),
             os.path.join(ROOT, "tests", "torch_shard_programs.py")]
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


def _probes(probe_dir, kind):
    docs = []
    for name in sorted(os.listdir(probe_dir)):
        if name.startswith(kind):
            with open(os.path.join(probe_dir, name)) as f:
                docs.append(json.load(f))
    return docs


def _linreg_items(n):
    import numpy as np

    rng = np.random.RandomState(3)
    x = rng.rand(n, 2).astype(np.float32)
    y = x @ np.asarray([1.5, -2.0], np.float32) + 0.25
    return [(x[i].tolist(), float(y[i])) for i in range(n)]


@pytest.mark.watchdog_timeout(120)
def test_relaunched_incarnation_loads_no_jax(tmp_path):
    import torch_cluster_programs as progs
    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.supervisor import RestartPolicy
    from tensorflowonspark_tpu_torch.testing import faults

    probe_dir = str(tmp_path / "probes")
    os.makedirs(probe_dir)
    model_dir = str(tmp_path / "model")
    plan = faults.FaultPlan(str(tmp_path / "faults"))
    plan.crash_at_step(1)
    pool = backend.LocalBackend(1, base_dir=str(tmp_path / "exec"))
    try:
        sup = cluster.run(
            pool, progs.supervised_probe,
            {"model_dir": model_dir, "plan_dir": plan.plan_dir,
             "probe_dir": probe_dir, "device": "cpu"},
            num_executors=1, input_mode=cluster.InputMode.FEED,
            restart_policy=RestartPolicy(max_restarts=1, backoff=0.1),
            checkpoint_dir=model_dir, heartbeat_interval=0.3,
            heartbeat_miss_budget=40)
        report = sup.train(backend.Partitioned.from_items(
            _linreg_items(32), 1), timeout=60)
    finally:
        pool.stop()
    assert report["restarts"] == 1
    docs = _probes(probe_dir, "supervised")
    assert len({d["pid"] for d in docs}) == 2  # both incarnations
    assert [d["forbidden"] for d in docs] == [[], []]


@pytest.mark.watchdog_timeout(120)
def test_elastic_replacement_loads_no_jax(tmp_path):
    import torch_cluster_programs as progs
    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.testing import faults

    probe_dir = str(tmp_path / "probes")
    os.makedirs(probe_dir)
    plan = faults.FaultPlan(str(tmp_path / "faults"))
    plan.preempt_node(2, grace=0.3)
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    try:
        c = cluster.run(
            pool, progs.elastic_probe,
            {"model_dir": str(tmp_path / "model"), "plan_dir": plan.plan_dir,
             "probe_dir": probe_dir, "step_sleep": 0.25, "device": "cpu"},
            num_executors=2, input_mode=cluster.InputMode.FEED,
            elastic=dict(min_nodes=1, rejoin_delay=0.5),
            heartbeat_interval=0.25, heartbeat_miss_budget=10)
        # 48 steps of 0.25 s: time for the replacement to come up.
        c.train(backend.Partitioned.from_items(_linreg_items(768), 12),
                timeout=60)
        membership = c.membership()
        c.shutdown(timeout=60)
    finally:
        pool.stop()
    assert membership["rejoins"] >= 1 and membership["world_size"] == 2
    docs = _probes(probe_dir, "elastic")
    by_node = {}
    for d in docs:
        by_node.setdefault(d["executor_id"], set()).add(d["pid"])
    assert max(len(p) for p in by_node.values()) == 2  # the replacement
    assert all(d["forbidden"] == [] for d in docs)


@pytest.mark.watchdog_timeout(120)
def test_remote_agent_and_its_executors_load_no_jax(tmp_path):
    import torch_cluster_programs as progs
    from tensorflowonspark_tpu_torch import backend, backend_remote, cluster

    pool = backend_remote.RemoteBackend(1, listen=("127.0.0.1", 0))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TPU_FRAMEWORK_AGENT_KEY"] = pool.authkey.hex()
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
    agent = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.agent",
         "--driver", "127.0.0.1:{}".format(pool.address[1]),
         "--base_dir", str(tmp_path / "agents")], env=env)
    try:
        pool.wait_for_agents(timeout=60)
        (task,), = pool.map_partitions([[0]], progs.agent_task_probe)
        c = cluster.run(pool, progs.square_feed, {"outdir": str(tmp_path)},
                        num_executors=1, input_mode=cluster.InputMode.FEED)
        out = c.inference(backend.Partitioned([[1.0, 2.0]]), timeout=60)
        c.shutdown(timeout=60)
    finally:
        pool.stop()
        agent.wait(timeout=30)
    assert out == [[1.0, 4.0]]
    assert task["pid"] == agent.pid and task["forbidden"] == []
    with open(os.path.join(tmp_path, "feed_0.json")) as f:
        child = json.load(f)
    assert child["pid"] != agent.pid and child["forbidden"] == []
