"""Incident capture of the port (``incident.py``, the node's ``SNAP``
answer, ``scripts/torch_incident_report.py``) against the JAX package's.

* Parity: the same ``local_capture`` writes a bundle with the JAX
  manifest's keys and the JAX layout; an ``IncidentRecorder`` over the same
  span export writes the same ``trace.json`` events (the seeded nodes'
  rows equal; each package's own ``cluster/incident`` marker with the
  same keys).
* The SLO-to-bundle wiring: a breach fires ``recorder.trigger``; the test
  waits on the recorder's capture thread (``join``), not on a clock.
* A node's ``SNAP`` answer in process: a reservation server, a
  ``HeartbeatSender`` beating for a fake manager, a capture with a
  profile window; the snapshot reaches the bundle and the manager KV; a
  running profiler session leaves the snapshot without a trace instead of
  failing it.
* The rate limit, the rollback of a failed write, ``register_sigusr2``
  and ``dump_stacks``; the report CLI on both packages' bundles.
* One cluster: two FILES-mode executors beating every 0.5 s, captured
  live (no crash): both answer ``SNAP`` with their ring, stacks, folded
  stacks and a ``torch.profiler`` window.
"""

import json
import os
import shutil
import sys
import time

import pytest

import torch_cluster_programs as progs
from tensorflowonspark_tpu import incident as jax_incident
from tensorflowonspark_tpu import telemetry as jax_telemetry
from tensorflowonspark_tpu_torch import (backend, cluster, incident, node,
                                         reservation, telemetry,
                                         telemetry_store)
from tensorflowonspark_tpu_torch.telemetry import profiling
from tensorflowonspark_tpu_torch.train import profiler

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_incident_report  # noqa: E402

pytestmark = pytest.mark.watchdog_timeout(120)

MANIFEST_KEYS = ["attrs", "driver_pid", "iso", "nodes_captured",
                 "nodes_missing", "reason", "time"]


@pytest.fixture()
def fresh(monkeypatch):
    monkeypatch.setenv("TFOS_PROFILING", "0")
    telemetry._reset_for_tests()
    jax_telemetry._reset_for_tests()
    yield
    telemetry._reset_for_tests()
    jax_telemetry._reset_for_tests()


def _drop_window(run_dir):
    """Remove a profile window's temporary root (``<root>/plugins/profile/
    <run>``): it stays on the node, outside the bundle."""
    shutil.rmtree(os.path.dirname(os.path.dirname(os.path.dirname(
        run_dir))), ignore_errors=True)


def _layout(bundle):
    out = []
    for dirpath, _, names in os.walk(bundle):
        rel = os.path.relpath(dirpath, bundle)
        out += [os.path.normpath(os.path.join(rel, n)) for n in names]
    return sorted(out)


def _seed_spans(path):
    """Two nodes' span export: a crash, a relaunch and a resume."""
    docs = []
    for i, (node, name, ts, dur, attrs) in enumerate([
            ("node0", "rendezvous/register", 100.0, 0.02,
             {"executor_id": 0}),
            ("node0", "train/step", 101.0, 0.5, {"step": 1}),
            ("node0", "node/error", 101.6, 0.0,
             {"executor_id": 0, "error": "boom"}),
            ("node1", "train/step", 101.2, 0.4, {"step": 1}),
            ("node1", "train/resume", 103.0, 0.0, {"step": 1})]):
        docs.append({"node": node, "name": name, "ts": ts, "dur": dur,
                     "trace": "t" + node, "span": i + 1, "tid": "main",
                     "attrs": attrs})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "seed.jsonl"), "w") as f:
        for d in docs:
            f.write(json.dumps(d) + "\n")


def test_local_capture_bundle_matches_jax(fresh, tmp_path):
    ours = incident.local_capture("hiccup", root=str(tmp_path / "a"),
                                  min_interval=0.0, step=3, note="x")
    theirs = jax_incident.local_capture("hiccup", root=str(tmp_path / "b"),
                                        min_interval=0.0, step=3, note="x")
    docs = []
    for bundle in (ours, theirs):
        with open(os.path.join(bundle, "manifest.json")) as f:
            docs.append(json.load(f))
    assert sorted(docs[0]) == sorted(docs[1]) == MANIFEST_KEYS
    for key in ("reason", "attrs", "nodes_captured", "nodes_missing"):
        assert docs[0][key] == docs[1][key]
    assert _layout(ours) == _layout(theirs)
    # Without a root, an event only (rate-limited), as JAX's.
    assert incident.local_capture("x", min_interval=0.0) is None


def test_recorder_trace_json_matches_jax(fresh, tmp_path):
    trace_docs = []
    for pkg_tel, pkg_inc, name in ((telemetry, incident, "port"),
                                   (jax_telemetry, jax_incident, "jax")):
        tdir = str(tmp_path / name / "telemetry")
        _seed_spans(tdir)
        pkg_tel.configure(node_id="driver", export_dir=tdir)
        rec = pkg_inc.IncidentRecorder(str(tmp_path / name / "inc"),
                                       telemetry_dir=tdir, min_interval=0.0)
        bundle = rec.capture("node_death", nodes="0")
        pkg_tel.disable()
        with open(os.path.join(bundle, "trace.json")) as f:
            trace_docs.append(json.load(f))
        with open(os.path.join(bundle, "timeline.txt")) as f:
            assert "node/error" in f.read()
        assert rec.captures == [bundle]
    events = []
    for doc in trace_docs:
        driver = [e["pid"] for e in doc["traceEvents"] if e["ph"] == "M"
                  and e["args"]["name"] == "node driver"]
        events.append(([e for e in doc["traceEvents"]
                        if e["pid"] not in driver],
                       [e for e in doc["traceEvents"]
                        if e["name"] == "cluster/incident"]))
    assert events[0][0] == events[1][0] and len(events[0][0]) == 7
    (mine,), (ref,) = events[0][1], events[1][1]
    assert sorted(mine["args"]) == sorted(ref["args"])
    assert mine["args"]["reason"] == "node_death"


def test_slo_breach_writes_a_bundle_with_the_marker(fresh, tmp_path):
    """The breach's capture thread is joined: no wall-clock deadline."""
    tdir = str(tmp_path / "telemetry")
    telemetry.configure(node_id="driver", export_dir=tdir)
    store = telemetry_store.TelemetryStore()
    rec = incident.IncidentRecorder(str(tmp_path / "inc"),
                                    telemetry_dir=tdir, min_interval=0.0)
    monitor = store.set_slos(["serve_ttft_ms_p95 < 100"], recorder=rec)
    now = time.time()
    for i in range(75):
        store.ingest("serve0", {"serve_ttft_ms_p95": 450.0},
                     ts=now - 370.0 + i * 5.0)
    monitor.evaluate(now=now)
    assert any(s["firing"] for s in monitor.status())
    (bundle,) = rec.join(timeout=60.0)
    assert "slo_breach" in os.path.basename(bundle)
    with open(os.path.join(bundle, "manifest.json")) as f:
        assert json.load(f)["reason"] == "slo_breach"
    with open(os.path.join(bundle, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"cluster/slo_breach", "cluster/incident"} <= names
    assert rec.join() == [bundle]


def test_node_snapshot_and_stack_dumps(fresh, monkeypatch):
    monkeypatch.setenv("TFOS_PROFILING", "1")
    monkeypatch.setenv("TFOS_PROFILING_HZ", "300")
    telemetry.configure(node_id="nodeX")
    with telemetry.span("train/step", step=1):
        pass
    deadline = time.monotonic() + 10.0
    while profiling.window_export() is None or not profiling.window_export(
            )["folded"]:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    snap = incident.node_snapshot(ring_limit=10)
    assert snap["node"] == "nodeX" and snap["pid"] == os.getpid()
    assert [s["name"] for s in snap["ring"]] == ["train/step"]
    assert "Thread" in snap["stacks"] and "stats" in snap
    assert snap["profile"]["folded"] and "profile_dir" not in snap
    assert incident.register_sigusr2() is True
    assert "test_node_snapshot_and_stack_dumps" in incident.dump_stacks()


def test_rate_limit_and_a_failed_write_releases_the_slot(fresh, tmp_path):
    root = str(tmp_path / "inc")
    rec = incident.IncidentRecorder(root, min_interval=300.0)
    first = rec.capture("a")
    assert first is not None and rec.capture("b") is None
    assert telemetry.get_counter("incident_captures_suppressed_total") == 1
    # A second recorder on the same root shares the limiter.
    assert incident.IncidentRecorder(root, min_interval=300.0).capture(
        "c") is None
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the root should be")
    bad = incident.IncidentRecorder(str(blocked), min_interval=300.0)
    with pytest.raises(OSError):
        bad.capture("x")
    blocked.unlink()
    assert bad.capture("y") is not None


class _KV:
    """The manager surface a ``HeartbeatSender`` uses."""

    def __init__(self):
        self.kv = {"state": "running"}

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        self.kv[key] = value


def _beating(tmp_path):
    # A loaded host can hold a beat past a short miss budget: a node the
    # server calls dead is not asked.
    server = reservation.Server(1, heartbeat_interval=0.2,
                                heartbeat_miss_budget=100)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "127.0.0.1",
                     "job_name": "worker", "task_index": 0})
    client.close()
    mgr = _KV()
    sender = node.HeartbeatSender(addr, 0, mgr, interval=0.2).start()
    deadline = time.monotonic() + 30.0
    while server.liveness.snapshot().get(0, {}).get("status") != "alive":
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return server, sender, mgr


@pytest.mark.parametrize("busy", [False, True],
                         ids=["profiled", "profiler_busy"])
def test_snap_answer_reaches_the_bundle_and_the_kv(fresh, monkeypatch,
                                                   tmp_path, busy):
    monkeypatch.setenv("TFOS_PROFILING", "1")
    telemetry.configure(node_id="node0")
    server, sender, mgr = _beating(tmp_path)
    rec = incident.IncidentRecorder(str(tmp_path / "inc"), server=server,
                                    min_interval=0.0, profile_secs=0.3)
    assert rec.node_timeout == pytest.approx(2 * 0.2 + 1.0)
    rec.node_timeout = 60.0  # the round ends once the node answered
    try:
        if busy:
            with profiler.trace(str(tmp_path / "held")):
                bundle = rec.capture("manual")
        else:
            bundle = rec.capture("manual")
    finally:
        sender.stop()
        server.stop()
    with open(os.path.join(bundle, "manifest.json")) as f:
        man = json.load(f)
    assert man["nodes_captured"] == ["0"] and man["nodes_missing"] == []
    with open(os.path.join(bundle, "nodes", "node0.json")) as f:
        snap = json.load(f)
    assert "via" not in snap and snap["pid"] == os.getpid()
    assert mgr.kv["node_snapshot"]["pid"] == os.getpid()
    assert mgr.kv["node_snapshot"]["capture"]
    assert os.path.isfile(os.path.join(bundle, "profiles", "node0.folded"))
    if busy:
        assert "profile_dir" not in snap
    else:
        assert profiler.trace_files(snap["profile_dir"])
        _drop_window(snap["profile_dir"])


def test_report_cli_renders_both_packages_bundles(fresh, tmp_path, capsys):
    ours = incident.local_capture("manual", root=str(tmp_path / "a"),
                                  min_interval=0.0)
    theirs = jax_incident.local_capture("manual", root=str(tmp_path / "b"),
                                        min_interval=0.0)
    for bundle in (ours, theirs):
        text = torch_incident_report.render(bundle, with_stacks=True)
        assert "reason:   manual" in text and "--- driver.txt ---" in text
        assert os.path.isfile(os.path.join(bundle, "report.txt"))
    assert torch_incident_report.main([str(tmp_path / "a"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["nodes"] == ["driver"]
    assert torch_incident_report.main([str(tmp_path / "none")]) == 1


def test_two_executors_answer_a_live_capture(fresh, monkeypatch, tmp_path):
    monkeypatch.delenv("TFOS_PROFILING")
    stop = str(tmp_path / "stop")
    tdir = str(tmp_path / "telemetry")
    # The driver's spans (the incident marker) join the nodes' export.
    telemetry.configure(node_id="driver", export_dir=tdir)
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    try:
        c = cluster.run(pool, progs.busy_files, {"stop": stop},
                        num_executors=2, input_mode=cluster.InputMode.FILES,
                        reservation_timeout=60, heartbeat_interval=0.5,
                        heartbeat_miss_budget=40, telemetry_dir=tdir,
                        incident_dir=str(tmp_path / "inc"))
        try:
            deadline = time.monotonic() + 60.0
            while not all(r.get("status") == "alive" and r.get("beats", 0)
                          >= 2 for r in c.liveness.snapshot().values()):
                assert time.monotonic() < deadline, c.liveness.snapshot()
                time.sleep(0.05)
            c.incidents.profile_secs = 0.5
            # The round ends once both answered; the budget only bounds a
            # loaded host's first profiler session.
            c.incidents.node_timeout = 60.0
            bundle = c.capture_incident("manual")
        finally:
            open(stop, "w").close()
            c.shutdown(timeout=60)
    finally:
        pool.stop()
    with open(os.path.join(bundle, "manifest.json")) as f:
        man = json.load(f)
    assert man["nodes_captured"] == ["0", "1"] and man["nodes_missing"] == []
    for eid in (0, 1):
        with open(os.path.join(bundle, "nodes",
                               "node{}.json".format(eid))) as f:
            snap = json.load(f)
        assert "via" not in snap and snap["node"] == "node{}-exec".format(
            eid)
        assert profiler.trace_files(snap["profile_dir"])
        _drop_window(snap["profile_dir"])
        with open(os.path.join(bundle, "rings",
                               "node{}.jsonl".format(eid))) as f:
            ring = [json.loads(line) for line in f]
        assert any(s["name"] == "train/step" for s in ring)
        assert os.path.isfile(os.path.join(
            bundle, "profiles", "node{}.folded".format(eid)))
        with open(os.path.join(bundle, "stacks",
                               "node{}.txt".format(eid))) as f:
            assert "busy_files" in f.read()
    with open(os.path.join(bundle, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"cluster/incident", "rendezvous/register", "train/step"} <= names
    assert "captured: 0, 1" in torch_incident_report.render(bundle)
