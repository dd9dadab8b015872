"""The driver's dashboard surfaces of the port against the JAX package's.

One seeded heartbeat history (three nodes, goodput counters, SLOs,
histogram exports with exemplars, request trace summaries, profile
digests) goes into a port ``TelemetryStore`` and a JAX one on the same
fixed clock. Then:

* histogram exemplars: ``observe(..., exemplar=)``, ``hist_exemplars``
  and the ``exemplars`` entries of ``hist_export`` equal JAX's;
* ``render_dashboard`` returns the same HTML;
* the port's ``MetricsServer`` answers ``/timeseries``, ``/traces``,
  ``/profilez``, ``/dashboard``, ``/incidents`` and the
  ``tfos_cluster_*`` lines of ``/metrics`` and ``/metricz`` with the JAX
  server's bodies and content types; without a store those answer 503.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tensorflowonspark_tpu import telemetry as jax_telemetry
from tensorflowonspark_tpu import telemetry_store as jax_store
from tensorflowonspark_tpu.train import metrics as jax_metrics
from tensorflowonspark_tpu_torch import telemetry, telemetry_store
from tensorflowonspark_tpu_torch.telemetry import profiling
from tensorflowonspark_tpu_torch.train.metrics import MetricsServer

pytestmark = pytest.mark.watchdog_timeout(120)

NODES = ("node0", "node1", "serve0")
T0 = 1_800_000_000.0
FAMS = ["serve_ttft_seconds", "train_step_seconds"]
SLOS = ["serve_ttft_ms_p95 < 100", "train_steps_per_sec > 2"]


@pytest.fixture()
def fresh():
    telemetry._reset_for_tests()
    jax_telemetry._reset_for_tests()
    yield
    telemetry._reset_for_tests()
    jax_telemetry._reset_for_tests()


def _observe(rng, node, beat):
    """One beat's observations, into both packages' registries; returns
    the port's export after asserting it equals JAX's."""
    for fam in FAMS:
        for k in range(3):
            v = float(rng.lognormal(-3.0, 0.8))
            ex = {"trace": "{}-{}-{}".format(node, beat, k), "request": k}
            telemetry.observe(fam, v, exemplar=ex)
            jax_telemetry.observe(fam, v, exemplar=ex)
    for fam in FAMS:
        assert telemetry.hist_exemplars(fam) == \
            jax_telemetry.hist_exemplars(fam)
    got = telemetry.hist_export(FAMS)
    assert got == jax_telemetry.hist_export(FAMS)
    return got


def _history(seed=0, beats=24):
    """``[(node, stats, ts)]``: a seeded heartbeat history."""
    rng = np.random.RandomState(seed)
    out = []
    busy = {n: [0.0, 0.0, 0.0] for n in NODES}
    for beat in range(beats):
        for n in NODES:
            if n == "node1" and beat > beats // 2:
                continue  # node1 goes silent: stale on the dashboard
            telemetry._reset_for_tests()
            jax_telemetry._reset_for_tests()
            b = busy[n]
            b[0] += float(rng.uniform(0.5, 1.5))
            b[1] += float(rng.uniform(0.0, 0.3))
            b[2] += float(rng.uniform(0.0, 0.1))
            stats = {"step": beat * 4, "train_steps_per_sec":
                     float(rng.uniform(1.0, 4.0)),
                     "busy_step_s": b[0], "busy_wait_s": b[1],
                     "busy_ckpt_s": b[2],
                     "serve_ttft_ms_p95": float(rng.uniform(40, 180)),
                     "rss_mb": 512.0 + beat,
                     "hists": _observe(rng, n, beat)}
            if n == "serve0" and beat % 3 == 0:
                stats["traces"] = [{
                    "trace": "tr{}".format(beat), "request": beat,
                    "state": "FINISHED", "tokens": 8,
                    "total_ms": float(rng.uniform(50, 400)),
                    "ttft_ms": float(rng.uniform(10, 90)),
                    "queue_ms": float(rng.uniform(0, 20)),
                    "engine": "serve0"}]
            if beat % 5 == 0:
                stats["profile"] = {
                    "id": beat, "samples": 100 + beat,
                    "top": [["trainer.py:train_step:{}".format(beat % 3),
                             40, 60], ["queue.py:get:154", 20, 30]]}
            out.append((n, stats, T0 + beat * 2.0))
    return out


def _stores(seed=0):
    clock = [T0 + 60.0]
    port = telemetry_store.TelemetryStore(clock=lambda: clock[0])
    ref = jax_store.TelemetryStore(clock=lambda: clock[0])
    for store in (port, ref):
        store.set_slos(SLOS)
    for node, stats, ts in _history(seed):
        port.ingest(node, stats, status="alive", ts=ts)
        ref.ingest(node, stats, status="alive", ts=ts)
    for store in (port, ref):
        store.slo_monitor.evaluate(now=clock[0])
    return port, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_render_dashboard_equals_jax(fresh, seed):
    port, ref = _stores(seed)
    assert port.profiles() == ref.profiles()
    assert port.profile("node0", which="baseline") == \
        ref.profile("node0", which="baseline")
    cluster = {"node1": {"status": "dead"}, "node0": {"status": "alive"}}
    html = telemetry_store.render_dashboard(port, cluster_stats=cluster)
    assert html == jax_store.render_dashboard(ref, cluster_stats=cluster)
    for needle in ("goodput", "SLOs", "slowest requests", "node1",
                   "continuous profile"):
        assert needle in html


def _get(port, path):
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:{}{}".format(port, path), timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PATHS = ["/timeseries", "/timeseries?metric=serve_ttft_ms_p95&window=1e6",
         "/timeseries?metric=step_ms_p95&node=node0&window=1e6",
         "/timeseries?metric=rss_mb&window=bad", "/traces",
         "/traces?n=3&window=1e6", "/traces?trace=tr3",
         "/traces?trace=nope", "/traces?n=x", "/profilez?fleet=1",
         "/profilez?node=node0", "/profilez?node=nope", "/dashboard"]


def test_http_surfaces_equal_the_jax_server(fresh, tmp_path):
    port_store, ref_store = _stores()
    # An incident bundle both packages' recorders would list.
    root = tmp_path / "incidents"
    (root / "incident-1-manual").mkdir(parents=True)
    (root / "incident-1-manual" / "manifest.json").write_text(json.dumps(
        {"reason": "manual", "time": 1.0, "iso": "x",
         "nodes_captured": ["0"], "nodes_missing": []}))
    telemetry.put_status("incident_dir", str(root))
    jax_telemetry.put_status("incident_dir", str(root))
    ours = MetricsServer(store=port_store)
    theirs = jax_metrics.MetricsServer(str(tmp_path), store=ref_store)
    ours.start()
    theirs.start()
    try:
        for path in PATHS + ["/incidents"]:
            got = _get(ours.port, path)
            want = _get(theirs.port, path)
            assert got[:2] == want[:2], path
            if got[1].startswith("application/json"):
                assert json.loads(got[2]) == json.loads(want[2]), path
            else:
                assert got[2] == want[2], path
        body = json.loads(_get(ours.port, "/timeseries?metric="
                               "serve_ttft_ms_p95&window=1e6")[2])
        assert body["exemplars"]["histogram"] == "serve_ttft_seconds"

        def cluster_lines(port, path):
            text = _get(port, path)[2].decode()
            return [ln for ln in text.splitlines() if "tfos_cluster_" in ln]

        lines = cluster_lines(ours.port, "/metrics")
        assert lines and lines == cluster_lines(theirs.port, "/metrics")
        assert cluster_lines(ours.port, "/metricz") == lines
        status = json.loads(_get(ours.port, "/statusz")[2])
        assert status["cluster"]["nodes"] == port_store.nodes()
        assert len(status["cluster"]["slo"]) == len(SLOS)
    finally:
        ours.stop()
        theirs.stop()


@pytest.mark.parametrize("path,ctype", [
    ("/dashboard", "text/plain"), ("/timeseries", "application/json"),
    ("/traces", "application/json"), ("/profilez?fleet=1",
                                      "application/json"),
    ("/profilez", "text/plain")])
def test_routes_without_a_store_answer_503(fresh, path, ctype):
    server = MetricsServer()
    server.start()
    try:
        code, got, _ = _get(server.port, path)
        assert code == 503 and got.startswith(ctype)
        code, _, body = _get(server.port, "/incidents")
        assert code == 200
        assert json.loads(body) == {"incident_dir": None, "incidents": []}
    finally:
        server.stop()


def test_profilez_serves_the_live_sampler(fresh, monkeypatch):
    monkeypatch.setenv("TFOS_PROFILING_HZ", "300")
    server = MetricsServer()
    server.start()
    profiling.start()
    try:
        deadline = time.monotonic() + 10.0
        while profiling.heartbeat_digest() is None and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        code, ctype, body = _get(server.port, "/profilez")
        assert code == 200 and ctype.startswith("text/plain")
        assert profiling.parse_folded(body.decode())
        code, _, body = _get(server.port, "/profilez?json=1")
        doc = json.loads(body)
        assert code == 200 and doc["hz"] == 300.0 and doc["digest"]["top"]
    finally:
        profiling.stop()
        server.stop()
