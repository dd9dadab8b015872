"""The port's continuous sampling profiler (``telemetry/profiling.py``) and
its ``torch.profiler`` capture (``train/profiler.py``).

* Parity: ``folded_text``, ``parse_folded``, ``frame_counts``, ``digest``,
  ``profile_diff``, ``flame_svg`` and ``render_flame_html`` of the port
  equal the JAX package's on the same seeded synthetic stacks (stdlib
  code: equal, not close).
* The sampler: windows, rotation, the overflow bucket, the duty cycle,
  the heartbeat digest and the incident window export.
* ``train/profiler.py``: ``trace`` writes a Chrome trace under
  ``plugins/profile/<run>/`` holding the annotated range; a second
  session in the process is refused (``trace`` raises, ``window``
  returns None); ``window`` records the other threads' operators;
  ``start_server`` registers ``profiler_port`` and serves ``GET /trace``.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.telemetry import profiling as jax_profiling
from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.telemetry import profiling
from tensorflowonspark_tpu_torch.train import profiler

pytestmark = pytest.mark.watchdog_timeout(120)

FRAMES = ["trainer.py:train_step:10", "model.py:forward:40",
          "attention.py:flash:12", "feed.py:next_batch:77",
          "queue.py:get:154", "threading.py:wait:300",
          "checkpoint.py:save:90", "ops.py:matmul:5"]


def _stacks(seed, n=40):
    """Seeded collapsed stacks: ``thread:<name>;frame;...`` -> count."""
    rng = np.random.RandomState(seed)
    out = {}
    for _ in range(n):
        depth = int(rng.randint(1, 6))
        frames = [FRAMES[i] for i in rng.randint(0, len(FRAMES), depth)]
        key = ";".join(["thread:" + ("main" if rng.rand() < 0.7
                                     else "feeder")] + frames)
        out[key] = out.get(key, 0) + int(rng.randint(1, 30))
    return out


def _window(seed):
    stacks = _stacks(seed)
    return {"id": seed, "t0": 100.0 + seed, "t1": 130.0 + seed,
            "samples": sum(stacks.values()), "dropped": 0,
            "stacks": stacks, "threads": {}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_text_and_parse_equal_jax(seed):
    win = _window(seed)
    for limit in (None, 5):
        text = profiling.folded_text(win, limit=limit)
        assert text == jax_profiling.folded_text(win, limit=limit)
    text = profiling.folded_text(win)
    assert profiling.parse_folded(text) == win["stacks"]
    assert profiling.parse_folded(text + "\nbad line\n\n") == \
        jax_profiling.parse_folded(text + "\nbad line\n\n")
    assert profiling.frame_counts(win) == jax_profiling.frame_counts(win)


@pytest.mark.parametrize("seed,top", [(0, 15), (3, 4), (5, 1)])
def test_digest_equals_jax(seed, top):
    win = _window(seed)
    got = profiling.digest(win, top=top)
    assert got == jax_profiling.digest(win, top=top)
    assert len(got["top"]) <= top and got["samples"] == win["samples"]
    # A digest passes through (re-trimmed), as JAX's does.
    assert profiling.digest(got, top=2) == jax_profiling.digest(got, top=2)


@pytest.mark.parametrize("a,b", [(0, 1), (2, 7), (4, 4)])
def test_profile_diff_equals_jax(a, b):
    wa, wb = _window(a), _window(b)
    for x, y in ((wa, wb), (profiling.digest(wa), profiling.digest(wb)),
                 (wa["stacks"], profiling.digest(wb))):
        got = profiling.profile_diff(x, y, top=6)
        assert got == jax_profiling.profile_diff(x, y, top=6)
    same = profiling.profile_diff(wa, wa)
    assert same["top_frame"] is None
    assert same["text"] == "no frame grew between the two windows"


def test_flame_rendering_equals_jax():
    win = _window(6)
    diff = profiling.profile_diff(_window(5), win)
    assert profiling.flame_svg(win) == jax_profiling.flame_svg(win)
    assert profiling.flame_svg({}) == ""
    html = profiling.render_flame_html(win, title="t", diff=diff)
    assert html == jax_profiling.render_flame_html(win, title="t", diff=diff)
    assert "<svg" in html and "flame diff" in html


def _spin(stop):
    x = 0
    while not stop.is_set():
        x = (x + 1) % 1000003


def test_sampler_windows_rotation_and_digest():
    stop = threading.Event()
    worker = threading.Thread(target=_spin, args=(stop,), name="spinner")
    worker.start()
    s = profiling.Sampler(hz=400, window_s=0.15).start()
    try:
        deadline = time.monotonic() + 20.0
        while s.window("baseline") is None and time.monotonic() < deadline:
            time.sleep(0.02)
        base = s.window("baseline")
        assert base is not None and base["samples"] >= 1
        assert base["t1"] >= base["t0"]
        best = s.best_window()
        assert best["samples"] >= 1
        # Rooted at the thread name, leaf last; the sampler skips itself.
        assert any(k.startswith("thread:spinner;") and "_spin" in k
                   for k in best["stacks"])
        assert not any("tfos-profiling-sampler" in k for k in best["stacks"])
        assert 0.0 < s.duty_cycle() < 1.0
        assert s.samples >= base["samples"]
    finally:
        s.stop()
        stop.set()
        worker.join()
    assert not s.running()


def test_sampler_bounds_stacks_with_an_overflow_bucket():
    s = profiling.Sampler(max_stacks=1)
    s._sample(threading.get_ident())
    s._sample(threading.get_ident())
    win = s.window("current")
    assert len(win["stacks"]) <= 2
    if win["dropped"]:
        assert win["stacks"][profiling.OVERFLOW_KEY] == win["dropped"]


def test_module_sampler_heartbeat_digest_and_window_export(monkeypatch):
    telemetry._reset_for_tests()
    monkeypatch.setenv("TFOS_PROFILING_HZ", "300")
    monkeypatch.setenv("TFOS_PROFILING", "0")
    assert profiling.maybe_start_from_env() is None
    assert profiling.heartbeat_digest() is None
    assert profiling.window_export() is None
    monkeypatch.setenv("TFOS_PROFILING", "1")
    s = profiling.maybe_start_from_env()
    try:
        assert profiling.running() and profiling.start() is s
        deadline = time.monotonic() + 10.0
        while profiling.heartbeat_digest() is None and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        dig = profiling.heartbeat_digest()
        assert dig["samples"] >= 1 and dig["top"]
        exp = profiling.window_export(limit=3)
        assert len(exp["folded"].splitlines()) <= 3
        assert exp["hz"] == 300.0 and exp["digest"]["top"]
        assert profiling.parse_folded(exp["folded"])
    finally:
        profiling.stop()
    assert not profiling.running()
    telemetry._reset_for_tests()


# -- torch.profiler capture ---------------------------------------------------


def _trace_names(run_dir):
    names = {}
    for path in profiler.trace_files(run_dir):
        with open(path) as f:
            for ev in json.load(f)["traceEvents"]:
                names[ev.get("name")] = names.get(ev.get("name"), 0) + 1
    return names


def test_trace_writes_a_chrome_trace_and_refuses_a_second_session(tmp_path):
    a = torch.randn(32, 32)
    with profiler.trace(str(tmp_path), create_perfetto_trace=True) as run:
        with profiler.annotate("feed-wait"):
            a @ a
        with pytest.raises(RuntimeError, match="already running"):
            with profiler.trace(str(tmp_path / "other")):
                pass
        assert profiler.window(0.05) is None
    assert os.path.dirname(run) == str(tmp_path / "plugins" / "profile")
    assert "perfetto_trace.json.gz" in os.listdir(run)
    assert len(profiler.trace_files(run)) == 1
    names = _trace_names(run)
    assert names.get("feed-wait") == 1 and names.get("aten::mm", 0) >= 1
    assert profiler.kernel_names(run) == {}   # no card on this host
    assert profiler.window(0) is None


def test_window_records_the_other_threads_operators():
    stop = threading.Event()

    def work():
        x = torch.randn(64, 64)
        while not stop.is_set():
            x = torch.tanh(x @ x)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        run = profiler.window(0.3)
    finally:
        stop.set()
        worker.join()
    names = _trace_names(run)
    assert names.get("aten::tanh", 0) >= 1 and names.get("aten::mm", 0) >= 1


def test_start_server_registers_the_port_and_serves_a_window():
    telemetry._reset_for_tests()
    first = profiler.start_server(port=21987, tries=8)
    second = profiler.start_server(port=first.port, tries=8)
    try:
        assert second.port != first.port
        assert telemetry.get_gauge("profiler_port") == second.port
        assert telemetry.node_stats()["profiler_port"] == second.port
        url = "http://127.0.0.1:{}/trace?secs=0.1".format(first.port)
        with urllib.request.urlopen(url, timeout=60) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            doc = json.loads(resp.read())
        assert "traceEvents" in doc
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen("http://127.0.0.1:{}/x".format(
                first.port), timeout=10)
        assert err.value.code == 404
    finally:
        second.stop()
        first.stop()
        profiling.stop()
    assert telemetry.get_gauge("profiler_port") is None
    telemetry._reset_for_tests()
