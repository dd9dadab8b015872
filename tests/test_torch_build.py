"""The kernel build across processes (``ops/_build.py``), with a stub
compiler: two processes that build one checkout at once compile each
source once, under the file lock, and neither can see a library before
its compiler has finished writing it (the compiler writes a temporary
name, renamed into place)."""

import json
import multiprocessing
import os
import stat
import sys
import time

import pytest

from tensorflowonspark_tpu_torch.ops import _build

pytestmark = pytest.mark.watchdog_timeout(120)

_STUB = r'''#!{python}
import json, os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
log = os.environ["STUB_LOG"]
with open(log, "a") as f:
    f.write(json.dumps({{"pid": os.getpid(), "event": "start",
                        "src": sys.argv[-1], "t": time.time()}}) + "\n")
with open(out, "w") as f:          # written slowly, in two halves
    f.write("half-")
    f.flush()
    time.sleep(0.4)
    f.write("done")
with open(log, "a") as f:
    f.write(json.dumps({{"pid": os.getpid(), "event": "end",
                        "src": sys.argv[-1], "t": time.time()}}) + "\n")
'''


def _racer(root, csrc, stub, conn):
    _build.BUILD_ROOT = root
    _build.CSRC_DIR = csrc
    _build._nvcc = lambda: stub
    libs = _build.build_all()
    conn.send({name: open(path).read() for name, path in libs.items()})


def test_two_processes_build_each_source_once(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / (name + ".cu")).write_text("// " + name)
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("STUB_LOG", str(log))
    ctx = multiprocessing.get_context("spawn")
    pipes, procs = [], []
    for _ in range(2):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_racer, args=(
            str(tmp_path / "build"), str(csrc), str(stub), send))
        p.start()
        pipes.append(recv)
        procs.append(p)
    got = [r.recv() for r in pipes]
    for p in procs:
        p.join(30)
        assert p.exitcode == 0
    # Both processes load complete libraries only.
    assert got == [{"alpha": "half-done", "beta": "half-done"}] * 2
    events = [json.loads(line) for line in log.read_text().splitlines()]
    starts = [e for e in events if e["event"] == "start"]
    # One compile per source, both from one process.
    assert sorted(os.path.basename(e["src"]) for e in starts) == [
        "alpha.cu", "beta.cu"]
    assert len(events) == 4  # two compiler runs, each started and ended
    build_dirs = os.listdir(tmp_path / "build")
    assert _build.LOCK_NAME in build_dirs
    (out_dir,) = [d for d in build_dirs if d != _build.LOCK_NAME]
    assert sorted(os.listdir(tmp_path / "build" / out_dir)) == [
        "libalpha.so", "libbeta.so"]  # no temporary left behind


def test_the_lock_serializes_holders(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    order = []
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    with _build._build_lock():
        p = ctx.Process(target=_hold_then_report, args=(str(tmp_path), send))
        p.start()
        time.sleep(0.5)
        order.append(("parent", time.time()))
    child_t = recv.recv()
    p.join(30)
    assert child_t >= order[0][1]  # the child got the lock after release


def _hold_then_report(root, conn):
    _build.BUILD_ROOT = root
    with _build._build_lock():
        conn.send(time.time())
