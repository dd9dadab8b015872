"""A pytest plugin that lists, after every test, the fork-started children
of the process running it that are still alive.

A child started by ``fork`` without ``exec`` keeps every descriptor of its
parent, among them the pipes over which a pytest-xdist worker talks to its
controller. If the worker dies while such a child lives, the controller
never sees the pipe close and waits for the worker until the run's time
limit. This plugin finds the tests that leave such children:

    PYTHONPATH=scripts python -m pytest tests/ -n 6 -p torch_fork_scan

Each worker appends one JSON line a test, while any such child lives, to
``fork_scan_<worker>.jsonl`` in ``$FORK_SCAN_DIR`` (default: the current
directory): ``{"test": ..., "new": [pids the test left], "alive": {pid:
the test that left it}}``. A child is recognised by a command line equal
to its parent's, which ``fork`` keeps and ``exec`` replaces.
"""

import json
import os

import psutil
import pytest

_me = psutil.Process()
_cmd = _me.cmdline()
_seen = {}


def _forked():
    out = []
    for child in _me.children(recursive=True):
        try:
            if child.cmdline() == _cmd:
                out.append(child.pid)
        except psutil.Error:
            pass
    return out


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    yield
    alive = _forked()
    if not alive:
        return
    new = [pid for pid in alive if pid not in _seen]
    for pid in new:
        _seen[pid] = item.nodeid
    path = os.path.join(os.environ.get("FORK_SCAN_DIR", "."),
                        "fork_scan_{}.jsonl".format(
                            os.environ.get("PYTEST_XDIST_WORKER", "main")))
    with open(path, "a") as f:
        f.write(json.dumps({"test": item.nodeid, "new": new,
                            "alive": {str(p): _seen[p] for p in alive}})
                + "\n")
