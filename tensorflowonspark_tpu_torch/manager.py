"""Per-executor shared state: KV store + named blocking queues.

Capability parity with the reference's ``TFManager``
(``tensorflowonspark/TFManager.py``): each executor hosts a
``multiprocessing`` manager process exposing

* a small key/value store (``state``, ``'terminating'``/``'stopped'`` flags,
  remote tracebacks), and
* named ``JoinableQueue`` s (``input``/``output``/``error``/``control``) that
  connect the feeder task, the compute child process, and — for ``remote``
  managers — the driver.

``remote`` mode binds a TCP port reachable from other hosts (the reference
needed this so the driver could stop busy PS executors,
``TFCluster.py:163-172``; we need it so the driver can stop busy background
nodes); ``local`` mode binds loopback only.

Design note: the reference returned raw manager proxies and relied on
``str(proxy)`` coercion for KV reads (``TFSparkNode.py:383``). We instead
return a :class:`Handle` whose ``get``/``set`` are *method calls on* a KV
proxy — method results cross the wire as plain values, so no coercion hacks.
"""

import logging
import multiprocessing
import threading
from multiprocessing.managers import BaseManager

logger = logging.getLogger(__name__)


class _KVStore:
    """Process-safe KV used for node lifecycle state."""

    def __init__(self):
        self._data = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def set(self, key, value):
        with self._lock:
            self._data[key] = value

    def pop(self, key):
        """Remove and return a key (None when absent). Consume-once
        semantics for one-shot evidence: the incident layer pops a
        crashed child's ``crash_snapshot`` so a later incident in a
        relaunched job cannot re-attach the stale one."""
        with self._lock:
            return self._data.pop(key, None)


class StateManager(BaseManager):
    """Per-executor manager; typeids registered in :func:`start`/:func:`connect`."""


_KV_EXPOSED = ["get", "set", "pop"]


class Handle:
    """Connected view of an executor's state manager.

    Picklable-by-reconnection: crossing a process boundary re-dials the
    manager address with the shared authkey (this is how feeder tasks reach
    the manager their executor started earlier).
    """

    def __init__(self, mgr, address, authkey):
        self._mgr = mgr
        self._kv = mgr.kv()
        self.address = address
        self.authkey = authkey

    def get_queue(self, name):
        return self._mgr.get_queue(name)

    def get(self, key):
        return self._kv.get(key)

    def set(self, key, value):
        self._kv.set(key, value)

    def pop(self, key):
        return self._kv.pop(key)

    def shutdown(self):
        self._mgr.shutdown()

    def __reduce__(self):
        return (connect, (self.address, self.authkey))


# Backpressure bound on the feed queue: the reference's queues were
# unbounded, so a feeder that outran (or outlived) its consumer grew the
# manager process without limit — and a dead consumer was only discovered
# at join time. A bounded "input" queue turns both into a blocking put the
# feeder can observe (node._put_checked polls the error state there).
DEFAULT_INPUT_MAXSIZE = 256


def start(authkey, queue_names, mode="local",
          input_maxsize=DEFAULT_INPUT_MAXSIZE):
    """Launch this executor's manager process and return a :class:`Handle`.

    ``authkey`` are raw bytes shared with every process allowed to connect
    (the reference used a ``uuid4`` per cluster, ``TFSparkNode.py:174``).
    ``input_maxsize`` bounds the queue named ``"input"`` (0 = unbounded);
    other queues stay unbounded — bounding ``output`` too would deadlock
    inference (feeder drains outputs only after all inputs are queued).
    """
    assert isinstance(authkey, bytes)
    queues = {
        name: multiprocessing.JoinableQueue(
            input_maxsize if name == "input" else 0
        )
        for name in queue_names
    }
    kv = _KVStore()

    StateManager.register("get_queue", callable=lambda name: queues[name])
    StateManager.register("kv", callable=lambda: kv, exposed=_KV_EXPOSED)

    address = ("", 0) if mode == "remote" else ("127.0.0.1", 0)
    # fork context: the registered callables close over this process's queue
    # objects, which cannot cross a spawn boundary. The manager child only
    # serves sockets/queues, so forking is safe even inside spawn-created
    # executors (as long as CUDA was not initialised first — see node.py).
    mgr = StateManager(
        address=address, authkey=authkey, ctx=multiprocessing.get_context("fork")
    )
    mgr.start()
    logger.info("started %s state manager at %s", mode, mgr.address)
    return Handle(mgr, mgr.address, authkey)


def connect(address, authkey):
    """Connect to a manager started elsewhere (reference ``TFManager.py:68-83``)."""
    assert isinstance(authkey, bytes)
    # The connecting process must share the authkey or proxy pickling fails.
    multiprocessing.current_process().authkey = authkey
    StateManager.register("get_queue")
    StateManager.register("kv", exposed=_KV_EXPOSED)
    mgr = StateManager(address=tuple(address), authkey=authkey)
    mgr.connect()
    return Handle(mgr, tuple(address), authkey)
