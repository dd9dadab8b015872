"""Host utilities of the port: its copy of what the port uses of
``tensorflowonspark_tpu/util.py`` (queue and backoff helpers, the host
address, executor ids, the parent-death signal)."""

import os
import queue as _queue_mod
import random as _random_mod
import socket

HOST_ENV = "TPU_FRAMEWORK_HOST"


def backoff_delay(attempt, base, cap, jitter, rng=_random_mod):
    """Exponential backoff with jitter: ``min(base * 2**attempt, cap)``
    scaled by ``1 ± jitter``, floored at 0 (the reservation client's redial
    loop). Jitter keeps a fleet from retrying in lockstep."""
    delay = min(base * (2 ** attempt), cap)
    return max(0.0, delay * (1.0 + rng.uniform(-jitter, jitter)))


def queue_put_bounded(q, item, stopped, always=False, timeout=0.2,
                      stopped_tries=25):
    """Producer-side queue put that gives up when the consumer went away.

    Returns True once ``item`` is enqueued. Ordinary items stop retrying as
    soon as ``stopped()``; ``always`` items (end sentinels, producer
    exceptions) must reach a merely slow consumer, so they keep retrying
    while live and get ``stopped_tries`` more attempts after stop: a
    consumer that vanished with a full queue must not pin the producer
    thread here forever. Used by ``train.prefetch.DevicePrefetch``.
    """
    tries = 0
    while True:
        try:
            q.put(item, timeout=timeout)
            return True
        except _queue_mod.Full:
            if not stopped():
                continue
            if not always:
                return False
            tries += 1
            if tries >= stopped_tries:
                return False


def get_ip_address():
    """The address this host advertises to the cluster.

    ``$TPU_FRAMEWORK_HOST`` when set; else the host's routable address, by
    the JAX package's (and the reference's, ``util.py:13-17``) UDP-connect
    trick: a datagram socket's ``connect`` sends no packet, the OS only
    picks the outbound interface. Loopback when no route exists.
    """
    host = os.environ.get(HOST_ENV)
    if host:
        return host
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 53))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


_EXECUTOR_ID_FILE = "executor_id"


def write_executor_id(num, working_dir=None):
    """Persist this executor's id: feeder tasks read it back to find the
    state manager the executor started at bring-up."""
    path = os.path.join(working_dir or os.getcwd(), _EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))


def read_executor_id(working_dir=None):
    """Read back the executor id written by :func:`write_executor_id`."""
    path = os.path.join(working_dir or os.getcwd(), _EXECUTOR_ID_FILE)
    with open(path) as f:
        return int(f.read())


def set_pdeathsig(sig=None):
    """Linux parent-death signal: kill this process when the thread that
    spawned it exits. ``daemon=True`` covers only the parent's clean exit
    (multiprocessing's atexit hook); a SIGKILLed parent runs no atexit, and
    its orphaned children would live on, blocked inside whatever collective
    wedged them. No-op off Linux.

    The trigger is the spawning *thread*'s exit, not the process's: call
    this only in children whose spawning thread lives as long as the parent
    process does (the main thread, or an executor's task loop).
    """
    import ctypes
    import signal

    if sig is None:
        sig = signal.SIGKILL
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, int(sig), 0, 0, 0)  # 1 = PR_SET_PDEATHSIG
    except (OSError, AttributeError):  # pragma: no cover - non-Linux
        pass
