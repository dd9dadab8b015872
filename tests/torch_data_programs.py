"""Decode functions and transforms for the port's data-tier tests, and the
checks that a pool left nothing behind.

The port's decode pools start workers by forkserver, so a decode function
crosses to a worker by pickle and the worker imports its module. They live
in this module, which imports only numpy and the standard library: a
function defined in a test module would make every worker import that
module, and with it JAX.
"""

import glob
import os
import time

import numpy as np


def square(payload):
    return [x * x for x in payload]


def explode_on_seven(payload):
    if 7 in payload:
        raise ValueError("record seven is cursed")
    return payload


def decode_columnar(payload):
    """A columnar-batch-shaped result: a dict of arrays with inline extras,
    the shape the shared-memory transport must carry."""
    i = payload[0]
    return {
        "image": np.full((8, 16, 16, 3), i, np.float32),
        "label": np.arange(8, dtype=np.int64) + i,
        "names": ["rec-%d-%d" % (i, j) for j in range(8)],  # stays inline
        "nested": {"mask": np.ones((8,), bool)},
    }


def double(arr):
    return arr * 2


def scale_v(batch):
    """An ``InputPipeline`` transform: every column kept, ``v`` doubled."""
    out = dict(batch)
    out["v"] = batch["v"] * 2.0
    return out


def fail_on_label_13(batch):
    if 13 in batch["label"][batch["mask"]]:
        raise ValueError("label thirteen does not transform")
    return batch


class BaseIndexTag:
    """A transform that consumes the ``_base_index`` hint: a column holding
    each row's global record index."""

    wants_base_index = True

    def __call__(self, batch):
        base = batch.pop("_base_index")
        out = dict(batch)
        out["index"] = base + np.arange(len(batch["mask"]), dtype=np.int64)
        return out


def feed_rows(batch):
    """A FEED-mode decode: raw rows (lists of ints) to one int64 array, each
    value squared."""
    return np.asarray(batch, np.int64) ** 2


def feed_rows_fail_on(batch):
    if any(int(np.sum(r)) == 13 for r in batch):
        raise ValueError("row thirteen does not decode")
    return feed_rows(batch)


def helpers():
    """Pids of this process's multiprocessing helpers (the forkserver and
    the resource tracker), which outlive any one pool by design."""
    out = set()
    try:
        from multiprocessing import forkserver

        pid = forkserver._forkserver._forkserver_pid
        if pid:
            out.add(pid)
    except Exception:  # noqa: BLE001 - no forkserver started
        pass
    try:
        from multiprocessing import resource_tracker

        pid = resource_tracker._resource_tracker._pid
        if pid:
            out.add(pid)
    except Exception:  # noqa: BLE001
        pass
    return out


def live_children():
    """Live descendants of this process other than the helpers."""
    import psutil

    me = psutil.Process()
    out = set()
    for child in me.children(recursive=True):
        try:
            if child.status() != psutil.STATUS_ZOMBIE:
                out.add(child.pid)
        except psutil.Error:
            pass
    return out - helpers()


def shm_segments():
    """This process's decode-pool shared-memory segments in /dev/shm."""
    return sorted(glob.glob("/dev/shm/tfos{}p*".format(os.getpid())))


def wait_no_new_children(before, timeout=5.0):
    """The descendants not in ``before`` still alive after ``timeout``
    seconds (an empty set once every pool process has exited)."""
    deadline = time.monotonic() + timeout
    while True:
        left = live_children() - set(before)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def start_method(pool):
    return pool._ctx.get_start_method()


def owner_dies_with_a_pool(out_path):
    """Run in a child interpreter: start a pool, write its worker pids to
    ``out_path`` and die without closing it."""
    from tensorflowonspark_tpu_torch.data import decode_pool

    pool = decode_pool.DecodePool(abs, workers=2)
    assert list(pool.imap([-1, -2, 3])) == [1, 2, 3]
    with open(out_path, "w") as f:
        f.write(" ".join(str(p) for p in pool.worker_pids()))
    os._exit(0)

