"""The port's ``DataFeed`` against the JAX package's.

The same items and sentinels (``EndPartition`` inside and between batches,
the ``None`` end of feed inside a partial batch) go through both feeds, and
every call returns the same arrays, dtypes and masks: ``next_batch``,
``next_batch_arrays`` with and without ``pad_to_full`` (the typed empty
batch included), column mapping, and the single-process ``sync_batches``.
Queues are in-process for speed, plus one pass through the port's real
manager process. The paths and sentinel copies are checked beside them.
``decoded_batches`` yields the JAX feed's decoded batches (the JAX one
inline: its pool forks), in feed order with the short trailing batch, on
the port's two-worker pool too; a ``DecodeError`` closes the pool, leaves
no child behind and fails the node program in a real FEED cluster.
"""

import json
import os
import queue

import numpy as np
import pytest

import torch_cluster_programs as cluster_progs
import torch_data_programs as progs
from tensorflowonspark_tpu import feed as jax_feed
from tensorflowonspark_tpu import marker as jax_marker
from tensorflowonspark_tpu import paths as jax_paths
from tensorflowonspark_tpu_torch import backend, cluster
from tensorflowonspark_tpu_torch import feed as port_feed
from tensorflowonspark_tpu_torch import manager as port_manager
from tensorflowonspark_tpu_torch import marker as port_marker
from tensorflowonspark_tpu_torch import paths as port_paths

pytestmark = pytest.mark.watchdog_timeout(120)


class _Mgr:
    """In-process stand-in for a state manager handle."""

    def __init__(self):
        self._queues = {}
        self._kv = {}

    def get_queue(self, name):
        return self._queues.setdefault(name, queue.Queue())

    def get(self, key):
        return self._kv.get(key)

    def set(self, key, value):
        self._kv[key] = value


def _items(marker_mod, kind):
    """The item stream of one scenario, with ``marker_mod``'s sentinels."""
    end = marker_mod.EndPartition
    rows = [np.arange(3, dtype=np.int32) + 10 * i for i in range(7)]
    if kind == "rows":
        return rows[:3] + [end()] + rows[3:5] + [end(), end()] + \
            rows[5:] + [None]
    if kind == "end_in_partial":
        return rows[:5] + [None]
    if kind == "columns":
        return [(np.float32(i) * np.ones(2, np.float32), i) for i in range(5)
                ] + [end(), None]
    if kind == "scalars":
        return list(range(6)) + [end()] + list(range(6, 9)) + [None]
    raise ValueError(kind)


def _run(feed_mod, marker_mod, kind, calls, train_mode, mgr=None):
    mgr = mgr or _Mgr()
    q = mgr.get_queue("input")
    for item in _items(marker_mod, kind):
        q.put(item)
    mapping = {"c0": "a", "c1": "b"} if kind == "columns" else None
    df = feed_mod.DataFeed(mgr, train_mode=train_mode, input_mapping=mapping)
    out = []
    for call, kw in calls:
        if call == "sync":
            got = list(df.sync_batches(kw["n"]))
        else:
            got = getattr(df, call)(**kw)
        out.append((_plain(got), df.should_stop()))
    return out


def _plain(value):
    """Arrays as (dtype, shape, values) so comparisons see dtypes too."""
    if isinstance(value, np.ndarray):
        return ("nd", str(value.dtype), value.shape, value.tolist())
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.generic):
        return ("np", str(value.dtype), value.item())
    return value


SCENARIOS = {
    "next_batch_inference": ("rows", False, [
        ("next_batch", {"batch_size": 4})] * 3),
    "next_batch_training": ("rows", True, [
        ("next_batch", {"batch_size": 4})] * 2),
    "arrays_padded": ("rows", False, [
        ("next_batch_arrays", {"batch_size": 4, "pad_to_full": True})] * 3),
    "arrays_unpadded": ("rows", True, [
        ("next_batch_arrays", {"batch_size": 3})] * 3),
    "end_inside_partial_batch": ("end_in_partial", True, [
        ("next_batch_arrays", {"batch_size": 4, "pad_to_full": True})] * 2),
    "typed_empty_batch": ("end_in_partial", True, [
        ("next_batch_arrays", {"batch_size": 5, "pad_to_full": True}),
        ("next_batch_arrays", {"batch_size": 5, "pad_to_full": True,
                               "block": False}),
        ("next_batch_arrays", {"batch_size": 5, "block": False})]),
    "columns": ("columns", False, [
        ("next_batch_arrays", {"batch_size": 3, "pad_to_full": True})] * 3),
    "columns_lists": ("columns", True, [
        ("next_batch", {"batch_size": 4})] * 2),
    "sync_batches": ("rows", True, [("sync", {"n": 3})]),
    "sync_batches_scalars": ("scalars", False, [("sync", {"n": 4})]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_feed_equals_jax_feed(name):
    kind, train_mode, calls = SCENARIOS[name]
    want = _run(jax_feed, jax_marker, kind, calls, train_mode)
    got = _run(port_feed, port_marker, kind, calls, train_mode)
    assert got == want


def test_feed_through_the_port_manager_process():
    mgr = port_manager.start(b"feed-test", ["input", "output", "error"])
    try:
        calls = [("next_batch_arrays", {"batch_size": 4, "pad_to_full": True})
                 ] * 3
        got = _run(port_feed, port_marker, "rows", calls, False, mgr=mgr)
        assert got == _run(jax_feed, jax_marker, "rows", calls, False)
        mgr.get_queue("input").join()  # every item acknowledged
        df = port_feed.DataFeed(mgr, train_mode=False)
        df.batch_results([1, 2, 3])
        out = mgr.get_queue("output")
        assert [out.get(timeout=5) for _ in range(3)] == [1, 2, 3]
        mgr.get_queue("error").put("Traceback: boom")
        with pytest.raises(RuntimeError, match="boom"):
            port_feed._poll_error_queue(mgr)
    finally:
        mgr.shutdown()


def _decoded(feed_mod, marker_mod, kind, batch_size, decode_fn, workers=0,
             train_mode=True):
    mgr = _Mgr()
    q = mgr.get_queue("input")
    for item in _items(marker_mod, kind):
        q.put(item)
    df = feed_mod.DataFeed(mgr, train_mode=train_mode)
    return [_plain(b) for b in df.decoded_batches(
        batch_size, decode_fn, workers=workers)]


def test_decoded_batches_and_paths():
    for kind, n, mode in (("rows", 3, True), ("rows", 4, False),
                          ("end_in_partial", 2, True), ("scalars", 4, True)):
        want = _decoded(jax_feed, jax_marker, kind, n, progs.feed_rows,
                        train_mode=mode)
        assert _decoded(port_feed, port_marker, kind, n, progs.feed_rows,
                        train_mode=mode) == want
    for path, fs in (("hdfs://a/b", "hdfs://nn"), ("/abs", "hdfs://nn:8020"),
                     ("/abs", "file://"), ("rel", "file://"),
                     ("gs://bucket/o", "file://")):
        assert port_paths.absolute_path(path, fs, working_dir="/wd") == \
            jax_paths.absolute_path(path, fs, working_dir="/wd")
    assert port_paths.strip_scheme("file:///a/b") == "/a/b"
    assert repr(port_marker.EndPartition()) == repr(
        jax_marker.EndPartition())


@pytest.mark.parametrize("kind,batch_size,train_mode", [
    ("rows", 3, True), ("rows", 4, False), ("scalars", 4, True)])
def test_decoded_batches_on_a_pool_keep_feed_order(kind, batch_size,
                                                   train_mode):
    before = progs.live_children()
    want = _decoded(jax_feed, jax_marker, kind, batch_size, progs.feed_rows,
                    train_mode=train_mode)
    got = _decoded(port_feed, port_marker, kind, batch_size,
                   progs.feed_rows, workers=2, train_mode=train_mode)
    assert got == want
    assert want[-1][2][0] < batch_size  # the short trailing batch
    assert progs.wait_no_new_children(before) == set()


def test_decoded_batches_decode_error_closes_the_pool():
    from tensorflowonspark_tpu_torch.data import decode_pool

    before = progs.live_children()
    mgr = _Mgr()
    q = mgr.get_queue("input")
    for i in range(10):
        q.put([i, i + 1])
    q.put(None)
    df = port_feed.DataFeed(mgr)
    with pytest.raises(decode_pool.DecodeError) as err:
        list(df.decoded_batches(3, progs.feed_rows_fail_on, workers=2))
    assert err.value.context == {"feed_batch": 2}
    assert "row thirteen does not decode" in str(err.value)
    assert progs.wait_no_new_children(before) == set()
    assert progs.shm_segments() == []
    with pytest.raises(TypeError, match="closure or lambda"):
        next(df.decoded_batches(3, lambda b: b, workers=2))


def test_decoded_batches_in_a_feed_cluster(tmp_path):
    """A FEED node program over ``decoded_batches(workers=2)``: the decoded
    stream in feed order across partitions, and a decode error that fails
    the node, its traceback at the driver."""
    pool = backend.LocalBackend(1, base_dir=str(tmp_path / "exec"))
    items = [[i, i + 1] for i in range(11)]
    try:
        for fail in (False, True):
            args = {"outdir": str(tmp_path), "fail": fail}
            c = cluster.run(pool, cluster_progs.decoded_feed, args,
                            num_executors=1,
                            input_mode=cluster.InputMode.FEED,
                            reservation_timeout=60)
            if not fail:
                c.train(backend.Partitioned.from_items(items, 3), timeout=60)
                c.shutdown(timeout=60)
                continue
            try:
                # Enough items that the feed is still running when the
                # decode of its second batch fails.
                many = [[i, i + 1] for i in range(120)]
                with pytest.raises(RuntimeError,
                                   match="row thirteen does not decode"):
                    c.train(backend.Partitioned.from_items(many, 3),
                            timeout=60)
            finally:
                c.server.stop()
    finally:
        pool.stop()
    with open(os.path.join(str(tmp_path), "decoded_0.json")) as f:
        got = json.load(f)
    fed = [it for part in backend.Partitioned.from_items(items, 3)
           for it in part]  # feed order: partition after partition
    want = [(np.asarray(fed[i:i + 4]) ** 2).tolist()
            for i in range(0, 11, 4)]
    assert got == {"batches": want, "forbidden": []}
