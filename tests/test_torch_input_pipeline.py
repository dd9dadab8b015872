"""The port's ``InputPipeline`` against the JAX package's.

The same seeded record shards go through both pipelines, the JAX one
always inline (``decode_workers=0``: its pool forks), the port's inline and
on a two-worker decode pool, and every batch is bitwise equal across
``shard``, ``shuffle_buffer``, ``shuffle_files``, ``epochs``,
``pad_final``, ``drop_remainder``, a transform and the ``_base_index``
hint. With ``reader_threads=2`` the order is not deterministic in either
package, so those runs are held as multisets of rows. With ``cache_dir``
the cache files are byte-identical to the JAX pipeline's, and the replayed
epochs equal both the first epoch and the JAX pipeline's stream. No test
leaves a live child or a shared-memory segment.
"""

import os

import numpy as np
import pytest

import torch_data_programs as progs
from tensorflowonspark_tpu.data import decode_pool as jax_decode_pool
from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data.input_pipeline import (
    InputPipeline as JaxPipeline,
)
from tensorflowonspark_tpu_torch.data import decode_pool
from tensorflowonspark_tpu_torch.data.input_pipeline import InputPipeline

pytestmark = pytest.mark.watchdog_timeout(120)

COLUMNS = {"v": ("float", 2), "label": ("int64", 1)}
ROWS = 100


@pytest.fixture(autouse=True)
def _nothing_left():
    before = progs.live_children()
    yield
    assert progs.wait_no_new_children(before) == set()
    assert progs.shm_segments() == []


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    rng = np.random.RandomState(5)
    rows = [{"v": [float(i), float(np.float32(rng.randn()))], "label": i}
            for i in range(ROWS)]
    out = str(tmp_path_factory.mktemp("pipeline") / "data")
    jax_dfutil.save_as_tfrecords(
        rows, out,
        schema={"v": jax_dfutil.ARRAY_FLOAT, "label": jax_dfutil.INT64},
        num_shards=5)
    return out


CASES = {
    "plain": dict(batch_size=16),
    "shard_2_0": dict(batch_size=8, shard=(2, 0)),
    "shard_2_1": dict(batch_size=8, shard=(2, 1)),
    "shuffle_buffer": dict(batch_size=10, shuffle_buffer=7, seed=3,
                           epochs=2),
    "shuffle_files": dict(batch_size=10, shuffle_files=True, seed=1,
                          epochs=2),
    "epochs_3": dict(batch_size=16, epochs=3),
    "no_pad_final": dict(batch_size=16, pad_final=False),
    "drop_remainder": dict(batch_size=16, epochs=2, drop_remainder=True),
    "transform": dict(batch_size=12, transform=progs.scale_v),
    "base_index": dict(batch_size=12, shuffle_buffer=5, seed=2, epochs=2,
                       transform=progs.BaseIndexTag()),
}


def _equal_streams(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], k)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_bitwise_equal_to_jax(data_dir, case, workers):
    kw = CASES[case]
    want = list(JaxPipeline(data_dir, COLUMNS, **kw))
    got = list(InputPipeline(data_dir, COLUMNS, decode_workers=workers,
                             **kw))
    _equal_streams(got, want)


def _rows(batches):
    out = []
    for b in batches:
        m = b["mask"]
        out += [(int(lab), tuple(v)) for lab, v in zip(b["label"][m],
                                                       b["v"][m])]
    return sorted(out)


@pytest.mark.parametrize("workers", [0, 2])
def test_reader_threads_hold_the_same_multiset(data_dir, workers):
    want = list(JaxPipeline(data_dir, COLUMNS, batch_size=16, epochs=2))
    got = list(InputPipeline(data_dir, COLUMNS, batch_size=16, epochs=2,
                             reader_threads=2, decode_workers=workers))
    assert _rows(got) == _rows(want)
    assert len(got) == len(want)


@pytest.mark.parametrize("workers", [0, 2])
def test_cached_replays_equal_jax_and_the_first_epoch(data_dir, tmp_path,
                                                      workers):
    kw = dict(batch_size=16, epochs=3, shuffle_files=True, seed=4,
              cache_tag="v1")
    jdir, pdir = str(tmp_path / "jax_cache"), str(tmp_path / "port_cache")
    want = list(JaxPipeline(data_dir, COLUMNS, cache_dir=jdir, **kw))
    got = list(InputPipeline(data_dir, COLUMNS, cache_dir=pdir,
                             decode_workers=workers, **kw))
    _equal_streams(got, want)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(pdir, name), "rb") as g:
            assert g.read() == f.read(), name
    # A rebuilt pipeline replays its first epoch from the cache.
    replay = list(InputPipeline(data_dir, COLUMNS, cache_dir=pdir,
                                **dict(kw, epochs=1)))
    per_epoch = len(got) // 3
    _equal_streams(replay, got[:per_epoch])
    assert sorted(_rows(got[per_epoch:2 * per_epoch])) == \
        sorted(_rows(got[:per_epoch]))


@pytest.mark.parametrize("workers", [0, 2])
def test_decode_error_names_the_records(data_dir, workers):
    kw = dict(batch_size=8, transform=progs.fail_on_label_13)
    with pytest.raises(jax_decode_pool.DecodeError) as jax_err:
        list(JaxPipeline(data_dir, COLUMNS, **kw))
    with pytest.raises(decode_pool.DecodeError) as port_err:
        list(InputPipeline(data_dir, COLUMNS, decode_workers=workers, **kw))
    assert port_err.value.context == jax_err.value.context
    assert "label thirteen does not transform" in str(port_err.value)
    if not workers:
        assert str(port_err.value) == str(jax_err.value)


def test_early_abandon_does_not_hang_or_leak(data_dir):
    for workers in (0, 2):
        pipe = InputPipeline(data_dir, COLUMNS, batch_size=4, epochs=None,
                             prefetch=1, decode_workers=workers)
        it = iter(pipe)
        next(it)
        next(it)
        it.close()
        pipe.close()


def test_explicit_file_list_and_aliases(data_dir):
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
    kw = dict(batch_size=32, prefetch_batches=3)
    got = InputPipeline(files[::-1], COLUMNS, **kw)
    want = JaxPipeline(files[::-1], COLUMNS, **kw)
    assert got.files == want.files and got.prefetch_batches == 3
    _equal_streams(list(got), list(want))
