"""``agree_sum``, ``lockstep`` and ``process_batch_size`` on two gloo
processes, joined through ``cluster.run`` (FILES mode) and
``ctx.initialize_distributed(device="cpu")`` against the chief's reserved
port; and the data-axis mesh."""

import json
import os

import pytest

import torch_cluster_programs as progs
from tensorflowonspark_tpu_torch import backend, cluster
from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost

pytestmark = pytest.mark.watchdog_timeout(120)


def test_agree_sum_and_lockstep_on_two_gloo_processes(tmp_path):
    pool = backend.LocalBackend(2, base_dir=str(tmp_path / "exec"))
    try:
        c = cluster.run(pool, progs.agree_and_lockstep,
                        {"outdir": str(tmp_path), "lengths": [3, 1]},
                        num_executors=2, input_mode=cluster.InputMode.FILES,
                        reservation_timeout=60)
        c.shutdown(timeout=90)
    finally:
        pool.stop()
    docs = [json.load(open(os.path.join(tmp_path, "agree_{}.json".format(r))))
            for r in (0, 1)]
    for rank, doc in enumerate(docs):
        assert doc["joined"] is True and doc["rank"] == rank
        assert doc["world"] == 2 and doc["backend"] == "gloo"
        assert doc["sum"] == [2.0, 1.0, 5.0]
        assert doc["batch_size"] == 4
    # Rank 0 has three batches, rank 1 one: both step three times, rank 1
    # on zero copies of its last batch (mask 0) after its own.
    assert [b["x"] for b in docs[0]["batches"]] == [[0, 0], [1, 1], [2, 2]]
    assert [b["x"] for b in docs[1]["batches"]] == [[10, 10], [0, 0], [0, 0]]
    assert [b["mask"] for b in docs[1]["batches"]] == [[1.0, 1.0],
                                                      [0.0, 0.0], [0.0, 0.0]]


def test_single_process_passthrough_and_mesh():
    assert not multihost.is_multiprocess()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.agree_sum([1.0, 2.0]).tolist() == [1.0, 2.0]
    assert list(multihost.lockstep(iter([1, 2]))) == [1, 2]
    assert multihost.process_batch_size(8) == 8
    multihost.barrier()
    mesh = MeshConfig(data=-1).build()
    assert mesh.data == 1 and mesh.shape["data"] == 1 and mesh.size == 1
    assert MeshConfig(data=-1).sizes(4) == (4, 1, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="at most one"):
        MeshConfig(data=-1, fsdp=-1).sizes(4)
    with pytest.raises(ValueError, match="needs 2 devices"):
        MeshConfig(data=2).build()
    for axis in ("fsdp", "pipe", "expert", "seq", "tensor"):
        mesh = MeshConfig(data=1, **{axis: -1}).build()
        assert mesh.shape[axis] == 1 and mesh.group(axis) is None
    for axis, item in (("pipe", "A10"), ("expert", "A11")):
        with pytest.raises(NotImplementedError, match="ROADMAP " + item):
            MeshConfig(data=1, tensor=2, **{axis: 2}).build()
