"""The port's telemetry core and the calls the training plane makes into
it, as the JAX package's ``Trainer.fit``, ``DevicePrefetch`` and
``CheckpointManager`` make them: the step gauge and rate that heartbeats
carry, the step and data-wait histograms, the ``train/step``,
``checkpoint/save``/``commit``/``restore`` spans, the prefetch counters;
and the Prometheus text, node stats and JSONL span export of the copy."""

import json

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import Trainer, trainer
from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowonspark_tpu_torch.train.prefetch import DevicePrefetch

pytestmark = pytest.mark.watchdog_timeout(120)

LM_KW = dict(vocab_size=32, num_layers=1, num_heads=2, embed_dim=16,
             mlp_dim=32, max_seq_len=16, remat=False)


@pytest.fixture()
def fresh(tmp_path):
    telemetry._reset_for_tests()
    telemetry.configure(node_id="test", export_dir=str(tmp_path / "spans"))
    yield tmp_path
    telemetry._reset_for_tests()


def _batches(n):
    for i in range(n):
        toks = np.random.RandomState(i).randint(1, 32, size=(2, 9))
        yield {"x": toks[:, :-1], "y": toks[:, 1:]}


def test_fit_prefetch_and_checkpoint_report_to_telemetry(fresh):
    torch.manual_seed(0)
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, attention_impl="pallas",
                              **LM_KW)
    tr = Trainer(model, optimizer=trainer.adamw(1e-3), device="cpu")
    state = tr.init(seed=0)
    ckpt = CheckpointManager(str(fresh / "ckpt"))
    state, _ = tr.fit(state, _batches(4), checkpoint=ckpt,
                      checkpoint_every=2)
    ckpt.restore(state)
    ckpt.close()
    assert telemetry.get_gauge("train_step") == 4.0
    assert telemetry.get_gauge("train_steps_per_sec") > 0
    assert telemetry.get_gauge("checkpoint_last_step") == 4.0
    assert telemetry.get_counter("prefetch_batches_total") == 4.0
    hists = telemetry.hist_export()
    for name in ("train_step_seconds", "train_data_wait_seconds",
                 "checkpoint_save_seconds", "checkpoint_commit_seconds",
                 "prefetch_place_seconds"):
        assert name in hists, name
    stats = telemetry.node_stats()
    assert stats["step"] == 4.0 and stats["last_checkpoint_step"] == 4.0
    telemetry.get_recorder().flush()
    names = [json.loads(line)["name"]
             for line in (fresh / "spans" / "test.jsonl").read_text().splitlines()]
    assert names.count("train/step") == 4
    assert names.count("checkpoint/commit") == 2
    assert "checkpoint/save" in names and "checkpoint/restore" in names
    text = telemetry.prometheus_text()
    assert "tfos_train_step 4" in text
    assert "tfos_train_step_seconds_bucket" in text


def test_prefetch_depth_and_stall_counters(fresh):
    pf = DevicePrefetch(_batches(3), depth=1, device="cpu")
    assert len(list(pf)) == 3
    pf.close()
    assert telemetry.get_counter("prefetch_batches_total") == 3.0
    assert telemetry.get_gauge("prefetch_depth") is not None
    assert telemetry.get_counter("prefetch_consumer_wait_seconds") > 0


def test_profiling_is_not_ported(monkeypatch, tmp_path):
    """The sampler is ported now: ``configure`` starts it as the JAX
    package's does (``TFOS_PROFILING`` unset or ``1``), heartbeats carry
    its digest, ``disable`` stops it, and ``TFOS_PROFILING=0`` opts out."""
    import time

    from tensorflowonspark_tpu_torch.telemetry import profiling

    monkeypatch.setenv("TFOS_PROFILING", "1")
    monkeypatch.setenv("TFOS_PROFILING_HZ", "200")
    rec = telemetry.configure(node_id="x")
    assert telemetry.enabled() and rec is telemetry.get_recorder()
    assert profiling.running()
    deadline = time.monotonic() + 10.0
    while "profile" not in telemetry.node_stats() and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    prof = telemetry.node_stats()["profile"]
    assert prof["samples"] >= 1 and prof["top"]
    telemetry.disable()
    assert not profiling.running()
    assert "profile" not in telemetry.node_stats()
    monkeypatch.setenv("TFOS_PROFILING", "0")
    telemetry.configure(node_id="x")
    assert not profiling.running()
    telemetry._reset_for_tests()
