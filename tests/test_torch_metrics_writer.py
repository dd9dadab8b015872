"""The port's ``MetricsWriter`` and tfevents codec against the JAX
package's: ``encode_event`` gives the same bytes for the same inputs (NaN
and inf included); a port run is read back by the JAX readers
(``metrics.read_events`` for the JSONL stream, ``tbevents.read_scalars``
for the tfevents file) with equal values, and a JAX run by the port's."""

import math

import pytest

from tensorflowonspark_tpu.train import metrics as jax_metrics
from tensorflowonspark_tpu.train import tbevents as jax_tbevents
from tensorflowonspark_tpu_torch.train import metrics, tbevents

pytestmark = pytest.mark.watchdog_timeout(120)

EVENTS = {
    "file_version": dict(wall_time=1.5, file_version=tbevents.FILE_VERSION),
    "scalars": dict(wall_time=1729.25, step=7,
                    scalars={"loss": 0.5, "acc": 0.9}),
    "nan_inf": dict(wall_time=2.0, step=3,
                    scalars={"loss": float("nan"), "grad": float("inf"),
                             "neg": float("-inf")}),
    "negative_step": dict(wall_time=0.0, step=-2, scalars={"x": -1e-30}),
    "big_step_unicode_tag": dict(wall_time=3.25, step=2 ** 40,
                                 scalars={"lr/η": 3e-4}),
    "step_only": dict(wall_time=9.0, step=0),
}


@pytest.mark.parametrize("name", sorted(EVENTS))
def test_encode_event_bytes_match_jax(name):
    kw = EVENTS[name]
    data = tbevents.encode_event(**kw)
    assert data == jax_tbevents.encode_event(**kw)
    back = tbevents.decode_event(data)
    assert repr(back) == repr(jax_tbevents.decode_event(data))  # NaN-safe
    assert back["step"] == kw.get("step", 0)


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256))])
def test_crc32c_matches_jax(data):
    from tensorflowonspark_tpu.data import tfrecord

    assert tbevents.masked_crc32c(data) == tfrecord.masked_crc32c(
        data, _native=False)
    if data == b"123456789":
        assert tbevents.crc32c(data) == 0xE3069283  # the CRC-32C check value


def _run(writer_cls, directory):
    w = writer_cls(str(directory))
    w.write(1, loss=0.5)
    w.write(2, loss=0.25, acc=0.9)
    w.write(3, loss=float("nan"), acc=float("inf"))
    w.close()


def _check_jsonl(events):
    assert [e["step"] for e in events] == [1, 2, 3]
    assert events[0]["loss"] == 0.5
    assert events[1]["acc"] == 0.9
    # NaN/inf are written as null with the value kept under "raw".
    assert events[2]["loss"] is None and events[2]["acc"] is None
    assert events[2]["raw"] == {"loss": "nan", "acc": "inf"}


def _check_scalars(scalars):
    assert [s for s, _ in scalars["loss"]] == [1, 2, 3]
    assert scalars["loss"][0][1] == 0.5 and scalars["loss"][1][1] == 0.25
    assert math.isnan(scalars["loss"][2][1])
    assert scalars["acc"][0] == (2, pytest.approx(0.9, rel=1e-7))
    assert scalars["acc"][1] == (3, float("inf"))


def test_port_run_read_by_the_jax_readers(tmp_path):
    _run(metrics.MetricsWriter, tmp_path)
    _check_jsonl(jax_metrics.read_events(str(tmp_path)))
    jax_scalars = jax_tbevents.read_scalars(str(tmp_path))
    _check_scalars(jax_scalars)
    port_scalars = tbevents.read_scalars(str(tmp_path))
    assert repr(port_scalars) == repr(jax_scalars)  # NaN-safe equality


def test_port_readers_read_a_jax_run(tmp_path):
    _run(jax_metrics.MetricsWriter, tmp_path)
    _check_jsonl(metrics.read_events(str(tmp_path)))
    _check_scalars(tbevents.read_scalars(str(tmp_path)))


def test_remote_run_read_by_the_jax_readers():
    """An object store (``memory://``): the writers buffer and rewrite the
    objects; the JAX readers read the port's remote run back, and a
    buffered stream rolled into ``.partN`` objects reads back in order."""
    import uuid

    from tensorflowonspark_tpu_torch import fs

    base = "memory://torch-metrics-{}".format(uuid.uuid4().hex[:8])
    _run(metrics.MetricsWriter, base + "/run")
    _check_jsonl(jax_metrics.read_events(base + "/run"))
    _check_scalars(jax_tbevents.read_scalars(base + "/run"))

    uri = base + "/rolled"
    w = fs.BufferedObjectWriter(uri, mode="w", flush_every=2,
                                rollover_bytes=64)
    lines = ["line {:03d}\n".format(i) for i in range(20)]
    for line in lines:
        w.write(line)
    w.close()
    parts = fs.part_uris(uri)
    assert len(parts) > 1
    text = ""
    for part in parts:
        with fs.open(part, "r") as f:
            text += f.read()
    assert text == "".join(lines)
