"""TensorBoard event files (port of ``train/tbevents.py``), no TensorFlow.

A tfevents file is TFRecord framing (``uint64 len | masked_crc(len) | data
| masked_crc(data)``) around hand-encoded ``Event`` protobufs:

    Event   { double wall_time = 1; int64 step = 2;
              oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }

The bytes equal the JAX package's for the same inputs. The framing's CRC
is :func:`~tensorflowonspark_tpu_torch.data.tfrecord.masked_crc32c` and the
protobuf helpers are :mod:`~tensorflowonspark_tpu_torch.data.example`'s,
as in the JAX package. Files are named
``events.out.tfevents.<secs>.<host>.<pid>.<uid>``, so TensorBoard's
``*tfevents*`` glob finds them and same-second writers do not collide;
long remote runs roll to ``<name>.partN`` objects, which the readers join.
"""

import itertools
import os
import re
import socket
import struct
import time

from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch.data.example import (  # noqa: F401
    _fields,
    _to_signed64,
    _write_len_delimited,
    _write_varint,
    _zigzagless_int64,
)
from tensorflowonspark_tpu_torch.data.tfrecord import (  # noqa: F401
    crc32c,
    masked_crc32c,
)

_WRITER_IDS = itertools.count()
FILE_VERSION = "brain.Event:2"


# -- Event proto codec --------------------------------------------------------

def encode_event(wall_time, step=None, file_version=None, scalars=None):
    """Serialize one Event. ``scalars`` is a ``{tag: float}`` dict."""
    buf = bytearray()
    _write_varint(buf, (1 << 3) | 1)  # wall_time: fixed64 double
    buf.extend(struct.pack("<d", wall_time))
    if step is not None:
        _write_varint(buf, 2 << 3)  # step: varint int64
        _write_varint(buf, _zigzagless_int64(int(step)))
    if file_version is not None:
        _write_len_delimited(buf, 3, file_version.encode("utf-8"))
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            entry = bytearray()
            _write_len_delimited(entry, 1, tag.encode("utf-8"))
            _write_varint(entry, (2 << 3) | 5)  # simple_value: fixed32 float
            entry.extend(struct.pack("<f", float(value)))
            _write_len_delimited(summary, 1, entry)
        _write_len_delimited(buf, 5, summary)
    return bytes(buf)


def decode_event(data):
    """Parse Event wire bytes into a dict with ``wall_time``/``step`` and
    either ``file_version`` or ``scalars`` (``{tag: float}``)."""
    out = {"wall_time": 0.0, "step": 0}
    for field, wt, value in _fields(data):
        if field == 1 and wt == 1:
            out["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2 and wt == 0:
            out["step"] = _to_signed64(value)
        elif field == 3 and wt == 2:
            out["file_version"] = value.decode("utf-8")
        elif field == 5 and wt == 2:
            scalars = {}
            for f, w, v in _fields(value):
                if f != 1 or w != 2:
                    continue
                tag, simple = None, None
                for vf, vw, vv in _fields(v):
                    if vf == 1 and vw == 2:
                        tag = vv.decode("utf-8")
                    elif vf == 2 and vw == 5:
                        simple = struct.unpack("<f", vv)[0]
                if tag is not None and simple is not None:
                    scalars[tag] = simple
            out["scalars"] = scalars
    return out


# -- file IO ------------------------------------------------------------------

def _frame(record):
    header = struct.pack("<Q", len(record))
    return b"".join([
        header,
        struct.pack("<I", masked_crc32c(header)),
        record,
        struct.pack("<I", masked_crc32c(record)),
    ])


class EventsWriter:
    """Append scalar events to one tfevents file in ``directory``.

    ``directory`` may be any URI. Local files flush on every write, so a
    live TensorBoard tails them; remote stores buffer frames and rewrite
    the object on a bounded cadence (:class:`fs.BufferedObjectWriter`).
    """

    def __init__(self, directory, flush_every=50, flush_secs=10.0):
        self._local = fs_lib.is_local(directory)
        stamp = int(time.time())
        host = socket.gethostname() or "localhost"
        uid = next(_WRITER_IDS)
        self.path = fs_lib.join(
            directory, "events.out.tfevents.{}.{}.{}.{}".format(
                stamp, host, os.getpid(), uid))
        version = _frame(encode_event(time.time(), file_version=FILE_VERSION))
        if self._local:
            fs_lib.makedirs(directory)
            self._f = open(fs_lib.local_path(self.path), "ab")
            self._f.write(version)
            self._f.flush()
        else:
            self._f = fs_lib.BufferedObjectWriter(
                self.path, mode="wb",
                flush_every=flush_every, flush_secs=flush_secs)
            # The version record does not count toward the flush cadence.
            self._f.write(version, flush=False)

    def write(self, step, scalars, wall_time=None):
        when = time.time() if wall_time is None else wall_time
        self._f.write(_frame(encode_event(when, step=step, scalars=scalars)))
        if self._local:
            self._f.flush()

    def close(self):
        self._f.close()


def read_events(path):
    """Decoded events of one tfevents stream (CRC-checked), with any rolled
    ``.partN`` continuation objects in write order."""
    events = []
    for part in fs_lib.part_uris(path) or [path]:
        events.extend(_read_one(part))
    return events


def _read_one(path):
    events = []
    with fs_lib.open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) != 12:
                raise IOError("truncated tfevents file: {}".format(path))
            (length,) = struct.unpack("<Q", header[:8])
            if masked_crc32c(header[:8]) != struct.unpack("<I", header[8:])[0]:
                raise IOError("corrupt tfevents length: {}".format(path))
            data = f.read(length)
            footer = f.read(4)
            if len(data) != length or len(footer) != 4:
                raise IOError("truncated tfevents file: {}".format(path))
            if masked_crc32c(data) != struct.unpack("<I", footer)[0]:
                raise IOError("corrupt tfevents data: {}".format(path))
            events.append(decode_event(data))
    return events


def read_scalars(directory):
    """``{tag: [(step, value), ...]}`` from every tfevents file in
    ``directory`` (the shape TensorBoard's scalar dashboard renders)."""
    out = {}
    paths = sorted(fs_lib.glob(fs_lib.join(directory, "*tfevents*")))
    # read_events joins a stream's .partN continuations itself; globbing
    # them again would read them twice. Suffix-anchored, so a hostname
    # holding ".part" still matches.
    paths = [p for p in paths
             if not re.search(r"\.part\d+$", p.rsplit("/", 1)[-1])]
    for path in paths:
        for event in read_events(path):
            for tag, value in event.get("scalars", {}).items():
                out.setdefault(tag, []).append((event["step"], value))
    return out
