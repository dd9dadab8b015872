"""Columnar batch decoding of ``tf.train.Example`` records (the port's copy
of the JAX package's ``data/batch_decode.py``; the columns are equal).

The native data plane for inference feeds and FILES-mode input pipelines:
Example wire bytes -> dense per-column numpy arrays in one C++ pass — the
role the reference's JVM tier filled with row<->tensor conversion
(``TFModel.scala:51-239`` ``batch2tensors``/``tensors2batch``) and the
tensorflow-hadoop record formats, minus any per-row host objects. Hosts
without a toolchain use a pure-Python fallback with identical results.

Column spec: ``{name: (kind, length)}`` with kind ``float``/``int64``/
``bytes``. Numeric columns decode to ``[n, length]`` (``length == 1``
squeezes to ``[n]``), zero-padded when a record holds fewer values,
zero-filled when the feature is absent; a record holding *more* than
``length`` values is an error. Bytes columns decode to object arrays of
``bytes`` (first value of the BytesList; ``b""`` when absent). Kind
``uint8`` is the FIXED-LENGTH raw-bytes fast path (e.g. packed image
tensors): every record's value must be exactly ``length`` bytes, and the
column decodes to ONE contiguous ``[n, length]`` uint8 array — no
per-record bytes objects, no copies downstream (the feed-plane hot path:
``chip_smoke.py``'s piped ResNet-50 image feed).
"""

import ctypes
import logging

import numpy as np

from tensorflowonspark_tpu_torch.data import _native
from tensorflowonspark_tpu_torch.data import example as example_lib

logger = logging.getLogger(__name__)

UINT8 = "uint8"

_KIND_CODE = {example_lib.FLOAT: 0, example_lib.INT64: 1, example_lib.BYTES: 2}

_lib = None
_lib_ready = False


def _load():
    global _lib, _lib_ready
    if _lib_ready:
        return _lib
    lib = _native.load("libexample_batch.so")
    if lib is not None:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.exb_extract_numeric.restype = ctypes.c_int64
        lib.exb_extract_numeric.argtypes = [
            ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        lib.exb_extract_bytes_sizes.restype = ctypes.c_int64
        lib.exb_extract_bytes_sizes.argtypes = [
            ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_char_p, u64p]
        lib.exb_extract_bytes.restype = ctypes.c_int64
        lib.exb_extract_bytes.argtypes = [
            ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), u64p]
    _lib, _lib_ready = lib, True
    return _lib


def decode_batch(records, columns, use_native=True):
    """Decode a list of Example wire-bytes into ``{name: np.ndarray}``."""
    records = list(records)
    lib = _load() if use_native else None
    if lib is not None:
        return _decode_native(lib, records, columns)
    return _decode_python(records, columns)


def _decode_native(lib, records, columns):
    n = len(records)
    data = b"".join(records)
    offsets = np.zeros(n + 1, np.uint64)
    if n:
        offsets[1:] = np.cumsum([len(r) for r in records], dtype=np.uint64)
    offsets_p = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    out = {}
    for name, (kind, length) in columns.items():
        cname = name.encode("utf-8")
        if kind == UINT8:
            out[name] = _bytes_fixed_native(lib, data, offsets_p, n,
                                            cname, name, length)
            continue
        if kind == example_lib.BYTES:
            sizes = np.zeros(n, np.uint64)
            total = lib.exb_extract_bytes_sizes(
                data, offsets_p, n, cname,
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            )
            if total < 0:
                raise ValueError(
                    "malformed Example while sizing column {!r}".format(name)
                )
            buf = np.zeros(max(1, total), np.uint8)
            boffsets = np.zeros(n + 1, np.uint64)
            rc = lib.exb_extract_bytes(
                data, offsets_p, n, cname,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                boffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            )
            if rc < 0:
                raise ValueError(
                    "malformed Example in column {!r}".format(name)
                )
            raw = buf.tobytes()
            out[name] = np.asarray(
                [raw[int(boffsets[i]):int(boffsets[i + 1])] for i in range(n)],
                object,
            )
            continue
        dtype = np.float32 if kind == example_lib.FLOAT else np.int64
        arr = np.zeros((n, length), dtype)
        rc = lib.exb_extract_numeric(
            data, offsets_p, n, cname, _KIND_CODE[kind], length,
            arr.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == -2:
            raise ValueError(
                "column {!r} holds more than {} value(s) in some "
                "record".format(name, length)
            )
        if rc < 0:
            raise ValueError(
                "malformed Example (or wrong kind) in column {!r}".format(name)
            )
        out[name] = arr[:, 0] if length == 1 else arr
    return out


def _bytes_fixed_native(lib, data, offsets_p, n, cname, name, length):
    """One contiguous (n, length) uint8 array from a fixed-length bytes
    column (no per-record objects)."""
    sizes = np.zeros(n, np.uint64)
    total = lib.exb_extract_bytes_sizes(
        data, offsets_p, n, cname,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if total < 0:
        raise ValueError(
            "malformed Example while sizing column {!r}".format(name))
    if not np.all(sizes == length):
        raise ValueError(
            "uint8 column {!r} expects every record to hold exactly {} "
            "bytes".format(name, length))
    buf = np.zeros((n, length), np.uint8)
    boffsets = np.zeros(n + 1, np.uint64)
    rc = lib.exb_extract_bytes(
        data, offsets_p, n, cname,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        boffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc < 0:
        raise ValueError("malformed Example in column {!r}".format(name))
    return buf


def _decode_python(records, columns):
    n = len(records)
    decoded = [example_lib.decode_example(r) for r in records]
    out = {}
    for name, (kind, length) in columns.items():
        if kind == UINT8:
            arr = np.zeros((n, length), np.uint8)
            for i, ex in enumerate(decoded):
                k, values = ex.get(name, (None, []))
                # Absent feature / empty list / wrong length are all the
                # same contract violation — and the same ValueError the
                # native path raises (size 0 != length).
                first = values[0] if (k == example_lib.BYTES and values)                     else b""
                if len(first) != length:
                    raise ValueError(
                        "uint8 column {!r} expects every record to hold "
                        "exactly {} bytes".format(name, length))
                arr[i] = np.frombuffer(bytes(first), np.uint8)
            out[name] = arr
            continue
        if kind == example_lib.BYTES:
            vals = []
            for ex in decoded:
                k, values = ex.get(name, (None, []))
                if k is not None and k != example_lib.BYTES:
                    raise ValueError(
                        "malformed Example (or wrong kind) in column "
                        "{!r}".format(name)
                    )
                vals.append(bytes(values[0]) if values else b"")
            out[name] = np.asarray(vals, object)
            continue
        dtype = np.float32 if kind == example_lib.FLOAT else np.int64
        arr = np.zeros((n, length), dtype)
        for i, ex in enumerate(decoded):
            k, values = ex.get(name, (None, []))
            if k is None:
                continue
            if k != kind:
                raise ValueError(
                    "malformed Example (or wrong kind) in column "
                    "{!r}".format(name)
                )
            if len(values) > length:
                raise ValueError(
                    "column {!r} holds more than {} value(s) in some "
                    "record".format(name, length)
                )
            arr[i, :len(values)] = values
        out[name] = arr[:, 0] if length == 1 else arr
    return out


def read_columns(paths, columns, batch_size=None, use_native=True):
    """Stream a TFRecord file (or list of files) as columnar batches.

    Yields ``{name: np.ndarray}`` of up to ``batch_size`` rows
    (``None`` = one batch per file). The FILES-mode input path: record IO
    and Example decoding both run native end-to-end.
    """
    from tensorflowonspark_tpu_torch.data import tfrecord

    if isinstance(paths, str):
        paths = [paths]
    pending = []
    for path in paths:
        for record in tfrecord.read_records(path, use_native=use_native):
            pending.append(record)
            if batch_size and len(pending) >= batch_size:
                yield decode_batch(pending, columns, use_native=use_native)
                pending = []
        if not batch_size and pending:
            yield decode_batch(pending, columns, use_native=use_native)
            pending = []
    if pending:
        yield decode_batch(pending, columns, use_native=use_native)
