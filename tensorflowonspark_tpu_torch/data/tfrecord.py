"""TFRecord file IO (the port's copy of the JAX package's
``data/tfrecord.py``): native C++ codec via ctypes, pure-Python fallback.

Wire format (what the reference read/wrote through the JVM
tensorflow-hadoop connector, ``dfutil.py:39,63`` / ``DFUtil.scala:38,192``):

    uint64 length (LE) | uint32 masked_crc32c(length) | data |
    uint32 masked_crc32c(data)

The C++ implementation (``csrc/host/tfrecord.cc``) is compiled with the
host compiler on first use (:mod:`._native`) and loaded with ctypes; if no
compiler is available the pure-Python CRC-32C path serves as a slow but
correct fallback. Both paths produce byte-identical files, equal to the
JAX package's.
"""

import ctypes
import logging
import os
import struct

from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch.data import _native

logger = logging.getLogger(__name__)

_lib = None
_lib_ready = False


def _load_native():
    """Build (if needed) and load the native codec; None if unavailable.
    Synchronization and failure-caching live in :mod:`_native`."""
    global _lib, _lib_ready
    if _lib_ready:
        return _lib
    lib = _native.load("libtfrecord.so")
    if lib is not None:
        try:
            lib.tfr_crc32c.restype = ctypes.c_uint32
            lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.tfr_masked_crc32c.restype = ctypes.c_uint32
            lib.tfr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.tfr_writer_open.restype = ctypes.c_void_p
            lib.tfr_writer_open.argtypes = [ctypes.c_char_p]
            lib.tfr_writer_write.restype = ctypes.c_int
            lib.tfr_writer_write.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.tfr_writer_close.restype = ctypes.c_int
            lib.tfr_writer_close.argtypes = [ctypes.c_void_p]
            lib.tfr_reader_open.restype = ctypes.c_void_p
            lib.tfr_reader_open.argtypes = [ctypes.c_char_p]
            lib.tfr_reader_next.restype = ctypes.c_int64
            lib.tfr_reader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
            lib.tfr_free.restype = None
            lib.tfr_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.tfr_reader_close.restype = ctypes.c_int
            lib.tfr_reader_close.argtypes = [ctypes.c_void_p]
            _lib = lib
            logger.debug("native TFRecord codec loaded")
        except Exception as e:  # pragma: no cover - symbol mismatch
            logger.warning("native TFRecord codec unavailable (%s); "
                           "using pure-Python fallback", e)
            _lib = None
    _lib_ready = True
    return _lib


# -- pure-Python CRC-32C (fallback path) --------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data, _native=True):
    lib = _load_native() if _native else None
    if lib is not None:
        return lib.tfr_crc32c(bytes(data), len(data))
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data, _native=True):
    crc = crc32c(data, _native)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- writer / reader ----------------------------------------------------------

class RecordWriter:
    """Append serialized records to one TFRecord file.

    ``path`` may be any fsspec URI (``gs://``, ``hdfs://``, ``memory://``,
    ...): remote writes run the native codec against a local staging file
    uploaded on close, or stream the pure-Python codec straight through the
    remote file object.
    """

    def __init__(self, path, use_native=True):
        self._native = use_native and _load_native() is not None
        self._path = path = os.fspath(path)
        self._stage = None
        if self._native:
            if not fs_lib.is_local(path):
                target = self._stage = fs_lib.make_staging_file("tfos-tfr-")
            else:
                target = fs_lib.local_path(path)
            self._h = _lib.tfr_writer_open(os.fsencode(target))
            if not self._h:
                raise IOError("cannot open {} for writing".format(path))
        else:
            self._f = fs_lib.open(path, "wb")

    def write(self, record):
        record = bytes(record)
        if self._native:
            if self._h is None:
                raise ValueError(
                    "write to closed RecordWriter: {}".format(self._path)
                )
            if _lib.tfr_writer_write(self._h, record, len(record)):
                raise IOError("write failed: {}".format(self._path))
        else:
            header = struct.pack("<Q", len(record))
            self._f.write(header)
            self._f.write(struct.pack("<I", masked_crc32c(header, _native=False)))
            self._f.write(record)
            self._f.write(struct.pack("<I", masked_crc32c(record, _native=False)))

    def close(self):
        if self._native:
            if self._h is not None:
                rc = _lib.tfr_writer_close(self._h)
                self._h = None
                if rc:
                    if self._stage is not None:
                        os.unlink(self._stage)
                        self._stage = None
                    raise IOError(
                        "close/flush failed: {} (disk full?)".format(self._path)
                    )
                if self._stage is not None:
                    try:
                        fs_lib.put_file(self._stage, self._path)
                    finally:
                        os.unlink(self._stage)
                        self._stage = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Iterate serialized records of one TFRecord file (CRC-verified).

    ``path`` may be any fsspec URI: remote files are staged locally for
    the native codec, or streamed through the remote file object on the
    pure-Python path.
    """

    def __init__(self, path, use_native=True):
        self._native = use_native and _load_native() is not None
        self._path = path = os.fspath(path)
        self._stage = None
        if self._native:
            if not fs_lib.is_local(path):
                target = self._stage = fs_lib.make_staging_file("tfos-tfr-")
                try:
                    fs_lib.get_file(path, self._stage)
                except Exception:
                    os.unlink(self._stage)
                    self._stage = None
                    raise
            else:
                target = fs_lib.local_path(path)
            self._h = _lib.tfr_reader_open(os.fsencode(target))
            if not self._h:
                if self._stage is not None:
                    os.unlink(self._stage)
                raise IOError("cannot open {} for reading".format(path))
        else:
            self._f = fs_lib.open(path, "rb")

    def __iter__(self):
        return self

    def __next__(self):
        if self._native:
            if self._h is None:
                raise ValueError(
                    "read from closed RecordReader: {}".format(self._path)
                )
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = _lib.tfr_reader_next(self._h, ctypes.byref(out))
            if n == -1:
                raise StopIteration
            if n == -2:
                raise IOError("corrupt TFRecord file: {}".format(self._path))
            try:
                return ctypes.string_at(out, n)
            finally:
                _lib.tfr_free(out)
        header = self._f.read(12)
        if not header:
            raise StopIteration
        if len(header) != 12:
            raise IOError("corrupt TFRecord file: {}".format(self._path))
        (length,) = struct.unpack("<Q", header[:8])
        (len_crc,) = struct.unpack("<I", header[8:12])
        if masked_crc32c(header[:8], _native=False) != len_crc:
            raise IOError("corrupt TFRecord length: {}".format(self._path))
        data = self._f.read(length)
        footer = self._f.read(4)
        if len(data) != length or len(footer) != 4:
            raise IOError("truncated TFRecord file: {}".format(self._path))
        (data_crc,) = struct.unpack("<I", footer)
        if masked_crc32c(data, _native=False) != data_crc:
            raise IOError("corrupt TFRecord data: {}".format(self._path))
        return data

    def close(self):
        if self._native:
            if self._h is not None:
                _lib.tfr_reader_close(self._h)
                self._h = None
            if self._stage is not None:
                os.unlink(self._stage)
                self._stage = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records, use_native=True):
    with RecordWriter(path, use_native) as w:
        n = 0
        for r in records:
            w.write(r)
            n += 1
    return n


def read_records(path, use_native=True):
    with RecordReader(path, use_native) as r:
        yield from r
