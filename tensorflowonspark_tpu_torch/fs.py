"""Filesystem layer of the port (its copy of ``tensorflowonspark_tpu/fs.py``,
the part that checkpoints, metrics and tfevents use).

Every path is a URI. Local paths (no scheme, or ``file://``) go straight to
the operating system and need no ``fsspec``; any other scheme (``hdfs://``,
``s3://``, ``gs://``, ``memory://`` in tests) goes through ``fsspec``,
imported inside :func:`get_fs` when a remote URI first needs it.
"""

import builtins
import os
import posixpath
import shutil
import time


def is_local(uri):
    """True for plain paths and ``file://`` URIs."""
    uri = os.fspath(uri)
    return "://" not in uri or uri.startswith("file://")


def local_path(uri):
    """The local filesystem path of a local URI (scheme stripped)."""
    uri = os.fspath(uri)
    if uri.startswith("file://"):
        return uri[len("file://"):]
    return uri


def get_fs(uri):
    """``(fsspec_filesystem, path)`` for a remote URI."""
    import fsspec

    return fsspec.core.url_to_fs(os.fspath(uri))


def open(uri, mode="rb", **kwargs):
    """Open a file on whatever filesystem ``uri`` names.

    Creates parent directories for local writes (object stores have no
    directories to create).
    """
    if is_local(uri):
        path = local_path(uri)
        if ("w" in mode or "a" in mode) and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return builtins.open(path, mode, **kwargs)
    fs, path = get_fs(uri)
    return fs.open(path, mode, **kwargs)


def exists(uri):
    if is_local(uri):
        return os.path.exists(local_path(uri))
    fs, path = get_fs(uri)
    return fs.exists(path)


def makedirs(uri):
    if is_local(uri):
        os.makedirs(local_path(uri), exist_ok=True)
        return
    fs, path = get_fs(uri)
    fs.makedirs(path, exist_ok=True)


def remove(uri):
    if is_local(uri):
        os.remove(local_path(uri))
        return
    fs, path = get_fs(uri)
    fs.rm_file(path)


def glob(pattern):
    """Glob that keeps the pattern's scheme in its results."""
    if is_local(pattern):
        import glob as glob_lib

        prefix = "file://" if os.fspath(pattern).startswith("file://") else ""
        return sorted(prefix + p for p in glob_lib.glob(local_path(pattern)))
    fs, path = get_fs(pattern)
    # fsspec strips the protocol from glob results; put it back.
    return sorted(fs.unstrip_protocol(p) for p in fs.glob(path))


def join(uri, *parts):
    """Path join that keeps URI separators POSIX on every platform."""
    if is_local(uri) and not os.fspath(uri).startswith("file://"):
        return os.path.join(uri, *parts)
    return posixpath.join(uri, *parts)


def get_tree(uri, local_dir):
    """Recursively download the directory at ``uri`` into ``local_dir``."""
    if is_local(uri):
        shutil.copytree(local_path(uri), local_dir, dirs_exist_ok=True)
        return
    fs, path = get_fs(uri)
    base = path.rstrip("/")
    for p in fs.find(base):
        rel = p[len(base):].lstrip("/")
        dst = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        fs.get_file(p, dst)


class BufferedObjectWriter:
    """Append semantics for object stores, which cannot append.

    Appended chunks are buffered and the whole object is rewritten when
    ``flush_every`` chunks have accumulated or ``flush_secs`` have passed
    since the last upload (and on close). Past ``rollover_bytes`` the
    object is final and writing goes on in ``<uri>.part1``, ``.part2``,
    ...; readers concatenate the parts in order (:func:`part_uris`). Shared
    by the JSONL metrics and the tfevents writers.
    """

    def __init__(self, uri, mode="wb", flush_every=50, flush_secs=10.0,
                 rollover_bytes=64 << 20):
        self.uri = uri
        self._mode = mode
        self._empty = b"" if "b" in mode else ""
        self._chunks = []
        self._size = 0
        self._part = 0
        self._dirty = 0
        self._flush_every = max(1, int(flush_every))
        self._flush_secs = float(flush_secs)
        self._rollover = int(rollover_bytes)
        self._last_flush = time.monotonic()
        # Overwrite on restart: stale parts of an earlier run of the same
        # uri would otherwise be read after the new stream.
        for stale in part_uris(uri)[1:]:
            remove(stale)

    def write(self, chunk, flush=True):
        self._chunks.append(chunk)
        self._size += len(chunk)
        self._dirty += 1
        if flush and (
            self._dirty >= self._flush_every
            or time.monotonic() - self._last_flush >= self._flush_secs
        ):
            self.flush()

    def flush(self):
        with open(part_uri(self.uri, self._part), self._mode) as f:
            f.write(self._empty.join(self._chunks))
        self._dirty = 0
        self._last_flush = time.monotonic()
        if self._rollover and self._size >= self._rollover:
            # This part is complete on the store; later flushes upload
            # only the next one.
            self._part += 1
            self._chunks = []
            self._size = 0

    def close(self):
        if self._dirty:
            self.flush()


def part_uri(uri, part):
    """The ``part``-th object of a rolled :class:`BufferedObjectWriter`
    stream (part 0 is the base uri itself)."""
    return uri if part == 0 else "{}.part{}".format(uri, part)


def part_uris(uri):
    """All existing parts of a (possibly rolled) object, in write order."""
    uris = []
    part = 0
    while True:
        candidate = part_uri(uri, part)
        if not exists(candidate):
            break
        uris.append(candidate)
        part += 1
    return uris
