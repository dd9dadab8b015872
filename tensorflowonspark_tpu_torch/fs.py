"""Filesystem layer of the port (its copy of ``tensorflowonspark_tpu/fs.py``):
the paths of checkpoints, metrics, tfevents and the data tier's record
files.

Every path is a URI. Local paths (no scheme, or ``file://``) go straight to
the operating system and need no ``fsspec``; any other scheme (``hdfs://``,
``s3://``, ``gs://``, ``memory://`` in tests) goes through ``fsspec``,
imported inside :func:`get_fs` when a remote URI first needs it.
"""

import builtins
import contextlib
import os
import posixpath
import shutil
import tempfile
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


def _requalify(uri, paths):
    """Re-attach ``uri``'s scheme to fs-relative result paths (fsspec
    strips protocols from ``glob``/``ls`` results)."""
    fs, _ = get_fs(uri)
    return [fs.unstrip_protocol(p) for p in paths]


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


def isfile(uri):
    if is_local(uri):
        return os.path.isfile(local_path(uri))
    fs, path = get_fs(uri)
    return fs.isfile(path)


def isdir(uri):
    if is_local(uri):
        return os.path.isdir(local_path(uri))
    fs, path = get_fs(uri)
    return fs.isdir(path)


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
    return sorted(_requalify(pattern, fs.glob(path)))


def join(uri, *parts):
    """Path join that keeps URI separators POSIX on every platform."""
    if is_local(uri) and not os.fspath(uri).startswith("file://"):
        return os.path.join(uri, *parts)
    return posixpath.join(uri, *parts)


def put_file(local, uri):
    """Upload one local file to ``uri``."""
    if is_local(uri):
        dst = local_path(uri)
        if os.path.dirname(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(local, dst)
        return
    fs, path = get_fs(uri)
    fs.put_file(local, path)


def get_file(uri, local):
    """Download ``uri`` to one local file."""
    if is_local(uri):
        shutil.copyfile(local_path(uri), local)
        return
    fs, path = get_fs(uri)
    fs.get_file(path, local)


def put_tree(local_dir, uri):
    """Recursively upload a local directory under ``uri``."""
    if is_local(uri):
        dst = local_path(uri)
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(local_dir, dst, dirs_exist_ok=True)
        return
    fs, path = get_fs(uri)
    # fs.put(recursive) nests the source dir under the target when the
    # target exists; file by file keeps the layout exact.
    for root, _, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for name in files:
            sub = name if rel == "." else posixpath.join(
                rel.replace(os.sep, "/"), name)
            fs.put_file(os.path.join(root, name), posixpath.join(path, sub))


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


def make_staging_file(prefix="tfos-stage-"):
    """Create (and return the path of) an empty local staging file, for a
    codec that needs a real file descriptor for a remote URI."""
    fd, tmp = tempfile.mkstemp(prefix=prefix)
    os.close(fd)
    return tmp


@contextlib.contextmanager
def stage_for_read(uri):
    """Yield a *local* path holding ``uri``'s bytes (for native codecs that
    need a real file descriptor). Local URIs pass straight through."""
    if is_local(uri):
        yield local_path(uri)
        return
    tmp = make_staging_file()
    try:
        get_file(uri, tmp)
        yield tmp
    finally:
        os.unlink(tmp)


@contextlib.contextmanager
def stage_for_write(uri):
    """Yield a *local* path; on clean exit its bytes are uploaded to
    ``uri``. Local URIs pass straight through."""
    if is_local(uri):
        path = local_path(uri)
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        yield path
        return
    tmp = make_staging_file()
    try:
        yield tmp
        put_file(tmp, uri)
    finally:
        os.unlink(tmp)


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
