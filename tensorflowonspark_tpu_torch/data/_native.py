"""Build and load the data tier's host libraries (``csrc/host/*.cc``).

The port's copies of the JAX package's ``cpp/tfrecord.cc`` and
``cpp/example_batch.cc`` compile with the host compiler (``$CXX``, else
``g++``) into ``build/torch_native/<hash>/`` at the root of the checkout
(git-ignored), the hash taken over the sources, the compiler and its
flags, so an edited source never loads a stale library. The build runs
once per checkout, under a file lock in ``build/torch_native/``: the
processes of a cluster (executors, decode workers) may reach it together,
and each library is compiled under a temporary name and renamed into
place, so no process loads a half-written one.

A host without a compiler gets ``None`` from :func:`load`, and the codecs
fall to their pure-Python paths (the same bytes, slower).
"""

import contextlib
import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc", "host")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")

CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LOCK_NAME = ".build.lock"

_lock = threading.Lock()
_cache = {}  # so_name -> CDLL | None (None: build or load failed)


def _sources():
    return {os.path.splitext(f)[0]: os.path.join(SRC_DIR, f)
            for f in sorted(os.listdir(SRC_DIR)) if f.endswith(".cc")}


def _compiler():
    return os.environ.get("CXX") or "g++"


def build_dir():
    """The directory the libraries of these sources build into."""
    h = hashlib.sha256(" ".join((_compiler(),) + CXX_FLAGS).encode())
    srcs = _sources()
    for name in sorted(srcs):
        with open(srcs[name], "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


@contextlib.contextmanager
def _build_lock():
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with open(os.path.join(BUILD_ROOT, LOCK_NAME), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all():
    """Compile every source that has no library yet; returns ``{so_name:
    path}`` of the libraries that exist afterwards. A source that fails to
    compile is logged and left out: the others still load."""
    srcs = _sources()
    out_dir = build_dir()
    libs = {"lib{}.so".format(name): os.path.join(out_dir,
                                                   "lib{}.so".format(name))
            for name in srcs}
    if all(os.path.exists(p) for p in libs.values()):
        return libs
    cxx = shutil.which(_compiler())
    if cxx is None:
        logger.warning("no host compiler (%s): the data tier's native "
                       "codecs are unavailable", _compiler())
        return {}
    with _build_lock():
        os.makedirs(out_dir, exist_ok=True)
        procs = {}
        for name, src in srcs.items():
            so = "lib{}.so".format(name)
            if not os.path.exists(libs[so]):
                tmp = "{}.{}.tmp".format(libs[so], os.getpid())
                procs[so] = (tmp, subprocess.Popen(
                    [cxx, *CXX_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
        for so, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                logger.warning("host build of %s failed (exit %s):\n%s%s",
                               so, proc.returncode, out, err)
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
            else:
                os.replace(tmp, libs[so])
    return {so: p for so, p in libs.items() if os.path.exists(p)}


def load(so_name):
    """The ``ctypes.CDLL`` of ``so_name`` (e.g. ``"libtfrecord.so"``),
    building the libraries on first use; ``None`` when unavailable."""
    if so_name in _cache:
        return _cache[so_name]
    with _lock:
        if so_name in _cache:
            return _cache[so_name]
        lib = None
        try:
            path = build_all().get(so_name)
            if path is not None:
                lib = ctypes.CDLL(path)
        except Exception as e:  # noqa: BLE001 - fall back to Python
            logger.warning("native library %s unavailable (%s); the "
                           "pure-Python path is in use", so_name, e)
        _cache[so_name] = lib
    return lib


def loaded():
    """``{so_name: bool}`` for every host library: whether it loads here
    (building it if needed)."""
    return {"lib{}.so".format(n): load("lib{}.so".format(n)) is not None
            for n in _sources()}
