"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface — no PyTorch headers, so a build takes seconds — and loads
through ``ctypes``. Libraries land in ``build/torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), under a directory named by a
hash of the sources and the flags, so an edited kernel never loads a stale
binary. Sources build in parallel, one ``nvcc`` each. A failed build
raises: there is no fallback.

Several processes may build at once (the spawned executors of a cluster on
a fresh checkout): a file lock in ``BUILD_ROOT`` lets one of them compile
while the others wait and then find the libraries, and each library is
compiled under a temporary name and renamed into place, so no process
ever loads a half-written one.
"""

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LOCK_NAME = ".build.lock"
_libs = {}


def sources():
    """``{name: path}`` of every kernel source under ``csrc/``."""
    return {
        os.path.splitext(f)[0]: os.path.join(CSRC_DIR, f)
        for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cu")
    }


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build on a machine with "
        "the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _build_dir(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(srcs):
        with open(srcs[name], "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


@contextlib.contextmanager
def _build_lock():
    """Exclusive lock over ``BUILD_ROOT``, across processes and threads
    (``flock`` on a file opened per holder)."""
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with open(os.path.join(BUILD_ROOT, LOCK_NAME), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all():
    """Compile every source that has no library yet; returns ``{name:
    library path}``. The first failure raises with the compiler's
    output. Compiles under the build lock: a second process waits, then
    finds the libraries built. Libraries appear only by rename, so the
    check that all exist needs no lock."""
    srcs = sources()
    out_dir = _build_dir(srcs)
    libs = {name: os.path.join(out_dir, "lib{}.so".format(name))
            for name in srcs}
    if all(os.path.exists(path) for path in libs.values()):
        return libs
    nvcc = _nvcc()  # raises before any file is touched
    with _build_lock():
        _build_missing(nvcc, srcs, out_dir, libs)
    return libs


def _build_missing(nvcc, srcs, out_dir, libs):
    os.makedirs(out_dir, exist_ok=True)
    # One nvcc per missing library, all started together. Each writes
    # beside its target, then renames: a process that finds the library
    # never loads a half-written one.
    procs = {}
    for name, src in srcs.items():
        if not os.path.exists(libs[name]):
            tmp = "{}.{}.tmp".format(libs[name], os.getpid())
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed for {} (exit {}):\n{}{}".format(
                name, proc.returncode, out, err))
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name):
    """The ``ctypes`` handle of kernel library ``name`` (building it on
    first use)."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        # Two threads may both load: dlopen of one path returns one handle.
        lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib
