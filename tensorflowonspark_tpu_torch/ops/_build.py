"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface — no PyTorch headers, so a build takes seconds — and loads
through ``ctypes``. Libraries land in ``build/torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), under a directory named by a
hash of the sources and the flags, so an edited kernel never loads a stale
binary. Sources build in parallel, one ``nvcc`` each. A failed build
raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
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


def build_all():
    """Compile every source that has no library yet; returns ``{name:
    library path}``. The first failure raises with the compiler's
    output."""
    srcs = sources()
    out_dir = _build_dir(srcs)
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, "lib{}.so".format(name))
            for name in srcs}
    # One nvcc per missing library, all started together. Each writes
    # beside its target, then renames: a concurrent process never loads a
    # half-written library.
    procs = {}
    for name, src in srcs.items():
        if not os.path.exists(libs[name]):
            tmp = "{}.{}.tmp".format(libs[name], os.getpid())
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
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
    return libs


def load_library(name):
    """The ``ctypes`` handle of kernel library ``name`` (building it on
    first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
