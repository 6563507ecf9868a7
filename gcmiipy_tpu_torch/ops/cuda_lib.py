"""Build and load the port's CUDA sources: ``nvcc`` in a subprocess into a
shared library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, the hash taken
over the source, the shared headers ``csrc/*.cuh`` and the flags.  The
library is written under a temporary name and moved into place with
``os.replace``, so a stale or half-written library is never loaded and no
lock file exists.  Nothing builds at import.
"""

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

# -fmad=false: each a*b+c rounds twice, as the separate PyTorch elementwise
# ops of the plain versions do.  No --use_fast_math: powf must stay exact.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_libraries = {}


def nvcc_path():
    """The ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(name):
    """(source, library) paths of kernel source ``csrc/<name>.cu``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name):
    """Build ``csrc/<name>.cu`` unless its library exists.  Returns the
    compiler log, or None when nothing was built; raises with the log if
    ``nvcc`` fails or times out."""
    src, lib = library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc = None
    if proc is None or proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n" + (
            proc.stdout if proc else f"timed out after {BUILD_TIMEOUT_S} s"))
    os.replace(tmp, lib)
    return proc.stdout


def build_many(names):
    """Build several sources at once, one ``nvcc`` each, all started
    together.  Returns ``{name: (log or None, seconds)}``; raises with the
    first failure's log after every build has ended."""
    def timed(name):
        t = time.perf_counter()
        return build(name), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        concurrent.futures.wait(futures.values())
    return {name: fut.result() for name, fut in futures.items()}


def load(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    if name not in _libraries:
        build(name)
        _libraries[name] = ctypes.CDLL(library_path(name)[1])
    return _libraries[name]
