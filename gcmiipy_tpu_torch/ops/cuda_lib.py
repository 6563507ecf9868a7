"""Build and load the port's CUDA sources: ``nvcc`` in a subprocess into a
shared library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, which the
wrappers launch on float32 tensors, and on float64 ones too unless the
source's code calls ``power`` (``gcm_stencil.cuh``).  Such a source gets a
second library, ``_build/<name>-f64-<hash>.so`` (library name
``<name>-f64``), for float64 tensors: its double ``pow`` is
``csrc/gcm_pow.cu``'s, built with nvcc's default contraction
(``_build/gcm_pow-<hash>.o``) and linked as relocatable device code,
because the CUDA math library's double ``pow`` compiled under the kernels'
``-fmad=false`` rounds apart from PyTorch's in some values.  The float32
libraries keep the plain build: ``powf`` rounds alike under both flags,
and relocatable device code slows some float32 kernels.  Each hash is
taken over the source, the shared headers ``csrc/*.cuh``,
``csrc/gcm_pow.cu`` and the flags.  Each file is written under a
temporary name and moved into place with ``os.replace``, so a stale or
half-written one is never used and no lock file exists; the compiler's
log (ptxas' register and stack report) is kept beside its library as
``<library>.log``.  Nothing builds at import.
"""

import concurrent.futures
import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

# -fmad=false: each a*b+c rounds twice, as the separate PyTorch elementwise
# ops of the plain versions do.  No --use_fast_math: powf must stay exact.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
FLOAT64 = "-f64"  # a library name's suffix: the source's float64 library
FLOAT64_FLAGS = ("-rdc=true", "-DGCM_POW_LINKED")
POW_SOURCE = "gcm_pow"
POW_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-rdc=true", "-Xcompiler", "-fPIC", "-c")
BUILD_TIMEOUT_S = 600

_libraries = {}
_pow_lock = threading.Lock()


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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
# a call of gcm::power, not its definitions ("float power(", "double power(")
_POWER_CALL = re.compile(r"(?<!float )(?<!double )\bpower\s*\(")


def calls_power(source):
    """True when ``csrc/<source>.cu`` or a header it includes (at any
    depth) calls ``power``, so that its float64 kernels need the linked
    ``pow``.  Read once per source directory."""
    return _calls_power(CSRC_DIR, source)


@functools.lru_cache(maxsize=None)
def _calls_power(csrc, source):
    seen, todo = set(), [source + ".cu"]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(csrc, name)) as f:
            code = re.sub(r"//[^\n]*", "", f.read())
        if _POWER_CALL.search(code):
            return True
        todo += [n for n in _INCLUDE.findall(code)
                 if os.path.isfile(os.path.join(csrc, n))]
    return False


def library_name(source, double):
    """The name of the library that launches ``csrc/<source>.cu``'s
    kernels on float64 tensors (``double``) or on float32 ones."""
    return source + FLOAT64 if double and calls_power(source) else source


def _hashed_path(name, sources, flags, ext):
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}{ext}")


def _pow_source():
    return os.path.join(CSRC_DIR, POW_SOURCE + ".cu")


def library_path(name):
    """(source, library) paths of library ``name``: ``<source>`` or
    ``<source>-f64``, the libraries of ``csrc/<source>.cu``."""
    double = name.endswith(FLOAT64)
    source = name[:-len(FLOAT64)] if double else name
    src = os.path.join(CSRC_DIR, source + ".cu")
    paths = [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if double:
        paths.append(_pow_source())
    flags = NVCC_FLAGS + (FLOAT64_FLAGS + POW_FLAGS if double else ())
    return src, _hashed_path(name, paths, flags, ".so")


def _nvcc(flags, inputs, out):
    """nvcc ``flags`` on ``inputs`` into ``out``, written under a temporary
    name and moved into place after its log (``<out>.log``); returns the
    log, raises with it if nvcc fails or times out."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, *inputs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc = None
    if proc is None or proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {inputs[0]}:\n" + (
            proc.stdout if proc else f"timed out after {BUILD_TIMEOUT_S} s"))
    with open(tmp + ".log", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp + ".log", out + ".log")
    os.replace(tmp, out)
    return proc.stdout


def _pow_object():
    """The object of ``csrc/gcm_pow.cu``, built unless it exists (one
    thread at a time)."""
    obj = _hashed_path(POW_SOURCE, [_pow_source()], POW_FLAGS, ".o")
    with _pow_lock:
        if not os.path.exists(obj):
            _nvcc(POW_FLAGS, [_pow_source()], obj)
    return obj


def build(name):
    """Build library ``name`` (see :func:`library_path`) unless it exists.
    Returns the compiler log, or None when nothing was built; raises with
    the log if ``nvcc`` fails or times out."""
    src, lib = library_path(name)
    if os.path.exists(lib):
        return None
    if name.endswith(FLOAT64):
        return _nvcc(NVCC_FLAGS + FLOAT64_FLAGS, [src, _pow_object()], lib)
    return _nvcc(NVCC_FLAGS, [src], lib)


def build_log(name):
    """The compiler log kept beside library ``name``, or None when there
    is none."""
    path = library_path(name)[1] + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def build_many(names):
    """Build several libraries at once, one ``nvcc`` each, all started
    together.  Returns ``{name: (log or None, seconds)}``; raises with the
    first failure's log after every build has ended."""
    def timed(name):
        t = time.perf_counter()
        return build(name), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        concurrent.futures.wait(futures.values())
    return {name: fut.result() for name, fut in futures.items()}


def forced_form_sources(form, out):
    """Copy ``csrc/`` into the directory ``out`` with every column kernel
    (the pgf and rest tiles, the epilogue, the adaptive convection)
    launching its ``form`` at any L, to time or check the forms against
    each other: 'deep' sets each ``HeldLayers`` of ``gcm_limits.cuh`` to
    0 at both types; 'held' sets them to ``kMaxLayers`` and takes out the
    static checks of the held blocks' size, so that a held block too large
    for the card fails at its launch.  Returns ``out``."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC_DIR, out)
    for name in os.listdir(out):
        path = os.path.join(out, name)
        with open(path) as f:
            text = f.read()
        held = {"held": "kMaxLayers", "deep": "0"}[form]
        text = re.sub(r"(constexpr HeldLayers k\w+ = )\{[^}]*\};",
                      r"\g<1>{" + f"{held}, {held}" + "};", text)
        if form == "held":
            text = re.sub(r"static_assert\([^;]*\);", "", text)
        with open(path, "w") as f:
            f.write(text)
    return out


@contextlib.contextmanager
def sources_from(csrc):
    """Within the block the wrappers launch libraries built from the
    sources in the directory ``csrc`` (built at first use)."""
    global CSRC_DIR
    saved = CSRC_DIR, dict(_libraries)
    CSRC_DIR = csrc
    _libraries.clear()
    try:
        yield
    finally:
        CSRC_DIR = saved[0]
        _libraries.clear()
        _libraries.update(saved[1])


def load(name):
    """The loaded ``ctypes`` library ``name`` (see :func:`library_path`),
    built if needed."""
    if name not in _libraries:
        build(name)
        _libraries[name] = ctypes.CDLL(library_path(name)[1])
    return _libraries[name]
