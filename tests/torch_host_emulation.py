"""Test helper: run the port's CUDA sources on the CPU, where there is no card.

Each ``csrc/<name>.cu`` is built by the host C++ compiler (``g++``) against a
small emulation of the CUDA subset the kernels use: one ``std::thread`` per
CUDA thread of a block, the blocks one after another, a ``std::barrier`` for
``__syncthreads``, ``cp.async`` as a plain copy and the launch syntax
rewritten into a call.  Inside :func:`kernels_on_cpu` the wrappers take CPU
tensors down their kernel path and call the emulated library::

    with kernels_on_cpu(build_dir):
        out = pgf_rest.rest_parts(...)   # the CUDA source's code, on the CPU

It checks what the sources compute (indexing, tiles, halos, the order of
their stages).  The card's own ``pow`` and ``sin``, its memory model and
anything about speed only a card shows.  Inside :func:`host_pow` a plain
version's ``x ** c`` calls the C library's ``pow``/``powf``, which the
emulated kernels call, so that a kernel and its plain version can be held
to the bit where ``pow`` is the only function they share; inside
:func:`card_division` a plain version's ``x / c`` is ``x * (1/c)``, as
PyTorch computes it on CUDA and the kernels compute it.
"""

import contextlib
import ctypes
import ctypes.util
import hashlib
import os
import re
import shutil
import subprocess
import types

import torch

from gcmiipy_tpu_torch.ops import (convection, cuda_lib, fused_parts, mega_half,
                                   mega_step, pgf_rest, radiation,
                                   stream_steps)

# the wrappers that choose their plain version by on_cpu
WRAPPERS = (fused_parts, pgf_rest, mega_step, mega_half, stream_steps,
            convection, radiation)

# Stands in for cuda_runtime.h and cuda_pipeline.h.
HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct double2 { double x, y; };
inline double2 make_double2(double a, double b) { return {a, b}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// a warp's max, where every thread of the block calls it together
inline int emu_lanes[1024];
inline int __reduce_max_sync(unsigned, int v) {
  const unsigned t = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const unsigned n = blockDim.x * blockDim.y * blockDim.z;
  emu_lanes[t] = v;
  __syncthreads();
  int m = v;
  for (unsigned l = t & ~31u; l < (t | 31u) + 1 && l < n; ++l) m = m < emu_lanes[l] ? emu_lanes[l] : m;
  __syncthreads();
  return m;
}
inline std::mutex emu_atomic;
inline int atomicMax(int* p, int v) {
  std::lock_guard<std::mutex> hold(emu_atomic);
  const int old = *p;
  if (v > old) *p = v;
  return old;
}
// the card refuses more dynamic shared memory than a block has
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n, size_t = 0) {
  std::memcpy(d, s, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline float sinf(float x) { return std::sin(x); }
inline float powf(float x, float y) { return std::pow(x, y); }
using std::cos; using std::exp; using std::pow; using std::sin; using std::sqrt;
template <class F>
inline void emu_launch(dim3 g, dim3 b, size_t, cudaStream_t, F body) {
  gridDim = g;
  blockDim = b;
  const unsigned n = b.x * b.y * b.z;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        std::barrier<> bar(n);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
            blockIdx = dim3(bx, by, bz);
            body();
            bar.arrive_and_drop();
          });
        for (auto& th : threads) th.join();
      }
}
"""

# The dynamic shared memory the kernels declare extern, one block at a time.
SHARED = """
namespace gcm {
alignas(16) unsigned char tile_smem[1 << 18];
double2 fft_smem[1 << 16];
}
"""


def _split_top(text):
    """``text`` split at the commas outside any brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch in "(<[") - (ch in ")>]")
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def rewrite_launches(source):
    """Each ``kernel<<<grid, block[, smem[, stream]]>>>(args)`` as
    ``emu_launch(grid, block, smem, stream, [&]() { kernel(args); })``."""
    out, pos = [], 0
    for m in re.finditer(r"<<<", source):
        if m.start() < pos:
            continue
        start, depth = m.start(), 0   # back to the start of the kernel's name
        while start > 0:
            ch = source[start - 1]
            depth += (ch == ">") - (ch == "<")
            if depth == 0 and (ch.isspace() or ch in ";{}("):
                break
            start -= 1
        close = source.index(">>>", m.end())
        end, depth = close + 3, 0     # the argument list's closing bracket
        while True:
            depth += (source[end] == "(") - (source[end] == ")")
            if depth == 0:
                break
            end += 1
        config = (_split_top(source[m.end():close]) + ["0", "0"])[:4]
        out += [source[pos:start], f"emu_launch({', '.join(config)}, [&]() {{ "
                f"{source[start:m.start()]}({source[close + 4:end]}); }})"]
        pos = end + 1
    return "".join(out) + source[pos:]


def build(name, build_dir, flags=()):
    """Build the emulated ``csrc/<name>.cu`` in ``build_dir`` unless built;
    returns the library's path.  Raises with the compiler's log."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the host emulation needs it")
    digest = hashlib.sha256((HEADER + " ".join(flags)).encode())
    sources = sorted(os.listdir(cuda_lib.CSRC_DIR))
    for fname in sources:
        with open(os.path.join(cuda_lib.CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    root = os.path.join(build_dir, digest.hexdigest()[:16])
    lib = os.path.join(root, name + ".so")
    if os.path.exists(lib):
        return lib
    src = os.path.join(root, "src")
    os.makedirs(src, exist_ok=True)
    for fname in sources:
        with open(os.path.join(cuda_lib.CSRC_DIR, fname)) as f:
            text = rewrite_launches(f.read())
        with open(os.path.join(src, fname), "w") as f:
            f.write(text)
    for stub in ("cuda_runtime.h", "cuda_pipeline.h"):
        with open(os.path.join(src, stub), "w") as f:
            f.write(HEADER)
    unit = os.path.join(root, name + ".cpp")
    with open(unit, "w") as f:
        f.write(f'#include "src/{name}.cu"\n{SHARED}')
    tmp = f"{lib}.tmp{os.getpid()}"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", src, *flags, "-o", tmp, unit, "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


@contextlib.contextmanager
def kernels_on_cpu(build_dir, flags=()):
    """Within the block, the wrappers launch their emulated kernels on CPU
    tensors (built in ``build_dir`` at first use, with extra compiler
    ``flags``) instead of running their plain versions."""
    libraries = {}

    def load(name):
        # one emulated library serves both types: the host has one pow
        source = name.removesuffix(cuda_lib.FLOAT64)
        if source not in libraries:
            libraries[source] = ctypes.CDLL(build(source, build_dir, flags))
        return libraries[source]

    saved = ([(cuda_lib, "load", cuda_lib.load),
              (torch.cuda, "device", torch.cuda.device),
              (torch.cuda, "current_stream", torch.cuda.current_stream)]
             + [(m, "on_cpu", m.on_cpu) for m in WRAPPERS])
    cuda_lib.load = load
    torch.cuda.device = lambda device: contextlib.nullcontext()
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(
        cuda_stream=0)
    for m in WRAPPERS:
        m.on_cpu = lambda kernel, fields: False
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.pow.restype, _LIBM.pow.argtypes = ctypes.c_double, [ctypes.c_double] * 2
_LIBM.powf.restype, _LIBM.powf.argtypes = ctypes.c_float, [ctypes.c_float] * 2


@contextlib.contextmanager
def card_division():
    """Within the block, ``tensor / c`` with a Python float ``c`` on a
    float32 or float64 CPU tensor is ``tensor * (1/c)``, the reciprocal
    formed in double and rounded to the tensor's type, as PyTorch computes
    it on CUDA (measured on an H100), where on the CPU it divides."""
    div = torch.Tensor.__truediv__

    def card_div(x, c):
        if (not isinstance(c, float) or x.device.type != "cpu"
                or x.dtype not in (torch.float32, torch.float64)):
            return div(x, c)
        return x * torch.tensor(1.0 / c, dtype=x.dtype)

    torch.Tensor.__truediv__ = card_div
    try:
        yield
    finally:
        torch.Tensor.__truediv__ = div


@contextlib.contextmanager
def host_pow():
    """Within the block, ``tensor ** c`` with a Python float ``c`` on a
    float32 or float64 CPU tensor is the C library's ``powf``/``pow`` of
    each element and ``c`` rounded to the tensor's type, as the emulated
    kernels compute ``power(x, T(c))``."""
    pow_ = torch.Tensor.__pow__

    def libm_pow(x, c):
        if (not isinstance(c, float) or x.device.type != "cpu"
                or x.dtype not in (torch.float32, torch.float64)):
            return pow_(x, c)
        f = _LIBM.pow if x.dtype == torch.float64 else _LIBM.powf
        out = [f(e, c) for e in x.reshape(-1).tolist()]
        return torch.tensor(out, dtype=x.dtype).reshape(x.shape)

    torch.Tensor.__pow__ = libm_pow
    try:
        yield
    finally:
        torch.Tensor.__pow__ = pow_
