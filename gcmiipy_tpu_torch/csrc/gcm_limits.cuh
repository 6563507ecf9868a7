// The limits every kernel source of the port launches within: the most
// layers a column holds (ops/fused_parts.py's MAX_LAYERS), the threads of a
// block and a block's shared memory; and the launch with dynamic shared
// memory that the sources share.  Kept apart from gcm_stencil.cuh,
// which calls power, so that a source that includes only this needs no
// float64 library of its own (ops/cuda_lib.py:calls_power).
//
// Each kernel that keeps a column in shared memory has two forms, chosen
// by L and the type at its C entry.  Its held form holds every layer of the column
// there: the pgf tile's rho and phi planes, the rest tile's sd planes, the
// epilogue's six per-thread arrays and the adaptive convection's four.
// Its deep form takes the same shared memory whatever L is, or less of
// it: the pgf and rest tiles stream their columns through the layers (two
// planes each), the epilogue keeps three arrays and forms the others
// again, the convection keeps only the temperatures.  A kernel launches
// its held form up to its HeldLayers below and its deep form above.
//
// What bounds kMaxLayers is the epilogue's deep form at float64: kPhysRows
// rows and three arrays of 128 threads, (9 + 3 * 128) * L * 8 bytes within
// kMaxSharedBytes, L <= 73.  64 is taken: it holds ModelE3's 62 layers and
// keeps the physics table's rows short.

#pragma once

#include <cuda_runtime.h>

namespace gcm {

constexpr int kMaxLayers = 64;

// The largest L at which a column kernel launches its held form, at
// float32 and at float64.  Each is read from the two forms timed against
// each other at 512x1024 on the H100 (chip_smoke.py forms; PERF.md §6): the
// largest L measured at which the held form was the faster.  The
// convection's held form was the faster at every L measured, so it holds
// up to kMaxLayers at float32 and, at float64, up to the most layers whose
// block fits in kMaxSharedBytes.
struct HeldLayers {
  int f32, f64;
};
constexpr HeldLayers kPgfHeld = {40, 40};
constexpr HeldLayers kRestHeld = {16, 0};
constexpr HeldLayers kPhysHeld = {12, 9};
constexpr HeldLayers kConvHeld = {64, 56};

template <typename T>
constexpr int held_layers(HeldLayers held) {
  return sizeof(T) == 8 ? held.f64 : held.f32;
}

constexpr int kBlock = 128;
constexpr int kMaxSharedBytes = 232448;  // a block's shared memory on Hopper

inline bool bad_shape(int L, int H, int W) {
  return L < 1 || L > kMaxLayers || H < 1 || H > 65535 || W < 1;
}

// Launch kernel on the caller's stream with bytes of dynamic shared
// memory; returns 0 or the CUDA error of the attribute call or the
// launch.  A launch that was accepted adds one to *launches (when not
// null).
template <class Kernel, class... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t bytes, cudaStream_t stream,
                  int* launches, const Args&... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess && launches) ++*launches;
  return (int)launched;
}

}  // namespace gcm
