// The adaptive convective adjustment of the PyTorch port as one launch:
// gcmiipy_tpu_torch/physics/convection.py:convective_adjustment with
// adaptive=True, whose plain version is the loop there (the plain version
// runs on CPU tensors and with adaptive=False).
//
// It replaces no TPU kernel: the JAX package runs its adaptive convection
// as plain jnp in a lax.while_loop (gcmiipy_tpu/physics/convection.py),
// and K7's epilogue (column_physics.cuh) holds only the fixed-sweep form.
// The plain loop on the card makes about 19 launches a layer pair and
// reads a flag on the host after every sweep; this kernel makes one
// launch a call and no host read.
//
// One thread per (j,i) column, coalesced over i, grid (ceil(W/kBlock), H).
// The column's temperatures, layer masses, log(p_k / p_k+1) and
// 1 / (m_k + m_k+1) are read once into dynamic shared memory laid out
// [array][k][thread], so that a warp's accesses fall on consecutive words
// and no per-layer array lives in local memory; at float64 with L = 32 a
// block of 128 threads takes 128 KB.  Above kConvHeld (56 layers at
// float64, the most whose four arrays fit; float32 holds every L up to
// kMaxLayers) the deep form
// (column_convection_deep) holds the temperatures alone and reads the
// masses and the tables from device memory at each pair of each sweep,
// slower than the held form at every L where both launch (PERF.md §6).
// The two constant tables come in as
// (L-1,H,W) tensors that the wrapper forms with PyTorch
// (ops/convection.py), so they round as the plain version's.
//
// The sweeps (convection_sweep.cuh) run bottom-up over the L-1 pairs, at
// most `sweeps` of them; each column stops after its first sweep in which
// none of its pairs was unstable.  The plain version stops after the first
// sweep in which no column changed.  A sweep that changes nothing leaves
// the column as it was, so every later sweep is the identity there too,
// and each column gets from its own stop what the global stop gives it, to
// the bit.  The largest number of sweeps any column ran goes to
// *sweeps_max with one atomicMax a block, after a warp reduction; no run
// function reads it.
//
// Every expression keeps the plain version's operand order as PyTorch
// evaluates it on the card: x / c with a Python float c is x * (1/c), the
// reciprocal formed in double and rounded to the working type (measured
// on the H100: at float32 that is not 1.0f / float(c)); a Python float
// operand rounds to the working type first; the library builds with
// -fmad=false, so each a*b+c rounds twice as PyTorch's separate
// elementwise ops do.
//
// Bound: bytes.  It reads tt, dp and the two tables and writes the result:
// 4L - 2 + L (H,W) planes, 90 MB at 9x512x1024 float32, 0.027 ms at
// 3.35 TB/s.

#include "convection_sweep.cuh"
#include "gcm_limits.cuh"

namespace gcm {

// Per-thread arrays of the column, in shared memory.
enum ConvArray { kColT, kColM, kColLr, kColIm, kConvArrays };

template <typename T>
struct ConvArgs {
  const T* tt;                  // (L,H,W), contiguous
  const T* dp;                  // (L,H,W) by the strides below (may broadcast)
  const T* log_ratio;           // (L-1,H,W): log(p_k / p_k+1), contiguous
  const T* inv_mass;            // (L-1,H,W): 1 / (m_k + m_k+1), contiguous
  T* out;                       // (L,H,W), contiguous
  int* sweeps_max;              // the largest sweep count of any column
  long long dp_k, dp_j, dp_i;   // dp's strides, in elements
  double rd, g, lapse;          // Python floats of the plain version
  int sweeps, L, H, W;
};

// Dynamic shared memory of a block of kBlock threads, in bytes: the
// column arrays (the deep form's: the temperatures alone), then one int a
// warp.
template <typename T, bool Deep = false>
inline size_t column_convection_bytes(int L) {
  return (size_t)(Deep ? 1 : kConvArrays) * L * kBlock * sizeof(T) + (kBlock / 32) * sizeof(int);
}

// The kernel's column: grid (ceil(W/kBlock), H), kBlock threads,
// column_convection_bytes<T, Deep>(L) of dynamic shared memory.  The deep
// form reads the masses and the two tables from device memory at each
// pair of each sweep.
template <typename T, bool Deep>
__device__ __forceinline__ void convection_body(const ConvArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int L = a.L, tid = threadIdx.x;
  constexpr int arrays = Deep ? 1 : kConvArrays;
  T* const col = reinterpret_cast<T*>(tile_smem) + tid;
  int* const warp_max =
      reinterpret_cast<int*>(reinterpret_cast<T*>(tile_smem) + (size_t)arrays * L * kBlock);
  auto at = [&](int n, int k) -> T& { return col[(n * L + k) * kBlock]; };
  const int j = blockIdx.y, i = blockIdx.x * kBlock + tid;
  int ran = 0;
  if (i < a.W) {
    const size_t HW = (size_t)a.H * a.W;
    const size_t c = (size_t)j * a.W + i;
    const T* const dp = a.dp + j * a.dp_j + i * a.dp_i;
    for (int k = 0; k < L; ++k) {
      at(kColT, k) = a.tt[k * HW + c];
      if constexpr (!Deep) at(kColM, k) = dp[k * a.dp_k];
    }
    if constexpr (!Deep) {
      for (int k = 0; k + 1 < L; ++k) {
        at(kColLr, k) = a.log_ratio[k * HW + c];
        at(kColIm, k) = a.inv_mass[k * HW + c];
      }
    }
    const T rd = T(a.rd), inv_g = T(1.0 / a.g), lapse = T(a.lapse);
    auto t = [&](int k) -> T& { return at(kColT, k); };
    auto m = [&](int k) { return Deep ? dp[k * a.dp_k] : at(kColM, k); };
    auto lr = [&](int k) { return Deep ? a.log_ratio[k * HW + c] : at(kColLr, k); };
    auto im = [&](int k) { return Deep ? a.inv_mass[k * HW + c] : at(kColIm, k); };
    while (ran < a.sweeps) {
      ++ran;
      if (!convection_sweep(L, rd, inv_g, lapse, t, m, lr, im)) break;
    }
    for (int k = 0; k < L; ++k) a.out[k * HW + c] = at(kColT, k);
  }
  // the block's largest sweep count, one atomic a block
  ran = __reduce_max_sync(0xffffffffu, ran);
  if ((tid & 31) == 0) warp_max[tid >> 5] = ran;
  __syncthreads();
  if (tid == 0) {
    int m = warp_max[0];
    for (int w = 1; w < kBlock / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(a.sweeps_max, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) column_convection(const ConvArgs<T> a) {
  convection_body<T, false>(a);
}

// The deep form, for more than kConvHeld layers.
template <typename T>
__global__ void __launch_bounds__(kBlock) column_convection_deep(const ConvArgs<T> a) {
  convection_body<T, true>(a);
}

}  // namespace gcm

namespace {

template <typename T>
int launch(gcm::ConvArgs<T> a, const void* tt, const void* dp, const void* log_ratio,
           const void* inv_mass, void* out, int* launches, cudaStream_t stream) {
  *launches = 0;
  if (gcm::bad_shape(a.L, a.H, a.W) || a.L < 2 || a.sweeps < 0)
    return (int)cudaErrorInvalidValue;
  a.tt = static_cast<const T*>(tt);
  a.dp = static_cast<const T*>(dp);
  a.log_ratio = static_cast<const T*>(log_ratio);
  a.inv_mass = static_cast<const T*>(inv_mass);
  a.out = static_cast<T*>(out);
  const dim3 grid((a.W + gcm::kBlock - 1) / gcm::kBlock, a.H);
  static_assert(gcm::kConvArrays * gcm::held_layers<T>(gcm::kConvHeld) * gcm::kBlock * sizeof(T) +
                    (gcm::kBlock / 32) * sizeof(int) <=
                    gcm::kMaxSharedBytes,
                "the convection's held form exceeds a block's shared memory");
  if (a.L > gcm::held_layers<T>(gcm::kConvHeld))
    return gcm::launch_kernel(gcm::column_convection_deep<T>, grid, gcm::kBlock,
                              gcm::column_convection_bytes<T, true>(a.L), stream, launches, a);
  return gcm::launch_kernel(gcm::column_convection<T>, grid, gcm::kBlock,
                            gcm::column_convection_bytes<T>(a.L), stream, launches, a);
}

}  // namespace

// The adaptive convective adjustment of tt (L,H,W) into out (L,H,W), both
// contiguous.  dp: the layer masses by the strides dp_k, dp_j, dp_i (in
// elements; 0 where broadcast).  log_ratio, inv_mass: (L-1,H,W),
// contiguous.  rd, g, lapse: the gas constant, gravity and the critical
// lapse rate; sweeps: the most sweeps a column runs.  sweeps_max: one int
// in device memory, raised to the largest sweep count of any column.
// *launches: set to the launches made.  Returns 0 or the CUDA error.
extern "C" int gcm_convection(int is_double, const void* tt, const void* dp, long long dp_k,
                              long long dp_j, long long dp_i, const void* log_ratio,
                              const void* inv_mass, void* out, int* sweeps_max, double rd,
                              double g, double lapse, int sweeps, int L, int H, int W,
                              int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    gcm::ConvArgs<double> a{};
    a.sweeps_max = sweeps_max;
    a.dp_k = dp_k; a.dp_j = dp_j; a.dp_i = dp_i;
    a.rd = rd; a.g = g; a.lapse = lapse;
    a.sweeps = sweeps; a.L = L; a.H = H; a.W = W;
    return launch<double>(a, tt, dp, log_ratio, inv_mass, out, launches, st);
  }
  gcm::ConvArgs<float> a{};
  a.sweeps_max = sweeps_max;
  a.dp_k = dp_k; a.dp_j = dp_j; a.dp_i = dp_i;
  a.rd = rd; a.g = g; a.lapse = lapse;
  a.sweeps = sweeps; a.L = L; a.H = H; a.W = W;
  return launch<float>(a, tt, dp, log_ratio, inv_mass, out, launches, st);
}
