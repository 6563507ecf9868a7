// K7's column-physics epilogue: the per-step grey radiation, the
// fixed-sweep convective adjustment and the surface drag that
// gcmiipy_tpu/ops/pallas_stream.py:make_stream_kernel runs inside each of
// its steps (physics_epilogue, :314-347).  The plain version is
// gcmiipy_tpu_torch/ops/stream_steps.py:physics_epilogue_ref.
//
// One thread per (j,i) column, coalesced over i.  Its per-layer values
// live in dynamic shared memory, laid out [array][k][thread] so that a
// warp's accesses fall on consecutive words: the Exner factor, the true
// temperature, each layer's emission, the downward absorption and, for
// the convective sweeps, log(p_k / p_k+1) and 1 / (m_k + m_k+1).  The
// layer pressure p*sig_k + ptop and mass p*dsig_k are formed again where
// they are needed: one expression rounds the same each time.  The block
// stages the table's per-layer rows in shared memory too, converted to the
// working type once.  So no per-layer array lives in local memory; at
// float64 with L = 32 a block of 128 threads takes 198 KB.  Above
// kPhysHeld (12 layers at float32, 9 at float64) the deep form (column_physics_deep) keeps three arrays, the
// true temperature, the emission and the downward absorption, puts the
// pair terms of the sweeps in the last two as the upward sweep frees them,
// and forms the Exner factor again for the result: 201 KB at float64 with
// L = 64 (kMaxLayers).  The
// transmittances t^dsig and their cumulative products are computed on the
// host in double and come in the table, as the JAX kernel's Python floats,
// and so do the other per-layer constants such as G / (Cp dsig_k).  The
// table lives in device memory (a kernel parameter indexed by a runtime k
// would be copied to the stack).
//
// The column's work: the Exner factor, the true temperature and the
// grey-radiation ladder (the emission of each layer, the downward and
// upward absorption sweeps), the ground's budget, then the adjustment
// sweeps over the layer pairs (physics/convection.py, one sweep of
// convection_sweep.cuh each), and the drag on layer 0 of u and v.
//
// The clock of step s is utc0 + s*dt in the working type, utc0 read from
// the state's 0-dim tensor in device memory (no host read).  The ground
// temperature is read from the step's source buffer and written to its
// destination: the dynamics stages never write that plane.  Every other
// field is the destination's, updated in place (the work is column-local).
//
// Every expression keeps the plain version's operand order as PyTorch
// evaluates it on the card: a Python float operand rounds to the working
// type first, x / c with a Python float c is x * (1/c), c / x is (1/x) * c,
// x ** c is pow(x, c); the library builds with -fmad=false.
//
// Bound: bytes.  It reads p, t, the ground temperature, u[0] and v[0] and
// writes t, the ground temperature, u[0] and v[0]: 2L + 7 (H,W) planes,
// 52 MB at 9x512x1024 float32, 0.016 ms at 3.35 TB/s (chip_smoke.py counts
// its operations).  On the H100 the launch is held back by instruction
// issue, not bytes: two pow and a log a layer, the divisions and the
// sines and cosines are the CUDA math library's long instruction
// sequences (PERF.md).

#pragma once

#include "convection_sweep.cuh"
#include "gcm_stencil.cuh"

namespace gcm {

__device__ __forceinline__ float logarithm(float x) { return logf(x); }
__device__ __forceinline__ double logarithm(double x) { return log(x); }

// The physics table, as ops/stream_steps.py:physics_table lays it out:
// kPhysScalars doubles, then kPhysRows rows of kMaxLayers per-layer ones.
enum PhysScalar {
  kDt, kPtop, kP0, kKappa, kSb, kSolar, kCg, kOneMinusAlbedo, kCumSwTop0, kDrag,
  kDragFactor, kSweeps, kSeasonal, kNegObliquity, kYearDays, kRd, kG, kLapse, kTwoPi, kPi,
  kPhysScalars
};
enum PhysRow {
  kSig,         // sigma of the layer midpoint
  kDsig,        // sigma thickness
  kEmis,        // (1 - lw_t) * sb
  kClw,         // clw_b_div: product of lw_t below the layer
  kOneMinusLw,  // 1 - lw_t
  kLw,          // lw_t = t_lw ** dsig
  kUn,          // clw_b_div * (1 - lw_t)
  kSn,          // (1 - sw_t) * cum_sw_top / sw_t
  kHeat,        // G / (Cp * dsig)
  kPhysRows
};

constexpr int kPhysTableSize = kPhysScalars + kPhysRows * kMaxLayers;

// Per-thread arrays of the column, in shared memory after the rows.  The
// deep form keeps three: the true temperature, each layer's emission (then
// 1 / (m_k + m_k+1)) and the downward absorption (then log(p_k / p_k+1)),
// and forms the Exner factor again where it is needed.
enum PhysArray { kEx, kTt, kEm, kLwa, kLr, kIm, kPhysArrays };
enum DeepArray { kDeepTt, kDeepEm, kDeepLwa, kDeepArrays };

template <typename T>
struct ColumnArgs {
  const T* p;          // (H,W) surface pressure of the new state
  T *t, *u0, *v0;      // t (L,H,W) and layer 0 of u and v, in place
  const T* gt_in;      // (H,W) ground temperature at the start of the step
  T* gt_out;           // (H,W) ground temperature after it
  const T *lat, *lon;  // (H) and (W) [rad]
  const T* utc;        // 0-dim: the clock at the start of the call
  const double* table; // (kPhysTableSize) in device memory
  int step;            // the step's index in the call
  int L, H, W;
};

// Dynamic shared memory of a block of kBlock threads, in bytes.
template <typename T, bool Deep = false>
inline size_t column_physics_bytes(int L) {
  return (size_t)(kPhysRows + (Deep ? kDeepArrays : kPhysArrays) * kBlock) * L * sizeof(T);
}
static_assert((kPhysRows + kDeepArrays * kBlock) * kMaxLayers * sizeof(double) <= kMaxSharedBytes,
              "the epilogue's deep form exceeds a block's shared memory");

// The epilogue's column: its kernel, grid (ceil(W/kBlock), H), kBlock
// threads, column_physics_bytes<T, Deep>(L) of dynamic shared memory.
template <typename T, bool Deep>
__device__ __forceinline__ void column_physics_body(const ColumnArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* const sm = reinterpret_cast<T*>(tile_smem);
  const int L = a.L, tid = threadIdx.x;
  const double* const c = a.table;
  // the table's per-layer rows in T: row r, layer k at sm[r*L + k]
  for (int e = tid; e < kPhysRows * L; e += kBlock) {
    const int r = e / L;
    sm[e] = T(c[kPhysScalars + r * kMaxLayers + (e - r * L)]);
  }
  __syncthreads();
  const int i = blockIdx.x * kBlock + tid;
  if (i >= a.W) return;
  auto row = [&](int r, int k) { return sm[r * L + k]; };
  T* const arrays = sm + kPhysRows * L + tid;
  auto at = [&](int n, int k) -> T& { return arrays[(n * L + k) * kBlock]; };
  // the arrays of the held form by name, and the deep form's in their place
  auto tt_at = [&](int k) -> T& { return at(Deep ? kDeepTt : kTt, k); };
  auto em_at = [&](int k) -> T& { return at(Deep ? kDeepEm : kEm, k); };
  auto lwa_at = [&](int k) -> T& { return at(Deep ? kDeepLwa : kLwa, k); };
  auto lr_at = [&](int k) -> T& { return at(Deep ? kDeepLwa : kLr, k); };
  auto im_at = [&](int k) -> T& { return at(Deep ? kDeepEm : kIm, k); };

  const int j = blockIdx.y;
  const size_t HW = (size_t)a.H * a.W;
  const size_t col = (size_t)j * a.W + i;
  const T one = T(1), zero = T(0);
  const T dt = T(c[kDt]);
  const T p = a.p[col];
  const T ptop = T(c[kPtop]);
  const int sweeps = (int)c[kSweeps];
  const bool convect = sweeps > 0 && L > 1;

  // the clock at the start of this step, and the clamped cos(zenith)
  const T utc = a.utc[0] + T(a.step) * dt;
  T sin_d = zero, cos_d = one;
  if (c[kSeasonal] != 0.0) {
    const T d = utc * (one / T(86400.0));
    const T decl = T(c[kNegObliquity]) *
                   cosine((T(c[kTwoPi]) * (d + T(10.0))) * (one / T(c[kYearDays])));
    sin_d = sine(decl);
    cos_d = cosine(decl);
  }
  const T hour = ((utc * (one / T(-86400.0))) * T(2)) * T(c[kPi]);
  const T lat = a.lat[j];
  T sza = sine(lat) * sin_d + (cosine(lat) * cos_d) * cosine(a.lon[i] + hour);
  sza = sza < zero ? zero : sza;

  // Exner factor, true temperature and each layer's emission; for the
  // sweeps log(p_k / p_k+1) and 1 / (m_k + m_k+1)
  const T p0 = T(c[kP0]), kappa = T(c[kKappa]);
  auto layer_p = [&](int k) { return p * row(kSig, k) + ptop; };
  auto exner = [&](int k) { return power((one / layer_p(k)) * p0, kappa); };
  // log(p_k / p_k+1) and 1 / (m_k + m_k+1) of the pair (k-1, k)
  auto pair_terms = [&](int k) {
    lr_at(k - 1) = logarithm(layer_p(k - 1) / layer_p(k));
    im_at(k - 1) = one / (p * row(kDsig, k - 1) + p * row(kDsig, k));
  };
  T tp_prev = zero, m_prev = zero;
  for (int k = 0; k < L; ++k) {
    const T tp = layer_p(k);
    const T ex = power((one / tp) * p0, kappa);
    const T tt = a.t[k * HW + col] / ex;
    if constexpr (!Deep) at(kEx, k) = ex;
    tt_at(k) = tt;
    em_at(k) = row(kEmis, k) * power(tt, T(4));
    if (convect && !Deep) {
      const T m = p * row(kDsig, k);
      if (k > 0) {
        lr_at(k - 1) = logarithm(tp_prev / tp);
        im_at(k - 1) = one / (m_prev + m);
      }
      tp_prev = tp;
      m_prev = m;
    }
  }

  // the ground's budget
  T B = em_at(0) * row(kClw, 0);
  for (int k = 1; k < L; ++k) B = B + em_at(k) * row(kClw, k);
  const T Sc = T(c[kSolar]) * sza;
  const T S = (T(c[kOneMinusAlbedo]) * Sc) * T(c[kCumSwTop0]);
  const T gt = a.gt_in[col];
  const T U_s = T(c[kSb]) * power(gt, T(4));
  const T dtg = (((B + S) - U_s) * (one / T(c[kCg]))) * (one / T(0.1));
  a.gt_out[col] = gt + dtg * dt;

  // downwelling LW absorption, top -> bottom
  T d = zero;
  for (int k = L - 1; k >= 0; --k) {
    lwa_at(k) = d * row(kOneMinusLw, k);
    d = d * row(kLw, k) + em_at(k);
  }
  // upwelling from layer emission only, bottom -> top, and the heating;
  // the deep form then puts the pair terms of (k-1, k) where layer k-1's
  // emission and absorption were
  d = zero;
  for (int k = 0; k < L; ++k) {
    const T em = em_at(k);
    const T lwb = d * row(kOneMinusLw, k);
    d = d * row(kLw, k) + em;
    const T U_n = row(kUn, k) * U_s;
    const T S_n = row(kSn, k) * Sc;
    const T dTdt = ((((U_n + S_n) - T(2) * em) + lwa_at(k)) + lwb) * row(kHeat, k) / p;
    tt_at(k) = tt_at(k) + dTdt * dt;
    if (Deep && convect && k > 0) pair_terms(k);
  }

  // fixed-sweep convective adjustment, bottom-up over the layer pairs
  if (convect) {
    const T rd = T(c[kRd]), inv_g = one / T(c[kG]), lapse = T(c[kLapse]);
    auto m = [&](int k) { return p * row(kDsig, k); };
    for (int sw = 0; sw < sweeps; ++sw)
      convection_sweep(L, rd, inv_g, lapse, tt_at, m, lr_at, im_at);
  }
  for (int k = 0; k < L; ++k) a.t[k * HW + col] = tt_at(k) * (Deep ? exner(k) : at(kEx, k));

  if (c[kDrag] != 0.0) {
    const T f = T(c[kDragFactor]);
    a.u0[col] = a.u0[col] * f;
    a.v0[col] = a.v0[col] * f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) column_physics(const ColumnArgs<T> a) {
  column_physics_body<T, false>(a);
}

// The deep form, for more than kPhysHeld layers: three arrays of L a
// thread in place of six.  It forms each layer's Exner factor a second
// time for the result (a pow a layer more than the held form) and the
// pair terms in the upward sweep.
template <typename T>
__global__ void __launch_bounds__(kBlock) column_physics_deep(const ColumnArgs<T> a) {
  column_physics_body<T, true>(a);
}

// Launch the epilogue on the caller's stream, its deep form above
// kPhysHeld layers; returns 0 or the CUDA error of the attribute call or
// the launch.  A launch that was accepted adds one to *launches (when not
// null).
template <typename T>
int launch_column_physics(const ColumnArgs<T>& a, cudaStream_t stream, int* launches) {
  const dim3 grid((a.W + kBlock - 1) / kBlock, a.H);
  static_assert((kPhysRows + kPhysArrays * kBlock) * held_layers<T>(kPhysHeld) * sizeof(T) <=
                    kMaxSharedBytes,
                "the epilogue's held form exceeds a block's shared memory");
  if (a.L > held_layers<T>(kPhysHeld))
    return launch_kernel(column_physics_deep<T>, grid, kBlock, column_physics_bytes<T, true>(a.L),
                        stream, launches, a);
  return launch_kernel(column_physics<T>, grid, kBlock, column_physics_bytes<T>(a.L), stream,
                      launches, a);
}

}  // namespace gcm
