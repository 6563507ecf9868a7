// K7's column-physics epilogue: the per-step grey radiation, the
// fixed-sweep convective adjustment and the surface drag that
// gcmiipy_tpu/ops/pallas_stream.py:make_stream_kernel runs inside each of
// its steps (physics_epilogue, :314-347).  The plain version is
// gcmiipy_tpu_torch/ops/stream_steps.py:physics_epilogue_ref.
//
// One thread per (j,i) column holds its L <= 32 layers: the Exner factor,
// the true temperature and the grey-radiation ladder (the emission of each
// layer, the downward and upward absorption sweeps), the ground's budget,
// then the adjustment sweeps over the layer pairs, and the drag on layer
// 0 of u and v.  The transmittances t^dsig and their cumulative products
// are computed on the host in double and come in the PhysTable, as the
// JAX kernel's Python floats, and so do the other per-layer constants
// such as G / (Cp dsig_k).  log(p_k / p_k+1) and 1 / (m_k + m_k+1) are computed
// once per column, before the sweeps (physics/convection.py).
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
// its operations).

#pragma once

#include "gcm_stencil.cuh"

namespace gcm {

__device__ __forceinline__ float cosine(float x) { return cosf(x); }
__device__ __forceinline__ double cosine(double x) { return cos(x); }
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

struct PhysTable {
  double s[kPhysScalars];
  double r[kPhysRows][kMaxLayers];
};

template <typename T>
struct ColumnArgs {
  const T* p;          // (H,W) surface pressure of the new state
  T *t, *u0, *v0;      // t (L,H,W) and layer 0 of u and v, in place
  const T* gt_in;      // (H,W) ground temperature at the start of the step
  T* gt_out;           // (H,W) ground temperature after it
  const T *lat, *lon;  // (H) and (W) [rad]
  const T* utc;        // 0-dim: the clock at the start of the call
  int step;            // the step's index in the call
  int L, H, W;
};

template <typename T>
__global__ void __launch_bounds__(kBlock) column_physics(const ColumnArgs<T> a, const PhysTable c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  const int j = blockIdx.y, L = a.L;
  const size_t HW = (size_t)a.H * a.W;
  const size_t col = (size_t)j * a.W + i;
  const T one = T(1), zero = T(0);
  const T dt = T(c.s[kDt]);
  const T p = a.p[col];

  // the clock at the start of this step, and the clamped cos(zenith)
  const T utc = a.utc[0] + T(a.step) * dt;
  T sin_d = zero, cos_d = one;
  if (c.s[kSeasonal] != 0.0) {
    const T d = utc * (one / T(86400.0));
    const T decl = T(c.s[kNegObliquity]) *
                   cosine((T(c.s[kTwoPi]) * (d + T(10.0))) * (one / T(c.s[kYearDays])));
    sin_d = sine(decl);
    cos_d = cosine(decl);
  }
  const T hour = ((utc * (one / T(-86400.0))) * T(2)) * T(c.s[kPi]);
  const T lat = a.lat[j];
  T sza = sine(lat) * sin_d + (cosine(lat) * cos_d) * cosine(a.lon[i] + hour);
  sza = sza < zero ? zero : sza;

  // Exner factor, true temperature and each layer's emission
  T tp[kMaxLayers], ex[kMaxLayers], tt[kMaxLayers], em[kMaxLayers], lwa[kMaxLayers];
  for (int k = 0; k < L; ++k) {
    tp[k] = p * T(c.r[kSig][k]) + T(c.s[kPtop]);
    ex[k] = power((one / tp[k]) * T(c.s[kP0]), T(c.s[kKappa]));
    tt[k] = a.t[k * HW + col] / ex[k];
    em[k] = T(c.r[kEmis][k]) * power(tt[k], T(4));
  }

  // the ground's budget
  T B = em[0] * T(c.r[kClw][0]);
  for (int k = 1; k < L; ++k) B = B + em[k] * T(c.r[kClw][k]);
  const T Sc = T(c.s[kSolar]) * sza;
  const T S = (T(c.s[kOneMinusAlbedo]) * Sc) * T(c.s[kCumSwTop0]);
  const T gt = a.gt_in[col];
  const T U_s = T(c.s[kSb]) * power(gt, T(4));
  const T dtg = (((B + S) - U_s) * (one / T(c.s[kCg]))) * (one / T(0.1));
  a.gt_out[col] = gt + dtg * dt;

  // downwelling LW absorption, top -> bottom
  T d = zero;
  for (int k = L - 1; k >= 0; --k) {
    lwa[k] = d * T(c.r[kOneMinusLw][k]);
    d = d * T(c.r[kLw][k]) + em[k];
  }
  // upwelling from layer emission only, bottom -> top, and the heating
  d = zero;
  for (int k = 0; k < L; ++k) {
    const T lwb = d * T(c.r[kOneMinusLw][k]);
    d = d * T(c.r[kLw][k]) + em[k];
    const T U_n = T(c.r[kUn][k]) * U_s;
    const T S_n = T(c.r[kSn][k]) * Sc;
    const T dTdt = ((((U_n + S_n) - T(2) * em[k]) + lwa[k]) + lwb) * T(c.r[kHeat][k]) / p;
    tt[k] = tt[k] + dTdt * dt;
  }

  // fixed-sweep convective adjustment, bottom-up over the layer pairs
  const int sweeps = (int)c.s[kSweeps];
  if (sweeps > 0 && L > 1) {
    T m[kMaxLayers], lr[kMaxLayers], im[kMaxLayers];
    for (int k = 0; k < L; ++k) m[k] = p * T(c.r[kDsig][k]);
    for (int k = 0; k + 1 < L; ++k) {
      lr[k] = logarithm(tp[k] / tp[k + 1]);
      im[k] = one / (m[k] + m[k + 1]);
    }
    const T rd = T(c.s[kRd]), inv_g = one / T(c.s[kG]), lapse = T(c.s[kLapse]);
    for (int sw = 0; sw < sweeps; ++sw) {
      for (int k = 0; k + 1 < L; ++k) {
        const T t_dn = tt[k], t_up = tt[k + 1];
        const T tbar = T(0.5) * (t_dn + t_up);
        const T dz = ((rd * tbar) * inv_g) * lr[k];
        const T D = lapse * dz;
        if (t_up < t_dn - D) {
          const T t_dn_new = ((m[k] * t_dn + m[k + 1] * t_up) + m[k + 1] * D) * im[k];
          tt[k] = t_dn_new;
          tt[k + 1] = t_dn_new - D;
        }
      }
    }
  }
  for (int k = 0; k < L; ++k) a.t[k * HW + col] = tt[k] * ex[k];

  if (c.s[kDrag] != 0.0) {
    const T f = T(c.s[kDragFactor]);
    a.u0[col] = a.u0[col] * f;
    a.v0[col] = a.v0[col] * f;
  }
}

}  // namespace gcm
