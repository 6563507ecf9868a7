// The four-band radiation of the PyTorch port and its update as one launch:
// gcmiipy_tpu_torch/physics/radiation.py:four_band_radiation followed by
// the two updates of model/driver.py:solar_timestep, gt + dt_ground * dt
// and tt + dt_air * dt.  The plain version is that function and those two
// lines, which run on CPU tensors.
//
// It replaces no TPU kernel: the JAX package runs its four-band radiation
// as plain jnp, which XLA fuses.  The plain version on the card is about
// 255 launches a call (Python loops over the layers, per-band stacks, two
// cumprods, the Planck fractions' Horner loops twice); this is one.
//
// One thread per (j,i) column, coalesced over i, grid (ceil(W/kBlock), H),
// in two sweeps over the layers.  The first, top-down, forms each layer's
// four transmittances exp(-1.66 eps_b) and emissions f_b (1 - t_b) sb tt^4
// (the Planck fractions f_b by the same degree-6 Horner polynomials, on
// the same clamped variable) and the downward ladder's absorption LWA_a,
// the one per-layer value kept, in dynamic shared memory laid out
// [k][thread] (L * kBlock values: 4.6 KB at 9 layers float32, 64 KB at
// kMaxLayers float64, so one form serves every L).  The second, bottom-up,
// forms the transmittances and emissions again from tt and q (re-read;
// the block's columns are still in L2) rather than keep eight values a
// layer, and with them the exclusive products below each layer (a running
// product: no division, as the plain version avoids 0/0 in an opaque
// band), the ground's sum B, the ground's emission absorbed in each layer,
// the upward ladder, the heating and the updated layer.  The ground's
// budget and its update close the column.  No per-layer value lives in
// local memory (ptxas on the H100: 56 registers at float32, whose 32-byte
// stack frame is cosf's long-argument path, as in K7's epilogue; 176 at
// float64; no spills).
//
// The small tables come from the wrapper (ops/radiation.py), formed once
// with PyTorch per geometry, type and t_sw: cum_sw_top[0], dsig,
// (1 - sw_t) cum_sw_top / sw_t per layer, sin and cos of each row's
// latitude and each column's longitude, so that they round as the plain
// version's.  The scalars, the polynomials' coefficients among them, come
// in the kernel's parameters rounded to the working type, so that each
// is an operand in the constant bank, not a register (at float64 the
// polynomials alone would hold 42).  The clock and a
// declination that the clock sets are read from 0-dim tensors in device
// memory (no host read); a Python clock's hour angle and a Python
// declination's sine and cosine come in as doubles, formed as the plain
// version forms them.
//
// Every expression keeps the plain version's operand order as PyTorch
// evaluates it on the card: a Python float operand rounds to the working
// type first, x / c with a Python float c is x * (1/c), the reciprocal
// formed in double, c / x is (1/x) * c, x ** 4 is pow(x, 4); the library
// builds with -fmad=false and full-precision exp.  Only the sums over the
// four bands and over the ground's layers may add in another order than
// PyTorch's reductions, a few ulps of the result.
//
// Bound: bytes.  It reads tt and q (L planes each; the second sweep's
// reads are L2's), p, the ground temperature and the albedo, and writes
// tt and the ground temperature: 3L + 4 (H,W) planes, 65 MB at
// 9x512x1024 float32, 0.0194 ms at 3.35 TB/s.  The design reads and
// writes each plane once from device memory and launches once; what keeps
// it from that bound is instruction issue: two sweeps of four exp, a pow
// and 21 Horner steps a layer.  On the H100 the launch takes 0.0897 ms,
// 22% of the bound (PERF.md §6); keeping the eight values a layer in
// shared memory instead of forming them again would halve that work at
// the cost of occupancy, and is not measured.

#include "gcm_stencil.cuh"

namespace gcm {

__device__ __forceinline__ float exponential(float x) { return expf(x); }
__device__ __forceinline__ double exponential(double x) { return exp(x); }

constexpr int kBands = 4;
constexpr int kPolyTerms = 7;  // degree 6, highest power first

// The table, as ops/radiation.py:radiation_table lays it out:
// cum_sw_top[0], then dsig (L), sn (L), sin(lat) (H), cos(lat) (H) and
// lon (W).
enum RadTable { kRadCumSw0, kRadRows };

// The scalars, as ops/radiation.py passes them.
enum RadScalar {
  kOneMinusAlbedo,  // 1 - albedo where it is a Python float
  kHour,            // the hour angle of a Python clock
  kSinDecl,         // sin and cos of a Python declination
  kCosDecl,
  kRadDt,
  kRadSb,
  kRadSolar,
  kRadInvCg,        // 1 / Cg
  kRadCp,
  kRadG,
  kNegDiffusivity,  // -1.66
  kAbsorb,          // the four bands' absorptivities, kAbsorb + b
  kPoly = kAbsorb + kBands,  // the three fitted bands' coefficients
  kRadScalars = kPoly + 3 * kPolyTerms
};

template <typename T>
struct RadArgs {
  const T *p, *tt, *q, *gt;  // p, gt (H,W); tt, q (L,H,W); contiguous
  const T* albedo;           // (H,W), contiguous, or null: kOneMinusAlbedo
  const T* utc;              // 0-dim clock, or null: kHour
  const T* decl;             // 0-dim declination, or null: kSinDecl, kCosDecl
  const T* table;            // RadTable
  T *tt_out, *gt_out;        // (L,H,W), (H,W)
  T s[kRadScalars];          // RadScalar, each rounded to T
  int L, H, W;
};

template <typename T>
inline size_t four_band_bytes(int L) {
  return (size_t)L * kBlock * sizeof(T);
}

// The Planck fraction of each band at temperature x:
// physics/radiation.py:four_band_fractions.
template <typename T>
__device__ __forceinline__ void band_fractions(const RadArgs<T>& a, T x, T (&f)[kBands]) {
  T s = (x - T(250.0)) * T(1.0 / 100.0);
  s = s < T(-1) ? T(-1) : (s > T(1) ? T(1) : s);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    T y = T(0);
#pragma unroll
    for (int m = 0; m < kPolyTerms; ++m) y = y * s + a.s[kPoly + b * kPolyTerms + m];
    f[b] = y;
  }
  f[3] = T(1) - ((f[0] + f[1]) + f[2]);
}

template <typename T>
__device__ __forceinline__ T band_sum(const T (&x)[kBands]) {
  return ((x[0] + x[1]) + x[2]) + x[3];
}

template <typename T>
__global__ void __launch_bounds__(kBlock) column_four_band(const RadArgs<T> a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int L = a.L, tid = threadIdx.x;
  const int j = blockIdx.y, i = blockIdx.x * kBlock + tid;
  if (i >= a.W) return;
  T* const lwa_a = reinterpret_cast<T*>(tile_smem) + tid;  // [k][thread]
  const size_t HW = (size_t)a.H * a.W;
  const size_t c = (size_t)j * a.W + i;
  const T* const dsig = a.table + kRadRows;
  const T* const sn = dsig + L;
  const T* const sin_lat = sn + L;
  const T* const cos_lat = sin_lat + a.H;
  const T* const lon = cos_lat + a.H;
  const T one = T(1), zero = T(0);
  // the clamped cos(zenith) and the shortwave at the ground, first: the
  // trigonometric functions' long-argument paths then find few registers
  // live
  const T hour = a.utc ? ((a.utc[0] * T(1.0 / -86400.0)) * T(2)) * T(3.141592653589793)
                       : a.s[kHour];
  const T sin_d = a.decl ? sine(a.decl[0]) : a.s[kSinDecl];
  const T cos_d = a.decl ? cosine(a.decl[0]) : a.s[kCosDecl];
  T sza = sin_lat[j] * sin_d + (cos_lat[j] * cos_d) * cosine(lon[i] + hour);
  sza = sza < zero ? zero : sza;
  const T Sc = a.s[kRadSolar] * sza;
  const T oma = a.albedo ? one - a.albedo[c] : a.s[kOneMinusAlbedo];
  const T S = (oma * Sc) * a.table[kRadCumSw0];
  const T p = a.p[c];

  // layer k's true temperature, transmittances and emissions
  auto layer = [&](int k, T (&t)[kBands], T (&e)[kBands]) {
    const T x = a.tt[k * HW + c];
    const T qg = a.q[k * HW + c] * T(1000.0);
    const T dpn = (p * dsig[k]) * T(1.0 / 1.0e5);
    const T eps[kBands] = {(a.s[kAbsorb] * qg) * dpn, a.s[kAbsorb + 1] * dpn,
                           a.s[kAbsorb + 2] * dpn, (a.s[kAbsorb + 3] * qg) * dpn};
    T f[kBands];
    band_fractions(a, x, f);
    const T x4 = power(x, T(4));
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      t[b] = exponential(a.s[kNegDiffusivity] * eps[b]);
      e[b] = ((f[b] * (one - t[b])) * a.s[kRadSb]) * x4;
    }
    return x;
  };

  // downwelling absorption per band, top -> bottom
  {
    T down[kBands] = {zero, zero, zero, zero};
    for (int k = L - 1; k >= 0; --k) {
      T t[kBands], e[kBands], absorbed[kBands];
      layer(k, t, e);
#pragma unroll
      for (int b = 0; b < kBands; ++b) {
        absorbed[b] = down[b] * (one - t[b]);
        down[b] = down[b] * t[b] + e[b];
      }
      lwa_a[k * kBlock] = band_sum(absorbed);
    }
  }

  // the ground's emission, split by the Planck fraction at the ground
  // temperature
  const T gt = a.gt[c];
  const T U_s = a.s[kRadSb] * power(gt, T(4));
  T fg[kBands];
  band_fractions(a, gt, fg);
#pragma unroll
  for (int b = 0; b < kBands; ++b) fg[b] = fg[b] * U_s;

  // bottom -> top: the ground's sum, the ground's emission absorbed in
  // each layer, the upward ladder and the heating
  const T dt = a.s[kRadDt];
  T below[kBands] = {one, one, one, one};  // product of t_b under the layer
  T up[kBands] = {zero, zero, zero, zero};
  T B[kBands] = {zero, zero, zero, zero};
  for (int k = 0; k < L; ++k) {
    T t[kBands], e[kBands], un[kBands], lwb[kBands];
    const T x = layer(k, t, e);
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      B[b] = B[b] + e[b] * below[b];
      un[b] = (fg[b] * below[b]) * (one - t[b]);
      lwb[b] = up[b] * (one - t[b]);
      up[b] = up[b] * t[b] + e[b];
      below[b] = below[b] * t[b];
    }
    const T heat = (one / ((a.s[kRadCp] * p) * dsig[k])) * a.s[kRadG];
    const T dTdt = ((((band_sum(un) + sn[k] * Sc) - T(2) * band_sum(e)) + lwa_a[k * kBlock]) +
                    band_sum(lwb)) *
                   heat;
    a.tt_out[k * HW + c] = x + dTdt * dt;
  }
  const T dtg = (((band_sum(B) + S) - U_s) * a.s[kRadInvCg]) * T(1.0 / 0.1);
  a.gt_out[c] = gt + dtg * dt;
}

}  // namespace gcm

namespace {

template <typename T>
int launch(const double* scalars, const void* p, const void* tt, const void* q, const void* gt,
           const void* albedo, const void* utc, const void* decl, const void* table,
           void* tt_out, void* gt_out, int L, int H, int W, int* launches,
           cudaStream_t stream) {
  *launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  gcm::RadArgs<T> a{};
  a.p = static_cast<const T*>(p);
  a.tt = static_cast<const T*>(tt);
  a.q = static_cast<const T*>(q);
  a.gt = static_cast<const T*>(gt);
  a.albedo = static_cast<const T*>(albedo);
  a.utc = static_cast<const T*>(utc);
  a.decl = static_cast<const T*>(decl);
  a.table = static_cast<const T*>(table);
  a.tt_out = static_cast<T*>(tt_out);
  a.gt_out = static_cast<T*>(gt_out);
  for (int n = 0; n < gcm::kRadScalars; ++n) a.s[n] = T(scalars[n]);
  a.L = L; a.H = H; a.W = W;
  static_assert(gcm::kMaxLayers * gcm::kBlock * sizeof(double) <= gcm::kMaxSharedBytes,
                "the four-band column exceeds a block's shared memory");
  const dim3 grid((W + gcm::kBlock - 1) / gcm::kBlock, H);
  return gcm::launch_kernel(gcm::column_four_band<T>, grid, gcm::kBlock,
                            gcm::four_band_bytes<T>(L), stream, launches, a);
}

}  // namespace

// The four-band radiation and its update: tt_out (L,H,W) and gt_out (H,W)
// from p, gt (H,W) and tt, q (L,H,W), all contiguous.  albedo: (H,W) or
// null; utc, decl: 0-dim or null; table: ops/radiation.py's
// radiation_table; scalars: kRadScalars doubles (RadScalar), each rounded
// to the working type.  *launches: set to the launches made.  Returns 0
// or the CUDA error.
extern "C" int gcm_four_band(int is_double, const void* p, const void* tt, const void* q,
                             const void* gt, const void* albedo, const void* utc,
                             const void* decl, const void* table, void* tt_out, void* gt_out,
                             const double* scalars, int L, int H, int W, int* launches,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(scalars, p, tt, q, gt, albedo, utc, decl, table, tt_out, gt_out, L,
                          H, W, launches, st);
  return launch<float>(scalars, p, tt, q, gt, albedo, utc, decl, table, tt_out, gt_out, L, H,
                       W, launches, st);
}
