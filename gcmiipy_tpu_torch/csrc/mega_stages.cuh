// The stages of one whole Matsuno step (predictor and corrector) with the
// banded DFT polar filter, shared by K6 (mega_step.cu, one step a call),
// K7 (stream_steps.cu, k steps a call on the packed ping-pong buffer), K5
// (mega_half.cu, one half step a call) and the v2 pair K3/K4 (pgf_rest.cu:
// stages 1-2 and 5-6, the filter outside), so that each stage exists once.  gcmiipy_tpu_torch/ops/mega_step.py:
// mega_step_ref is the plain version of one step.
//
// They replace the bodies matsuno_block_body (:1290) and
// matsuno_block_stages (:1009) of gcmiipy_tpu/ops/pallas_stencil.py.  The
// TPU kernel runs both halves on one block of latitude rows held in VMEM
// with an 8-row overlap-recompute halo; at 9x512x1024 one block's fields
// alone are megabytes, far beyond an SM's 227 KB, so that layout does not
// carry over.  A step does:
//
//   per half (base, evaluated):
//     1. pgf_column_pass   one thread per (j,i) column: p^kappa, rho and the
//                          geopotential ladder (scratch rho, phi)
//     2. pgf_stencil_pass  one thread per (k,j,i): pgf_forces, i.e. the
//                          stacked X = [spu_raw; pg_phi] (2L,H,W) and pg_phiv
//     3. dft_forward       A = (X @ CS_c) * mcc_c for each row's chunks c
//     4. dft_inverse       X = X + sum_c A_c @ CwSw_c, in place, in order
//     5. aflux_column_pass one thread per column: sd and p_n from the
//                          filtered spu
//     6. rest_stencil_pass one thread per point: half_timestep_rest and the
//                          momentum epilogue u = (pu - pgfu dt)/iph(p_n),
//                          v = (pv - pg_phiv dt)/jph(p_n) * keep (the polar
//                          wall, 0 on row H-1)
//
// twelve launches per step on the caller's stream, no PyTorch op between
// them.  Scratch lives in device memory and the stream order gives the
// grid-wide dependencies (the corrector's stencils read the starred state
// of neighbour rows) that the TPU got from recomputing halos.  Stages 1, 2,
// 5 and 6 are K1's device code (gcm_stencil.cuh), so they round as K1 and
// the plain version do.
//
// The filter is a hand-written banded DFT product.  The (W, 2nb) forward
// factors CS and (2nb, W) inverse factors CwSw hold the damped wavenumbers
// n = W//2 ... 1 in descending order, chunk-interleaved [C_0|S_0|C_1|S_1..]
// with 256 columns a chunk, so row j's damped band is its first counts[j]
// chunks.  The host lists the stacked rows (plane*H + j) with counts[j] > 0,
// sorted by count, largest first; rows of no damping are left as they are
// (Y = X).  Both products are register-tiled GEMMs over tiles of that list:
// each chunk of CS/CwSw is read once per row tile through shared memory,
// and a tile runs as many chunks as its first row needs while each row
// adds only its own chunks, chunk 0 first, to Y = X, as the plain version
// does (Y = Y + ab_c @ CwSw_c).
//
// The filter's products and sums run in double (__fma_rn) for float fields
// too, with the factors and the correction mask in double: no TF32, no
// reduced precision.  The correction form Y = X + correction cancels on
// the polar rows, where the raw forces are some 70 times the filtered
// ones, and float sums there leave about 1e-4 of the field's scale
// (python -m gcmiipy_tpu_torch.filter_accuracy on an H100); a float product
// is exact in double, so the filtered field is right to its final rounding.
// The summation order differs from cuBLAS's, so K6 agrees with its plain
// version to rounding, not bitwise.
//
// Bound: operations.  At 9x512x1024 the rows need 1, 2, 3 or 4 chunks (128
// latitudes each), so one filter round over the 18 stacked planes is 23040
// row-chunks of 2*256*1024 multiply-adds: 12.08 G multiply-adds, 24.2
// GFLOP, two rounds a step: 48.3 GFLOP in double, 0.72 ms at the H100's
// 67 TFLOP/s double rate on its tensor cores (these register-tiled GEMMs
// run outside them, at most 34 TFLOP/s).  An FFT does the same filter in
// fewer operations, so the banded DFT form, not the card, sets this
// bound.  The bytes (5 fields
// in, 5 out, the two 8 MB double factor matrices and the 4 MB mask) are
// about 180 MB, 0.05 ms.  chip_smoke.py works both out from its run's
// tensors and trip counts.

#pragma once

#include "gcm_stencil.cuh"

namespace gcm {

constexpr int kChunk2 = 256;  // columns of one banded chunk: 128 C + 128 S
constexpr int kThreads = 256;

// GEMM tiles of the filter, in double: BM rows x BN columns a block, BK
// deep; each of the 256 threads holds TM x TN sums, at rows tm + ii*RS and
// columns tn + jj*CSTEP so that a warp's shared-memory reads do not
// conflict, and loads kLoads elements of each operand tile a step, the
// next step's held in registers while the current one is computed.
constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int RS = BM / TM, CSTEP = BN / TN;
constexpr int kLoads = BM * BK / kThreads;
static_assert(RS * CSTEP == kThreads, "one sum tile per thread");
static_assert(BM == BN && kChunk2 % BK == 0 && kChunk2 % BN == 0, "tiles");

struct FilterRows {
  const int* rows;    // (R,) stacked row plane*H + j of each listed row
  const int* counts;  // (R,) its trip count (>= 1), non-increasing
  int R, H, W, ncols;  // listed rows, height, width, 2*nb
};

// A[m, n] = (sum_x X[row m, x] CS[x, n]) * mcc[j(m), n] for the columns of
// row m's chunks, summed in double.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dft_forward(const T* __restrict__ X, const double* __restrict__ CS,
            const double* __restrict__ mcc, double* __restrict__ A, const FilterRows f) {
  __shared__ double As[BK][BM + 1];
  __shared__ double Bs[BK][BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (n0 >= kChunk2 * f.counts[m0]) return;  // counts[m0]: the tile's largest
  const int tid = threadIdx.x, tm = tid / CSTEP, tn = tid % CSTEP;
  // this thread's loads: X at row am[l] (or none), column k0 + ak[l];
  // CS at row k0 + bk[l], column n0 + bn[l]
  const T* xrow[kLoads];
  int ak[kLoads], bk[kLoads], bn[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = tid + l * kThreads, m = m0 + e / BK;
    ak[l] = e % BK;
    xrow[l] = m < f.R ? X + (size_t)f.rows[m] * f.W : nullptr;
    bk[l] = e / BN;
    bn[l] = n0 + e % BN;
  }
  T ra[kLoads];
  double rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int xa = k0 + ak[l], xb = k0 + bk[l];
      ra[l] = (xrow[l] && xa < f.W) ? xrow[l][xa] : T(0);
      rb[l] = xb < f.W ? CS[(size_t)xb * f.ncols + bn[l]] : 0.0;
    }
  };
  double acc[TM][TN];
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[ii][jj] = 0.0;
  }
  load(0);
  for (int k0 = 0; k0 < f.W; k0 += BK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      As[ak[l]][e / BK] = static_cast<double>(ra[l]);
      Bs[bk[l]][e % BN] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < f.W) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double av[TM], bv[TN];
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) av[ii] = As[kk][ii * RS + tm];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) bv[jj] = Bs[kk][jj * CSTEP + tn];
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[ii][jj] = __fma_rn(av[ii], bv[jj], acc[ii][jj]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    const int m = m0 + ii * RS + tm;
    if (m >= f.R) continue;
    const int lim = kChunk2 * f.counts[m];
    const double* mrow = mcc + (size_t)(f.rows[m] % f.H) * f.ncols;
    double* arow = A + (size_t)m * f.ncols;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + jj * CSTEP + tn;
      if (n < lim) arow[n] = acc[ii][jj] * mrow[n];
    }
  }
}

// X[row m, :] = X[row m, :] + sum over row m's chunks c, chunk 0 first, of
// sum_k A[m, 256c + k] CwSw[256c + k, :]; in place, summed in double.  A
// row's A entries beyond its own chunks load as 0, so it adds exact zeros
// there while the tile runs its first (largest) row's chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dft_inverse(T* __restrict__ XY, const double* __restrict__ CwSw, const double* __restrict__ A,
            const FilterRows f) {
  __shared__ double As[BK][BM + 1];
  __shared__ double Bs[BK][BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kend = kChunk2 * f.counts[m0];
  const int tid = threadIdx.x, tm = tid / CSTEP, tn = tid % CSTEP;
  const double* arow[kLoads];
  int ak[kLoads], alim[kLoads], bk[kLoads], bn[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = tid + l * kThreads, m = m0 + e / BK;
    ak[l] = e % BK;
    arow[l] = m < f.R ? A + (size_t)m * f.ncols : nullptr;
    alim[l] = m < f.R ? kChunk2 * f.counts[m] : 0;
    bk[l] = e / BN;
    bn[l] = n0 + e % BN;
  }
  double ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int ka = k0 + ak[l];
      ra[l] = ka < alim[l] ? arow[l][ka] : 0.0;
      rb[l] = bn[l] < f.W ? CwSw[(size_t)(k0 + bk[l]) * f.W + bn[l]] : 0.0;
    }
  };
  double y[TM][TN];
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    const int m = m0 + ii * RS + tm;
    const T* xrow = m < f.R ? XY + (size_t)f.rows[m] * f.W : nullptr;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + jj * CSTEP + tn;
      y[ii][jj] = (xrow && n < f.W) ? static_cast<double>(xrow[n]) : 0.0;
    }
  }
  load(0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      As[ak[l]][e / BK] = ra[l];
      Bs[bk[l]][e % BN] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double av[TM], bv[TN];
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) av[ii] = As[kk][ii * RS + tm];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) bv[jj] = Bs[kk][jj * CSTEP + tn];
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) y[ii][jj] = __fma_rn(av[ii], bv[jj], y[ii][jj]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    const int m = m0 + ii * RS + tm;
    if (m >= f.R) continue;
    T* xrow = XY + (size_t)f.rows[m] * f.W;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + jj * CSTEP + tn;
      if (n < f.W) xrow[n] = static_cast<T>(y[ii][jj]);
    }
  }
}

template <typename T>
__global__ void pgf_column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  gcm::pgf_column(a, blockIdx.y, i);
}

template <typename T>
__global__ void aflux_column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  gcm::aflux_column(a, blockIdx.y, i);
}

// pgf_forces(sp, su, st): X[k] = spu_raw = su * iph(sp), X[L+k] = pgu + phiu,
// pg_phiv = pgv + phiv.
template <typename T>
__global__ void pgf_stencil_pass(const Params<T> a, T* X, T* pg_phiv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  const Point<T> x(a, blockIdx.z, blockIdx.y, i);
  T pgu, pgv, phiu, phiv;
  x.pgf(pgu, pgv, phiu, phiv);
  X[x.o] = a.su[x.o] * ((x.s2(a.sp, x.j, i) + x.s2(a.sp, x.j, x.ip)) * x.half);
  X[(size_t)a.L * x.HW + x.o] = pgu + phiu;
  pg_phiv[x.o] = pgv + phiv;
}

template <typename T>
struct Outs {
  T *u_n, *v_n, *t_n, *q_n;
};

// half_timestep_rest with the filtered spu (a.spu) and the momentum
// epilogue with the filtered pgfu and the polar wall's keep mask (null:
// no wall, v's last row left to the caller).
template <typename T>
__global__ void rest_stencil_pass(const Params<T> a, const T* pgfu, const T* pg_phiv,
                                  const T* keep, const Outs<T> out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  const Point<T> x(a, blockIdx.z, blockIdx.y, i);
  T dut, dvt, dus, dvs;
  x.momentum(dut, dvt);
  x.sigma(dus, dvs);
  const T half = x.half, one = x.one, dt = a.dt;
  const int j = x.j;
  const T p_c = x.s2(a.p, j, i);
  const T pu = a.u[x.o] * ((p_c + x.s2(a.p, j, x.ip)) * half);
  const T pv = a.v[x.o] * ((p_c + x.s2(a.p, x.jp, i)) * half);
  const T pu_partial = pu - (dut + dus) * dt;
  const T pv_partial = pv - (dvt + dvs) * dt;
  const T pn_c = x.s2(a.p_n, j, i);
  out.u_n[x.o] = (pu_partial - pgfu[x.o] * dt) * (one / ((pn_c + x.s2(a.p_n, j, x.ip)) * half));
  const T v_n = (pv_partial - pg_phiv[x.o] * dt) * (one / ((pn_c + x.s2(a.p_n, x.jp, i)) * half));
  out.v_n[x.o] = keep ? v_n * keep[j] : v_n;
  T t_n, q_n;
  x.tracers(t_n, q_n);
  out.t_n[x.o] = t_n;
  out.q_n[x.o] = q_n;
}

template <typename T>
struct Step {
  void* const* geo;
  const double *CS, *CwSw, *mcc;
  const T* keep;
  FilterRows f;
  T *X, *pg_phiv;
  double* A;
  T *sd, *phi, *rho;
  int L, H, W;
  const double* consts;
  int coriolis, q_limiter;
  cudaStream_t stream;
};

#define GCM_CHECK()                                  \
  do {                                               \
    cudaError_t err_ = cudaGetLastError();           \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

// The Params of one half step: base (p,u,v,t,q) advanced with the
// tendencies at seval (sp,su,sv,st,sq), spu the filtered zonal mass flux,
// p_n the new surface pressure, sd/phi/rho the column scratch.  A pointer
// that the caller's stages do not read may be null.
template <typename T>
Params<T> half_params(void* const* base, void* const* seval, const T* spu, void* const* geo,
                      int L, int H, int W, const double* consts, int coriolis, int q_limiter,
                      T* p_n, T* sd, T* phi, T* rho) {
  void* in[11];
  for (int n = 0; n < 5; ++n) {
    in[n] = base[n];
    in[5 + n] = seval[n];
  }
  in[10] = const_cast<T*>(spu);
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, consts, coriolis, q_limiter);
  a.p_n = p_n;
  a.sd = sd; a.phi = phi; a.rho = rho;
  return a;
}

inline dim3 column_grid(int H, int W) { return dim3((W + kBlock - 1) / kBlock, H); }
inline dim3 point_grid(int L, int H, int W) { return dim3((W + kBlock - 1) / kBlock, H, L); }

// Stages 1-2: pgf_forces(sp, su, st) into X = [spu_raw; pg_phi] (2L,H,W)
// and pg_phiv (L,H,W).  Reads a.sp, a.su, a.st; writes a.rho, a.phi.
template <typename T>
int pgf_stages(const Params<T>& a, T* X, T* pg_phiv, cudaStream_t stream) {
  pgf_column_pass<T><<<column_grid(a.H, a.W), kBlock, 0, stream>>>(a);
  GCM_CHECK();
  pgf_stencil_pass<T><<<point_grid(a.L, a.H, a.W), kBlock, 0, stream>>>(a, X, pg_phiv);
  GCM_CHECK();
  return 0;
}

// Stages 5-6: half_timestep_rest with the filtered a.spu and the momentum
// epilogue with the filtered pgfu, pg_phiv and the wall's keep (H; null:
// no wall).
// Writes a.sd, a.p_n and out.
template <typename T>
int rest_stages(const Params<T>& a, const T* pgfu, const T* pg_phiv, const T* keep,
                const Outs<T>& out, cudaStream_t stream) {
  aflux_column_pass<T><<<column_grid(a.H, a.W), kBlock, 0, stream>>>(a);
  GCM_CHECK();
  rest_stencil_pass<T><<<point_grid(a.L, a.H, a.W), kBlock, 0, stream>>>(a, pgfu, pg_phiv,
                                                                          keep, out);
  GCM_CHECK();
  return 0;
}

// One half step: base (p,u,v,t,q) advanced with the tendencies at seval;
// writes out = (p_n, u_n, v_n, t_n, q_n).
template <typename T>
int half_step(const Step<T>& s, void* const* base, void* const* seval, void* const* out) {
  T* const* fo = reinterpret_cast<T* const*>(out);
  // spu: the filtered spu, the first L planes of X after stage 4
  const Params<T> a = half_params<T>(base, seval, s.X, s.geo, s.L, s.H, s.W, s.consts,
                                     s.coriolis, s.q_limiter, fo[0], s.sd, s.phi, s.rho);
  int err = pgf_stages(a, s.X, s.pg_phiv, s.stream);
  if (err) return err;
  if (s.f.R > 0) {
    const unsigned mt = (s.f.R + BM - 1) / BM;
    dft_forward<T><<<dim3(mt, s.f.ncols / BN), kThreads, 0, s.stream>>>(
        s.X, s.CS, s.mcc, s.A, s.f);
    GCM_CHECK();
    dft_inverse<T><<<dim3(mt, (s.W + BN - 1) / BN), kThreads, 0, s.stream>>>(
        s.X, s.CwSw, s.A, s.f);
    GCM_CHECK();
  }
  const T* pgfu = s.X + (size_t)s.L * s.H * s.W;
  return rest_stages(a, pgfu, s.pg_phiv, s.keep, Outs<T>{fo[1], fo[2], fo[3], fo[4]},
                     s.stream);
}

// The per-step arguments of half_step from the C entry points' tables.
// filt: CS (W,ncols), CwSw (ncols,W), mcc (H,ncols), all double, and keep
// (H).  rows, counts: int32 (R,) listed filter rows.  scratch: X (2L,H,W),
// pg_phiv, sd, phi, rho (L,H,W), and A (R,ncols) in double.
template <typename T>
Step<T> make_step(void* const* geo, void* const* filt, const void* rows, const void* counts,
                  int R, int ncols, void* const* scratch, int L, int H, int W,
                  const double* consts, int coriolis, int q_limiter, cudaStream_t stream) {
  Step<T> s;
  s.geo = geo;
  const double* const* ff = reinterpret_cast<const double* const*>(filt);
  s.CS = ff[0]; s.CwSw = ff[1]; s.mcc = ff[2];
  s.keep = static_cast<const T*>(filt[3]);
  s.f = FilterRows{static_cast<const int*>(rows), static_cast<const int*>(counts), R, H, W, ncols};
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  s.X = fs[0]; s.pg_phiv = fs[1]; s.sd = fs[2]; s.phi = fs[3]; s.rho = fs[4];
  s.A = static_cast<double*>(scratch[5]);
  s.L = L; s.H = H; s.W = W;
  s.consts = consts;
  s.coriolis = coriolis; s.q_limiter = q_limiter;
  s.stream = stream;
  return s;
}

inline bool bad_filter(int R, int ncols) { return R < 0 || ncols < kChunk2 || ncols % kChunk2; }

// One whole step: in = (p,u,v,t,q) -> out, the predictor's state in starred.
template <typename T>
int whole_step(const Step<T>& s, void* const* in, void* const* starred, void* const* out) {
  const int err = half_step(s, in, in, starred);  // predictor
  if (err) return err;
  return half_step(s, in, starred, out);          // corrector
}

}  // namespace gcm
