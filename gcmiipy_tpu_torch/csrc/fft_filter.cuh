// One round of the Arakawa-Lamb polar filter along longitude as a
// hand-written FFT in shared memory, in float64: the filter stage of K5
// (mega_half.cu), K6 (mega_step.cu) and K7 (stream_steps.cu), and the
// standalone op fft_filter.cu.  gcmiipy_tpu_torch/ops/fft_filter.py:
// fft_filter_ref is the plain version (the same plan and pairing in
// complex128 PyTorch ops).
//
// It replaces the filter of the TPU kernels: the in-kernel DFT of
// gcmiipy_tpu/ops/pallas_stencil.py:make_mega_kernel_padded (:806-830),
// matsuno_block_stages.correction (:1082) and filter_round (:1182) of
// make_mega_step_kernel, and through them the bodies that
// pallas_stream.py:make_stream_kernel runs.  Those sum the banded real DFT
// on the TPU's matrix unit; here the same function,
//
//   Y = X + irfft((m - 1) * rfft(X))   along W, on the stacked (P,H,W) X,
//
// is an FFT, which needs some 50 times fewer operations than the W-term
// DFT sums.
//
// Pairing: rows a = 2p and b = 2p+1 of one latitude j form one complex row
// z = x_a + i x_b (an odd last plane pairs with 0).  Bin k is scaled by
// the real, even factor (m[j, min(k, W-k)] - 1) / W, so the inverse
// transform returns x_a's correction in its real part and x_b's in its
// imaginary part.  The inverse is a forward transform of the conjugate:
// ifft(A) = conj(fft(conj(A))) / W, so only forward stages exist.
//
// Transform: mixed-radix Stockham (self-sorting, out of place).  Stage s
// of radix R, after stages whose radices multiply to Ns, takes butterfly j
// in [0, W/R) with k = j mod Ns: v_r = in[j + r W/R] * w^(r k W/(Ns R)) for
// w = exp(-2 pi i / W), the R-point DFT of v, out[(j - k) R + k + q Ns] =
// V_q.  The plan (the radices, in order) is ops/fft_filter.py:radix_plan's;
// the twiddles w^n, n < W, are a float64 table built on the host in numpy
// and read through the read-only path.  Two kernels run it:
//
//   fft_filter_pow2   the widths 512, 1024, 2048 and 4096, the model's:
//                     radix 16, then 2, 4, 8 or 16 (1024 = 16 16 4), W/16
//                     threads a row pair, each holding 16 points in
//                     registers through the whole round; one shared buffer
//                     for the exchanges between stages (see pow2_stages).
//   fft_filter_kernel every other width: radices 4, 2, 3 and 5 written
//                     out, any other prime factor as a direct R-term sum a
//                     output; one block per (latitude, group of row pairs
//                     sharing the mask row), ping-pong shared buffers.
//
// Only latitudes with some damping are listed; every other row is left as
// it is (Y = X).  Loads and stores are coalesced along W.  Every sum is in
// double and the result is rounded to T once at the store, so the polar
// rows, where the raw forces are some 70 times the filtered ones and float
// sums leave 1e-4 of the field's scale, come out as the float64 filter
// rounded once.
//
// Bound: bytes.  At 9x512x1024 every latitude is damped: a round reads and
// writes 18 planes of 2 MB and reads the 2.1 MB mask, 77.6 MB, 0.023 ms at
// 3.35 TB/s; its 4608 row pairs are 0.36 GFLOP double (radix_plan's count,
// ops/fft_filter.py:round_ops), 0.011 ms at 34 TFLOP/s.  The design reads
// each listed row once and writes it once, keeps the transform in
// registers and shared memory and puts no float64 scratch in device
// memory.  chip_smoke.py works the bound out from its run's tensors.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace gcm {

constexpr int kFftThreads = 256;        // threads a block of the general kernel
constexpr int kFftMaxStages = 16;        // radices of one plan (W <= 65535)
constexpr int kFftGroupPoints = 1024;    // points a block transforms at once
constexpr size_t kFftMaxShared = 232448; // a block's shared memory on sm_90

struct FftFilter {
  const double* mask;      // (H, W/2+1) correction mask m - 1, float64
  const double2* twiddle;  // (W) exp(-2 pi i n / W)
  const int* lats;         // (R) listed latitudes
  int R, P, H, W;          // listed latitudes, planes, height, width
  int nstages;
  int radix[kFftMaxStages];
};

// Row pairs a block transforms at once, so that a block holds about
// kFftGroupPoints points.
__host__ __device__ inline int fft_group(const FftFilter& f) {
  const int pairs = (f.P + 1) / 2;
  const int g = f.W >= kFftGroupPoints ? 1 : kFftGroupPoints / f.W;
  return g < pairs ? g : pairs;
}

inline size_t fft_shared_bytes(const FftFilter& f) {
  return 2 * (size_t)fft_group(f) * f.W * sizeof(double2);
}

// True when the plan does not multiply to W, a radix is below 2, or the
// buffers of one row pair exceed a block's shared memory.
inline bool bad_fft(const FftFilter& f) {
  if (f.R < 0 || f.P < 1 || f.W < 1 || f.nstages < 0 || f.nstages > kFftMaxStages) return true;
  long prod = 1;
  for (int s = 0; s < f.nstages; ++s) {
    if (f.radix[s] < 2) return true;
    prod *= f.radix[s];
  }
  return prod != f.W || 2 * (size_t)f.W * sizeof(double2) > kFftMaxShared;
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
// a * b, each part one product and one fused multiply-add
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -(a.y * b.y)), __fma_rn(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ double2 cscale(double2 a, double s) {
  return make_double2(a.x * s, a.y * s);
}
// -i * a
__device__ __forceinline__ double2 mul_mi(double2 a) { return make_double2(a.y, -a.x); }

// a * exp(-2 pi i e / 16) for a constant e in [0, 16)
template <int E>
__device__ __forceinline__ double2 rot16(double2 a) {
  constexpr double kC[5] = {1.0, 0.92387953251128675613, 0.70710678118654752440,
                            0.38268343236508977173, 0.0};
  if constexpr (E % 16 == 0) {
    return a;
  } else if constexpr (E % 16 == 4) {
    return mul_mi(a);
  } else if constexpr (E % 16 == 8) {
    return make_double2(-a.x, -a.y);
  } else if constexpr (E % 16 == 12) {
    return make_double2(-a.y, a.x);
  } else {
    // exp(-2 pi i e/16) = cos - i sin, folded to the first quadrant
    constexpr int e = E % 16, q = e / 4, r = e % 4;
    const double2 w = make_double2(kC[r], -kC[4 - r]);  // exp(-2 pi i r/16)
    const double2 b = cmul(a, w);
    if constexpr (q == 0) return b;
    if constexpr (q == 1) return mul_mi(b);
    if constexpr (q == 2) return make_double2(-b.x, -b.y);
    return make_double2(-b.y, b.x);
  }
}

// The R-point forward DFT of v, in place.
template <int R>
__device__ __forceinline__ void butterfly(double2* v);

template <>
__device__ __forceinline__ void butterfly<2>(double2* v) {
  const double2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void butterfly<3>(double2* v) {
  constexpr double kS3 = 0.86602540378443864676;  // sin(2 pi / 3)
  const double2 t = cadd(v[1], v[2]), s = csub(v[1], v[2]);
  const double2 m = csub(v[0], cscale(t, 0.5)), n = mul_mi(cscale(s, kS3));
  v[0] = cadd(v[0], t);
  v[1] = cadd(m, n);
  v[2] = csub(m, n);
}

template <>
__device__ __forceinline__ void butterfly<4>(double2* v) {
  const double2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const double2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void butterfly<5>(double2* v) {
  constexpr double kC1 = 0.30901699437494742410;   // cos(2 pi / 5)
  constexpr double kC2 = -0.80901699437494742410;  // cos(4 pi / 5)
  constexpr double kS1 = 0.95105651629515357212;   // sin(2 pi / 5)
  constexpr double kS2 = 0.58778525229247312917;   // sin(4 pi / 5)
  const double2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const double2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const double2 a1 = cadd(v[0], cadd(cscale(t1, kC1), cscale(t2, kC2)));
  const double2 a2 = cadd(v[0], cadd(cscale(t1, kC2), cscale(t2, kC1)));
  const double2 b1 = mul_mi(cadd(cscale(d1, kS1), cscale(d2, kS2)));
  const double2 b2 = mul_mi(csub(cscale(d1, kS2), cscale(d2, kS1)));
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(a1, b1);
  v[4] = csub(a1, b1);
  v[2] = cadd(a2, b2);
  v[3] = csub(a2, b2);
}

template <>
__device__ __forceinline__ void butterfly<8>(double2* v) {
  // 8 = 2 x 4: the twiddles exp(-2 pi i r q / 8) with r < 2
  double2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  butterfly<4>(e);
  butterfly<4>(o);
  o[1] = rot16<2>(o[1]);
  o[2] = rot16<4>(o[2]);
  o[3] = rot16<6>(o[3]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = cadd(e[q], o[q]);
    v[q + 4] = csub(e[q], o[q]);
  }
}

template <>
__device__ __forceinline__ void butterfly<16>(double2* v) {
  // 16 = 4 x 4: four 4-point DFTs over v[r + 4m], the twiddles
  // exp(-2 pi i r q / 16), four 4-point DFTs into v[q + 4p]
  double2 a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r][0] = v[r];
    a[r][1] = v[r + 4];
    a[r][2] = v[r + 8];
    a[r][3] = v[r + 12];
    butterfly<4>(a[r]);
  }
  a[1][1] = rot16<1>(a[1][1]);
  a[1][2] = rot16<2>(a[1][2]);
  a[1][3] = rot16<3>(a[1][3]);
  a[2][1] = rot16<2>(a[2][1]);
  a[2][2] = rot16<4>(a[2][2]);
  a[2][3] = rot16<6>(a[2][3]);
  a[3][1] = rot16<3>(a[3][1]);
  a[3][2] = rot16<6>(a[3][2]);
  a[3][3] = rot16<9>(a[3][3]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    double2 d[4] = {a[0][q], a[1][q], a[2][q], a[3][q]};
    butterfly<4>(d);
    v[q] = d[0];
    v[q + 4] = d[1];
    v[q + 8] = d[2];
    v[q + 12] = d[3];
  }
}

// One Stockham stage of radix R on `rows` rows of W points.
template <int R>
__device__ __forceinline__ void fft_stage(const double2* __restrict__ in,
                                          double2* __restrict__ out, int rows, int W, int Ns,
                                          const double2* __restrict__ tw) {
  const int nb = W / R, M = W / (Ns * R);
  for (int b = threadIdx.x; b < rows * nb; b += blockDim.x) {
    const int g = b / nb, j = b - g * nb, k = j % Ns;
    const double2* src = in + (size_t)g * W + j;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[r * nb];
    if (k) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * k * M));
    }
    butterfly<R>(v);
    double2* dst = out + (size_t)g * W + (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[r * Ns] = v[r];
  }
}

// A stage of any radix R: output q of butterfly j is the R-term sum
// sum_r in[j + r W/R] w^(r (k + q Ns) W/(Ns R)), one table entry a term.
__device__ __forceinline__ void fft_stage_any(const double2* __restrict__ in,
                                              double2* __restrict__ out, int rows, int W,
                                              int R, int Ns, const double2* __restrict__ tw) {
  const int nb = W / R, M = W / (Ns * R);
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int g = e / W, item = e - g * W, j = item / R, q = item - j * R, k = j % Ns;
    const double2* src = in + (size_t)g * W;
    const int step = (k + q * Ns) * M;  // < W
    int n = 0;
    double2 acc = make_double2(0.0, 0.0);
    for (int r = 0; r < R; ++r) {
      acc = cadd(acc, cmul(src[j + r * nb], __ldg(tw + n)));
      n += step;
      if (n >= W) n -= W;
    }
    out[(size_t)g * W + (j - k) * R + k + q * Ns] = acc;
  }
}

// The forward transform of `rows` rows held in a; returns the buffer (a
// or b) that holds the result.  Every thread of the block calls it.
__device__ __forceinline__ double2* fft_rows(double2* a, double2* b, int rows,
                                             const FftFilter& f) {
  int ns = 1;
  for (int s = 0; s < f.nstages; ++s) {
    const int R = f.radix[s];
    switch (R) {
      case 2: fft_stage<2>(a, b, rows, f.W, ns, f.twiddle); break;
      case 3: fft_stage<3>(a, b, rows, f.W, ns, f.twiddle); break;
      case 4: fft_stage<4>(a, b, rows, f.W, ns, f.twiddle); break;
      case 5: fft_stage<5>(a, b, rows, f.W, ns, f.twiddle); break;
      default: fft_stage_any(a, b, rows, f.W, R, ns, f.twiddle);
    }
    __syncthreads();
    double2* t = a;
    a = b;
    b = t;
    ns *= R;
  }
  return a;
}

// One filter round on X (P,H,W), in place, for any W and plan: block
// (x, y) filters latitude lats[x], row pairs y*G .. y*G+G-1, between two
// shared buffers of G rows.
template <typename T>
__global__ void __launch_bounds__(kFftThreads) fft_filter_kernel(T* X, const FftFilter f) {
  extern __shared__ double2 fft_smem[];
  const int G = fft_group(f), W = f.W, lat = f.lats[blockIdx.x];
  const int pair0 = blockIdx.y * G, pairs = (f.P + 1) / 2;
  const int rows = min(G, pairs - pair0);
  const size_t plane = (size_t)f.H * W;
  T* base = X + (size_t)lat * W;
  double2* buf0 = fft_smem;
  double2* buf1 = fft_smem + (size_t)G * W;
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int g = e / W, n = e - g * W, pa = 2 * (pair0 + g);
    const double xa = static_cast<double>(base[pa * plane + n]);
    const double xb = pa + 1 < f.P ? static_cast<double>(base[(pa + 1) * plane + n]) : 0.0;
    buf0[e] = make_double2(xa, xb);
  }
  __syncthreads();
  double2* z = fft_rows(buf0, buf1, rows, f);
  // conj(Z[k]) (m[j, min(k, W-k)] - 1) / W
  const double* mrow = f.mask + (size_t)lat * (W / 2 + 1);
  const double inv_w = 1.0 / W;
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int n = e % W;
    const double s = __ldg(mrow + (n < W - n ? n : W - n)) * inv_w;
    const double2 v = z[e];
    z[e] = make_double2(v.x * s, -(v.y * s));
  }
  __syncthreads();
  const double2* c = fft_rows(z, z == buf0 ? buf1 : buf0, rows, f);
  // the corrections: x_a's Re(conj(c)) = c.x, x_b's Im(conj(c)) = -c.y
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int g = e / W, n = e - g * W, pa = 2 * (pair0 + g);
    const double2 v = c[e];
    T* ra = base + pa * plane + n;
    *ra = static_cast<T>(static_cast<double>(*ra) + v.x);
    if (pa + 1 < f.P) {
      T* rb = ra + plane;
      *rb = static_cast<T>(static_cast<double>(*rb) - v.y);
    }
  }
}

// The power-of-two widths 512..4096 run a register-tiled form of the same
// transform: W/16 threads a row pair, each holding 16 points in
// registers.  The plan is radix 16 while 16 divides the rest, then the
// remaining 2, 4 or 8 (pow2_plan); a stage's butterflies j = t + i W/16
// (i < 16/R) read their points from one shared buffer, padded one point in
// 16 so that the early stages' strided writes miss no bank twice.  The
// last forward stage leaves each thread the points t + (W/16) r, which are
// the first inverse stage's inputs, so the mask is applied in registers
// with no exchange, and the last inverse stage's outputs are the points
// the thread loaded: it adds its own raw values, kept in shared memory,
// and stores.  Per row pair: loads, 2 (S - 1) exchanges for S stages, one
// store.
constexpr int kFftPts = 16;  // points a thread holds

__host__ __device__ constexpr bool pow2_width(int W) {
  return W == 512 || W == 1024 || W == 2048 || W == 4096;
}

// radix of the stage after stages of product ns
__host__ __device__ constexpr int pow2_radix(int W, int ns) {
  return W / ns >= kFftPts ? kFftPts : W / ns;
}

// True when the plan is pow2_plan(W): the power-of-two path's
inline bool pow2_plan(const FftFilter& f) {
  if (!pow2_width(f.W)) return false;
  int ns = 1, s = 0;
  for (; ns < f.W; ++s) {
    if (s >= f.nstages || f.radix[s] != pow2_radix(f.W, ns)) return false;
    ns *= f.radix[s];
  }
  return s == f.nstages;
}

__host__ __device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// The stages of one transform from the one of product NS on: v holds the
// stage's inputs, v[i R + r] = in[j_i + r W/R] for j_i = t + i W/16; on
// return v[r] holds the output point t + (W/16) r.
template <int W, int NS>
__device__ __forceinline__ void pow2_stages(double2* v, double2* buf,
                                            const double2* __restrict__ tw, int t) {
  constexpr int R = pow2_radix(W, NS), T = W / kFftPts, M = W / (NS * R);
  constexpr int BPT = kFftPts / R;  // butterflies a thread
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int k = (t + i * T) & (NS - 1);
    if (k) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[i * R + r] = cmul(v[i * R + r], __ldg(tw + r * k * M));
    }
    butterfly<R>(v + i * R);
  }
  if constexpr (NS * R == W) {
    // output q of butterfly i is the point j_i + q W/R = t + T (i + q BPT)
    double2 o[kFftPts];
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
#pragma unroll
      for (int q = 0; q < R; ++q) o[i + q * BPT] = v[i * R + q];
    }
#pragma unroll
    for (int e = 0; e < kFftPts; ++e) v[e] = o[e];
  } else {
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int j = t + i * T, k = j & (NS - 1);
#pragma unroll
      for (int q = 0; q < R; ++q) buf[pad16((j - k) * R + k + q * NS)] = v[i * R + q];
    }
    __syncthreads();
    constexpr int R2 = pow2_radix(W, NS * R), NB2 = W / R2;
#pragma unroll
    for (int i = 0; i < kFftPts / R2; ++i) {
#pragma unroll
      for (int r = 0; r < R2; ++r) v[i * R2 + r] = buf[pad16(t + i * T + r * NB2)];
    }
    __syncthreads();
    pow2_stages<W, NS * R>(v, buf, tw, t);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(W / kFftPts) fft_filter_pow2(T* X, const FftFilter f) {
  constexpr int TH = W / kFftPts;
  extern __shared__ double2 fft_smem[];
  double2* buf = fft_smem;
  T* raw = reinterpret_cast<T*>(fft_smem + pad16(W - 1) + 1);  // (2, 16, TH)
  const int t = threadIdx.x, lat = f.lats[blockIdx.x], pa = 2 * blockIdx.y;
  const bool has_b = pa + 1 < f.P;
  const size_t plane = (size_t)f.H * W;
  T* row_a = X + (size_t)pa * plane + (size_t)lat * W;
  T* row_b = row_a + plane;
  double2 v[kFftPts];
#pragma unroll
  for (int e = 0; e < kFftPts; ++e) {
    const T a = row_a[t + e * TH], b = has_b ? row_b[t + e * TH] : T(0);
    raw[e * TH + t] = a;
    raw[(kFftPts + e) * TH + t] = b;
    v[e] = make_double2(static_cast<double>(a), static_cast<double>(b));
  }
  pow2_stages<W, 1>(v, buf, f.twiddle, t);
  // conj(Z[n]) (m[j, min(n, W-n)] - 1) / W at the points n = t + TH e
  const double* mrow = f.mask + (size_t)lat * (W / 2 + 1);
  constexpr double inv_w = 1.0 / W;
#pragma unroll
  for (int e = 0; e < kFftPts; ++e) {
    const int n = t + e * TH;
    const double s = __ldg(mrow + (n < W - n ? n : W - n)) * inv_w;
    v[e] = make_double2(v[e].x * s, -(v[e].y * s));
  }
  pow2_stages<W, 1>(v, buf, f.twiddle, t);
  // the corrections: x_a's Re(conj(c)) = c.x, x_b's Im(conj(c)) = -c.y
#pragma unroll
  for (int e = 0; e < kFftPts; ++e) {
    row_a[t + e * TH] = static_cast<T>(static_cast<double>(raw[e * TH + t]) + v[e].x);
    if (has_b)
      row_b[t + e * TH] =
          static_cast<T>(static_cast<double>(raw[(kFftPts + e) * TH + t]) - v[e].y);
  }
}

// The launch's error; a launch that was accepted adds one to *launches.
inline int launched(int* launches) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

template <typename T, int W>
int launch_pow2(T* X, const FftFilter& f, cudaStream_t stream, int* launches) {
  const size_t bytes = (pad16(W - 1) + 1) * sizeof(double2) + 2 * W * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_filter_pow2<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fft_filter_pow2<T, W><<<dim3(f.R, (f.P + 1) / 2), W / kFftPts, bytes, stream>>>(X, f);
  return launched(launches);
}

// Enqueue one filter round on X (P,H,W) on `stream`, adding one to
// *launches when its kernel was launched (none is when no latitude is
// listed).  Returns 0 or the launch's CUDA error.
template <typename T>
int fft_filter(T* X, const FftFilter& f, cudaStream_t stream, int* launches) {
  if (bad_fft(f)) return (int)cudaErrorInvalidValue;
  if (f.R == 0) return 0;
  if (pow2_plan(f)) {
    switch (f.W) {
      case 512: return launch_pow2<T, 512>(X, f, stream, launches);
      case 1024: return launch_pow2<T, 1024>(X, f, stream, launches);
      case 2048: return launch_pow2<T, 2048>(X, f, stream, launches);
      default: return launch_pow2<T, 4096>(X, f, stream, launches);
    }
  }
  const size_t bytes = fft_shared_bytes(f);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_filter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = fft_group(f), pairs = (f.P + 1) / 2;
  const dim3 grid(f.R, (pairs + G - 1) / G);
  fft_filter_kernel<T><<<grid, kFftThreads, bytes, stream>>>(X, f);
  return launched(launches);
}

// FftFilter from the C entry points' arguments.  fft: mask (H, W/2+1) and
// twiddle (W, 2), both double.  lats: int32 (R).  plan: nstages radices.
inline FftFilter make_fft(const void* mask, const void* twiddle, const void* lats, int R, int P,
                          int H, int W, const int* plan, int nstages) {
  FftFilter f;
  f.mask = static_cast<const double*>(mask);
  f.twiddle = static_cast<const double2*>(twiddle);
  f.lats = static_cast<const int*>(lats);
  f.R = R; f.P = P; f.H = H; f.W = W;
  f.nstages = nstages;
  for (int s = 0; s < kFftMaxStages; ++s) f.radix[s] = (plan && s < nstages) ? plan[s] : 0;
  return f;
}

}  // namespace gcm
