// The point stencils of a half step as one tiled launch: the rest tile
// (stages 4-5 of K4, K5, K6 and K7: aflux, half_timestep_rest and the
// momentum epilogue) and K1's stencil launch (aflux, momentum, pgf, sigma
// and tracers).
//
// One block owns an (8 x 32) tile of (j,i) columns (8 rows at both types)
// and loops over the layers k.  Before the layer loop a prologue runs
// aflux (gcm_stencil.cuh's aflux_column) on the tile's columns and its
// i+1/j+1 halo, (8+1) x (32+1) columns, all threads taking columns in
// turn: each column's convergence of every layer, read from device memory
// (L2), goes into per-layer shared planes, which the column then turns in
// place into the sigma-dot sd (pit summed from k = 0, the suffix from
// k = L-1 down, sd[0] = 0: the plain version's orders), and p_n = p -
// pit*dt into the tile's p_n plane; the tile's own columns also write p_n
// to device memory, an output of K1 and K4-K7.  sd never reaches device
// memory: the stencil reads it at (0,0), (0,1) and (1,0) of layers k and
// k+1 from the planes (layer L wraps to layer 0, whose sd is 0).
//
// Every other field a stencil reads at a neighbour lives in shared memory
// with a halo of rows j-1 .. j+8 and columns i-1 .. i+32, the reach of
// momentum, adv_h and the q limiter (sp one row more, for spv at row j+1):
//
//   ring   su, sv, st, sq: four layer slots, k-1, k and k+1 read by
//          layer k (advec_sig's vertical fluxes) and k+2 in flight;
//   local  spu, q (K1 also rho, phi), and without a halo the fields read
//          only at the point itself, u, v, t (K4-K7 also pgfu, pg_phiv),
//          each thread its own: two slots, k read and k+1 in flight;
//   spv    sv * jph(sp) of layer k, computed once a point into shared
//          memory;
//   2D     sp, p (copied once per block) and p_n (the prologue's);
//   sd     L planes of (8+1) x (32+1), sized from L at launch.
//
// Each layer is copied with cp.async while the layer before it is
// computed (the first layers' copies are in flight during the prologue),
// so each plane is read from device memory once per block (its halo rows
// and columns once more by the neighbouring block, spu and sv once more
// by the prologue, mostly from L2), and layers L-1 and 0 once more for
// the periodic vertical wrap (kn, kkm of the plain version).  The halo's
// j and i are wrapped once per thread, when its copy offsets are formed;
// every stencil access is then a constant offset from the thread's centre
// in the tile.  The values that do not depend on k (the geometry rows'
// reciprocals, the Coriolis parameters, p's and p_n's face averages and
// reciprocals) are formed once per thread.
//
// Shared memory: 4*4 ring planes, two local slots, spv, sp, p, p_n, then
// the sd planes: 43 KB + L * 1.2 KB at float32 (53.7 KB at L = 9, 81 KB
// at L = 32) and twice that at float64 (162 KB at L = 32).  Above
// kRestHeld (16 layers at float32; float64 at any L) the deep form (tile_stencil_deep) runs the layer loop from
// k = L-1 down: its prologue sums only aflux's pit, and each layer forms
// its convergences again from the staged spu, sv and sp and adds them to
// the running sum from the bottom (the plain version's suffix order), so
// that two sd slots, the pit and sum planes and 1/dx_j of the sd rows,
// 48 KB at float32 and 96 KB at float64, serve any L.
//
// Every expression keeps the operand order of the plain version, built
// with -fmad=false, so the kernels equal their plain versions bit for bit:
// staging a value in shared memory or forming it once changes no rounding.
//
// Bound: bytes.  At 9x512x1024 float32 the rest tile reads p, sp and 8
// (L,H,W) fields (u, v, t, q, su, sv, st, sq), the filtered stack [spu;
// pgfu] and pg_phiv, and writes p_n, u, v, t, q: about 291.5 MB with the
// geometry, 0.087 ms at 3.35 TB/s.  K1's stencil launch reads p, sp, 11
// (L,H,W) fields (u, v, t, q, su, sv, st, sq, spu, rho, phi) and writes p_n
// and 5 fields.  chip_smoke.py works both out from its run's tensors.

#pragma once

#include <cuda_pipeline.h>

#include "gcm_stencil.cuh"

namespace gcm {

// Tile rows (a tile row is one warp) and the blocks an SM must be able to
// hold (__launch_bounds__), per type: 8 rows at both types, so that the sd
// planes of 32 layers fit beside a float64 tile.  Float32: 3 blocks (at
// most 85 registers).  Float64: 2 blocks (at most 128 registers).
template <typename T> struct TileShape;
template <> struct TileShape<float> {
  static constexpr int rows = 8, min_blocks = 3;
};
template <> struct TileShape<double> {
  static constexpr int rows = 8, min_blocks = 2;
};

// The outputs of the rest stencil and the epilogue's inputs: the filtered
// pgfu, pg_phiv and the polar wall's keep (null: no wall).
template <typename T>
struct RestOut {
  static constexpr bool kParts = false;
  T *u_n, *v_n, *t_n, *q_n;
  const T *pgfu, *pg_phiv, *keep;
};

// The outputs of K1's stencil launch.
template <typename T>
struct PartsOut {
  static constexpr bool kParts = true;
  T *v_n, *t_n, *q_n, *pu_partial, *pg_phi;
};

// Shared-memory layout of a tile, in elements of T.  The deep form (Deep)
// holds two sd slots in place of L sd planes, then aflux's pit and the
// running sum of the convergences of each sd column and 1/dx_j of the sd
// rows.
template <typename T, bool kParts, bool Deep = false>
struct Tile {
  static constexpr int TJ = TileShape<T>::rows, TI = 32;
  static constexpr int kThreads = TJ * TI;
  static constexpr int R = TJ + 2, C = TI + 2;  // rows j0-1 .. j0+TJ, columns i0-1 .. i0+TI
  static constexpr int kPlane = R * C;
  static constexpr int kSpPlane = (R + 1) * C;
  static constexpr int kRingFields = 4, kRingSlots = 4;  // su, sv, st, sq
  static constexpr int kLocalFields = kParts ? 4 : 2;    // spu, q (, rho, phi)
  static constexpr int kPointFields = kParts ? 3 : 5;    // u, v, t (, pgfu, pg_phiv)
  static constexpr int kLocalSlot = kLocalFields * kPlane + kPointFields * kThreads;
  static constexpr int kCopies = (kSpPlane + kThreads - 1) / kThreads;
  static constexpr int kSpvCopies = (R * (C - 1) + kThreads - 1) / kThreads;
  static constexpr int kLocalAt = kRingSlots * kRingFields * kPlane;
  static constexpr int kSpvAt = kLocalAt + 2 * kLocalSlot;
  static constexpr int kSpAt = kSpvAt + kPlane;
  static constexpr int kPAt = kSpAt + kSpPlane;
  static constexpr int kPnAt = kPAt + kPlane;
  // the sd planes: rows j0 .. j0+TJ, columns i0 .. i0+TI, one per layer
  static constexpr int CS = TI + 1;
  static constexpr int kSdPlane = (TJ + 1) * CS;
  static constexpr int kSdAt = kPnAt + kPlane;
  static constexpr int kPitAt = kSdAt + 2 * kSdPlane;
  static constexpr int kAccAt = kPitAt + kSdPlane;
  static constexpr int kRdxAt = kAccAt + kSdPlane;
  static constexpr size_t bytes(int L) {
    return (size_t)(Deep ? kRdxAt + TJ + 1 : kSdAt + L * kSdPlane) * sizeof(T);
  }
  static_assert((size_t)(Deep ? kRdxAt + TJ + 1 : kSdAt + held_layers<T>(kRestHeld) * kSdPlane) *
                        sizeof(T) <=
                    kMaxSharedBytes,
                "tile exceeds a block's shared memory");
};

// The stencils at one point of a tile: (dj, di) are offsets from the
// point, every plane is a tile plane of row length C but sd's, of row
// length CS.
template <typename T, int C, int CS>
struct TilePoint {
  int c, c_sd;  // the point's index in a tile plane and in an sd plane
  // ring planes at layers k-1 (_m), k and k+1 (_p); sd at k and k+1
  const T *su, *sv, *st, *sq, *su_m, *sv_m, *st_m, *sq_m, *su_p, *sv_p, *st_p, *sq_p, *sd, *sd_p;
  const T *spu, *q, *spv, *p;
  T half, rdx_j, rdx_h, rdy, rdsig, cp_at_u, cp_at_v, dt, inv_dt;
  int coriolis, q_limiter;

  __device__ __forceinline__ T at(const T* x, int dj, int di) const { return x[c + dj * C + di]; }
  __device__ __forceinline__ T spv_at(int dj, int di) const { return at(spv, dj, di); }
  __device__ __forceinline__ T sd_at(const T* s, int dj, int di) const {
    return s[c_sd + dj * CS + di];
  }

  // advec_m_pu(sp, su, sv, spu, spv), with the optional Coriolis term
  __device__ __forceinline__ void momentum(T& dut, T& dvt) const {
    auto puum = [&](int di) {
      return ((at(su, 0, di) + at(su, 0, di - 1)) * half) *
             ((at(spu, 0, di) + at(spu, 0, di - 1)) * half);
    };
    auto puvp = [&](int dj) {
      return ((spv_at(dj, 0) + spv_at(dj, 1)) * half) * ((at(su, dj, 0) + at(su, dj + 1, 0)) * half);
    };
    auto pvvm = [&](int dj) {
      return ((at(sv, dj, 0) + at(sv, dj - 1, 0)) * half) *
             ((spv_at(dj, 0) + spv_at(dj - 1, 0)) * half);
    };
    auto pvup = [&](int di) {
      return ((at(sv, 0, di) + at(sv, 0, di + 1)) * half) *
             ((at(spu, 0, di) + at(spu, 1, di)) * half);
    };
    T cor_u = T(0), cor_v = T(0);
    if (coriolis) {
      auto jph_spu = [&](int di) { return (at(spu, 0, di) + at(spu, 1, di)) * half; };
      auto jmh_spv = [&](int di) { return (spv_at(0, di) + spv_at(-1, di)) * half; };
      const T pu_at_pv = (jph_spu(0) + jph_spu(-1)) * half;
      const T pv_at_pu = (jmh_spv(0) + jmh_spv(1)) * half;
      cor_u = cp_at_u * -pv_at_pu;
      cor_v = cp_at_v * pu_at_pv;
    }
    dut = (puum(0) - puum(1)) * rdx_j + (puvp(-1) - puvp(0)) * rdy + cor_u;
    dvt = (pvvm(0) - pvvm(1)) * rdy + (pvup(-1) - pvup(0)) * rdx_h + cor_v;
  }

  // advec_sig: the vertical flux at a layer of x with the sigma-dot sdv,
  // from x at that layer (upper) and the layer above it (lower)
  __device__ __forceinline__ T vflux(T upper, T lower, T sdv) const {
    return ((upper + lower) * half) * sdv;
  }

  // advec_sig(iph(sd), su) and advec_sig(jph(sd), sv)
  __device__ __forceinline__ void sigma(T& dus, T& dvs) const {
    auto sd_iph = [&](const T* s) { return (sd_at(s, 0, 0) + sd_at(s, 0, 1)) * half; };
    auto sd_jph = [&](const T* s) { return (sd_at(s, 0, 0) + sd_at(s, 1, 0)) * half; };
    dus = -((vflux(at(su, 0, 0), at(su_m, 0, 0), sd_iph(sd)) -
             vflux(at(su_p, 0, 0), at(su, 0, 0), sd_iph(sd_p))) * rdsig);
    dvs = -((vflux(at(sv, 0, 0), at(sv_m, 0, 0), sd_jph(sd)) -
             vflux(at(sv_p, 0, 0), at(sv, 0, 0), sd_jph(sd_p))) * rdsig);
  }

  // advec_t(spu, spv, x) with x = st or sq
  __device__ __forceinline__ T adv_h(const T* x) const {
    auto tpu = [&](int di) { return at(spu, 0, di) * ((at(x, 0, di) + at(x, 0, di + 1)) * half); };
    auto tpv = [&](int dj) { return spv_at(dj, 0) * ((at(x, dj, 0) + at(x, dj + 1, 0)) * half); };
    return (tpu(0) - tpu(-1)) * rdx_j + (tpv(0) - tpv(-1)) * rdy;
  }

  __device__ __forceinline__ T adv_sig(const T* x, const T* x_m, const T* x_p) const {
    return -((vflux(at(x, 0, 0), at(x_m, 0, 0), sd_at(sd, 0, 0)) -
              vflux(at(x_p, 0, 0), at(x, 0, 0), sd_at(sd_p, 0, 0))) * rdsig);
  }

  // The new potential temperature and humidity: advec_t / advec_q_limited
  // (the ADVECQ clamp) plus advec_sig, over the new surface pressure
  // (rp_n = 1/p_n at the point).
  __device__ __forceinline__ void tracers(T t_c, T p_c, T rp_n, T& t_n, T& q_n) const {
    t_n = (t_c * p_c - (adv_h(st) + adv_sig(st, st_m, st_p)) * dt) * rp_n;

    T adv_q;
    if (q_limiter) {
      // advec_q_limited: faces clamped to half the donor cell's q*p
      auto hq = [&](int dj, int di) { return half * (at(q, dj, di) * at(p, dj, di)); };
      auto clamp = [](T x, T lo, T hi) {
        x = x < lo ? lo : x;
        return x > hi ? hi : x;
      };
      const T dt_rdx = dt * rdx_j, dt_rdy = dt * rdy;
      auto fx = [&](int di) {
        const T f = (at(spu, 0, di) * ((at(sq, 0, di) + at(sq, 0, di + 1)) * half)) * dt_rdx;
        return clamp(f, -hq(0, di + 1), hq(0, di));
      };
      auto fy = [&](int dj) {
        const T f = (spv_at(dj, 0) * ((at(sq, dj, 0) + at(sq, dj + 1, 0)) * half)) * dt_rdy;
        return clamp(f, -hq(dj + 1, 0), hq(dj, 0));
      };
      adv_q = ((fx(0) - fx(-1)) + (fy(0) - fy(-1))) * inv_dt;
    } else {
      adv_q = adv_h(sq);
    }
    q_n = (at(q, 0, 0) * p_c - (adv_q + adv_sig(sq, sq_m, sq_p)) * dt) * rp_n;
  }
};

// aflux on the tile's (TJ+1) x (TI+1) columns, the tile's and its i+1/j+1
// halo, the block's threads taking them in turn: column (r, cc), at (H,W)
// row j0+r and column i0+cc (wrapped), gets the sd of every layer in its
// place of the sd planes (gcm_stencil.cuh's aflux_column) and p_n in the
// p_n plane; a column of the tile inside the grid also writes p_n to
// device memory.  No barrier: the caller's next one publishes the planes.
template <class S, typename T>
__device__ __forceinline__ void aflux_prologue(const Params<T>& a, T* sd, T* pn, int j0, int i0) {
  for (int e = threadIdx.x; e < S::kSdPlane; e += S::kThreads) {
    const int r = e / S::CS, cc = e - r * S::CS;
    const int j = (j0 + r) % a.H, i = (i0 + cc) % a.W;
    const T p_n = aflux_column(a, j, i, sd + e, S::kSdPlane);
    pn[(r + 1) * S::C + cc + 1] = p_n;
    if (r < S::TJ && cc < S::TI && j0 + r < a.H && i0 + cc < a.W)
      a.p_n[(size_t)j * a.W + i] = p_n;
  }
}

// The deep form's prologue: aflux's column sum pit (gcm_stencil.cuh's
// aflux_pit) on the same columns as aflux_prologue, into the pit plane,
// and p_n as there; the running sums start in the layer loop.  Also the
// sd slot of the wrapped layer L, whose sd is 0, and 1/dx_j of the sd
// rows.  No barrier.
template <class S, typename T>
__device__ __forceinline__ void aflux_pit_prologue(const Params<T>& a, T* pit, T* sd_wrap, T* rdx,
                                                   T* pn, int j0, int i0) {
  for (int e = threadIdx.x; e < S::kSdPlane; e += S::kThreads) {
    const int r = e / S::CS, cc = e - r * S::CS;
    const int j = (j0 + r) % a.H, i = (i0 + cc) % a.W;
    const T p_n = aflux_pit(a, j, i, pit[e]);
    pn[(r + 1) * S::C + cc + 1] = p_n;
    if (r < S::TJ && cc < S::TI && j0 + r < a.H && i0 + cc < a.W)
      a.p_n[(size_t)j * a.W + i] = p_n;
    sd_wrap[e] = T(0);
  }
  for (int r = threadIdx.x; r <= S::TJ; r += S::kThreads) rdx[r] = T(1) / a.dx_j[(j0 + r) % a.H];
}

// The deep form's sd of layer k on the sd columns, from layer k's spu, sv
// and sp staged in the tile planes (row length C, the sd column (r, cc) at
// (r+1, cc+1)): each column's convergence with aflux_column's
// expressions, added to its running sum from layer L-1 down (acc), and sd
// = acc - pit*sigb[k], 0 at layer 0: aflux_column's values, formed a layer
// at a time as the layer loop runs from k = L-1 down.
template <class S, typename T>
__device__ __forceinline__ void sd_layer(const Params<T>& a, int k, const T* spu, const T* sv,
                                         const T* sp, const T* pit, T* acc, const T* rdx,
                                         T* sd) {
  const T half = T(0.5);
  const T rdy = T(1) / a.dy[0];
  const T dsig = a.dsig[k];
  constexpr int C = S::C;
  for (int e = threadIdx.x; e < S::kSdPlane; e += S::kThreads) {
    const int r = e / S::CS;
    const int at = (r + 1) * C + e - r * S::CS + 1;
    const T jph_sp = (sp[at] + sp[at + C]) * half;
    const T jph_sp_m = (sp[at - C] + sp[at]) * half;
    const T spv_c = sv[at] * jph_sp;
    const T spv_m = sv[at - C] * jph_sp_m;
    const T conv = ((spu[at] - spu[at - 1]) * rdx[r] + (spv_c - spv_m) * rdy) * dsig;
    const T sum = k == a.L - 1 ? conv : acc[e] + conv;
    acc[e] = sum;
    sd[e] = k == 0 ? T(0) : sum - pit[e] * a.sigb[k];
  }
}

// The tiled stencil: grid (ceil(W/32), ceil(H/TJ)), TJ*32 threads,
// Tile<T, Out::kParts, Deep>::bytes(L) of dynamic shared memory.  Out is
// RestOut (the rest tile) or PartsOut (K1).  The deep form runs its layer
// loop from k = L-1 down, so that each layer's sd comes from the running
// sum of the layers below it, and holds sd in two slots.
template <typename T, class Out, bool Deep>
__device__ __forceinline__ void tile_body(const Params<T>& a, const Out& out) {
  using S = Tile<T, Out::kParts, Deep>;
  constexpr int C = S::C, P = S::kPlane;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* const sm = reinterpret_cast<T*>(tile_smem);
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.x;
  const int ti = tid % S::TI, tj = tid / S::TI;
  const int i0 = blockIdx.x * S::TI, j0 = blockIdx.y * S::TJ;
  const int i = i0 + ti, j = j0 + tj;
  const bool active = i < W && j < H;
  const size_t jw = (size_t)j * W + i;  // read by active threads only
  // the (H,W) offsets of the tile elements this thread copies, wrapped once
  int src[S::kCopies];
#pragma unroll
  for (int n = 0; n < S::kCopies; ++n) {
    const int e = tid + n * S::kThreads;
    const int r = e / C, cc = e - r * C;
    src[n] = ((j0 - 1 + r + H) % H) * W + (i0 - 1 + cc + W) % W;
  }
  auto copy = [&](T* dst, const T* plane, int count) {
#pragma unroll
    for (int n = 0; n < S::kCopies; ++n) {
      const int e = tid + n * S::kThreads;
      if (e < count) __pipeline_memcpy_async(dst + e, plane + src[n], sizeof(T));
    }
  };
  // ring position n (layer n mod L, -1 <= n <= L) into slot (n+1) mod 4
  auto ring = [&](int n) { return sm + ((n + 1) & 3) * S::kRingFields * P; };
  auto load_ring = [&](int n) {
    const size_t off = (size_t)((n + L) % L) * HW;
    T* slot = ring(n);
    copy(slot, a.su + off, P);
    copy(slot + P, a.sv + off, P);
    copy(slot + 2 * P, a.st + off, P);
    copy(slot + 3 * P, a.sq + off, P);
  };
  // layer k's local planes into slot k mod 2; the fields read only at the
  // point itself, each thread its own
  auto local = [&](int k) { return sm + S::kLocalAt + (k & 1) * S::kLocalSlot; };
  auto point = [&](int k, int f) { return local(k) + S::kLocalFields * P + f * S::kThreads + tid; };
  auto load_local = [&](int k) {
    const size_t off = (size_t)k * HW;
    T* slot = local(k);
    copy(slot, a.spu + off, P);
    copy(slot + P, a.q + off, P);
    if constexpr (Out::kParts) {
      copy(slot + 2 * P, a.rho + off, P);
      copy(slot + 3 * P, a.phi + off, P);
    }
    if (active) {
      const T* fields[5] = {a.u, a.v, a.t, nullptr, nullptr};
      if constexpr (!Out::kParts) {
        fields[3] = out.pgfu;
        fields[4] = out.pg_phiv;
      }
#pragma unroll
      for (int f = 0; f < S::kPointFields; ++f)
        __pipeline_memcpy_async(point(k, f), fields[f] + off + jw, sizeof(T));
    }
  };
  T* const spv = sm + S::kSpvAt;
  const T* const sp = sm + S::kSpAt;
  const T* const p = sm + S::kPAt;
  T* const pn = sm + S::kPnAt;
  T* const sd = sm + S::kSdAt;  // layer k at sd[k * kSdPlane]; deep: at sd[(k & 1) * kSdPlane]
  auto sd_of = [&](int k) { return sd + (Deep ? k & 1 : k) * S::kSdPlane; };

  copy(sm + S::kSpAt, a.sp, S::kSpPlane);
  copy(sm + S::kPAt, a.p, P);
  if constexpr (Deep) {
    load_ring(L);
    load_ring(L - 1);
    load_ring(L - 2);
    load_local(L - 1);
  } else {
    load_ring(-1);
    load_ring(0);
    load_ring(1);
    load_local(0);
  }
  __pipeline_commit();

  // the prologue, while the first layers' copies are in flight
  if constexpr (Deep)
    aflux_pit_prologue<S>(a, sm + S::kPitAt, sd_of(L), sm + S::kRdxAt, pn, j0, i0);
  else
    aflux_prologue<S>(a, sd, pn, j0, i0);

  // what does not depend on k
  const T half = T(0.5), one = T(1), dt = a.dt;
  const int jr = j < H ? j : H - 1;  // a row to read for an idle thread
  const int jp = jr + 1 == H ? 0 : jr + 1;
  TilePoint<T, C, S::CS> x;
  x.c = (tj + 1) * C + ti + 1;
  x.c_sd = tj * S::CS + ti;
  x.p = p;
  x.half = half;
  x.rdx_j = one / a.dx_j[jr];
  x.rdx_h = one / a.dx_h[jr];
  x.rdy = one / a.dy[0];
  x.dt = dt;
  x.inv_dt = a.inv_dt;
  x.coriolis = a.coriolis;
  x.q_limiter = a.q_limiter;
  x.cp_at_u = x.cp_at_v = T(0);
  if (a.coriolis) {
    x.cp_at_u = sine(a.lat[jr]) * a.two_omega;
    x.cp_at_v = sine((a.lat[jr] + a.lat[jp]) * half) * a.two_omega;
  }
  T keep_j = T(0);
  if constexpr (!Out::kParts) keep_j = out.keep ? out.keep[jr] : T(0);

  __pipeline_wait_prior(0);
  __syncthreads();
  const T p_c = x.at(p, 0, 0);
  const T pu_h = (p_c + x.at(p, 0, 1)) * half;  // iph(p), jph(p) at the point
  const T pv_h = (p_c + x.at(p, 1, 0)) * half;
  const T pn_c = x.at(pn, 0, 0);
  const T rp_n = one / pn_c;
  const T rv_n = one / ((pn_c + x.at(pn, 1, 0)) * half);
  const T ru_n = one / ((pn_c + x.at(pn, 0, 1)) * half);

  for (int n = 0; n < L; ++n) {
    const int k = Deep ? L - 1 - n : n;
    __pipeline_wait_prior(0);
    __syncthreads();  // layer k has landed; every thread is done with the layer before
    if constexpr (Deep) {
      if (k >= 1) {
        load_ring(k - 2);
        load_local(k - 1);
      }
    } else {
      if (k + 2 <= L) load_ring(k + 2);
      if (k + 1 < L) load_local(k + 1);
    }
    __pipeline_commit();

    const T* cur = ring(k);
    const T* lo = local(k);
    // spv = sv * jph(sp) of layer k on rows j0-1 .. j0+TJ, columns i0 .. i0+32
#pragma unroll
    for (int n = 0; n < S::kSpvCopies; ++n) {
      const int e = tid + n * S::kThreads;
      if (e < S::R * (C - 1)) {
        const int r = e / (C - 1);
        const int at = r * C + 1 + (e - r * (C - 1));
        spv[at] = cur[P + at] * ((sp[at] + sp[at + C]) * half);
      }
    }
    if constexpr (Deep)
      sd_layer<S>(a, k, lo, cur + P, sp, sm + S::kPitAt, sm + S::kAccAt, sm + S::kRdxAt,
                  sd_of(k));
    __syncthreads();
    if (!active) continue;

    const T* above = ring(k - 1);
    const T* below = ring(k + 1);
    x.su = cur; x.sv = cur + P; x.st = cur + 2 * P; x.sq = cur + 3 * P;
    x.su_m = above; x.sv_m = above + P; x.st_m = above + 2 * P; x.sq_m = above + 3 * P;
    x.su_p = below; x.sv_p = below + P; x.st_p = below + 2 * P; x.sq_p = below + 3 * P;
    x.sd = sd_of(k);
    x.sd_p = Deep ? sd_of(k + 1) : sd_of(k + 1 == L ? 0 : k + 1);
    x.spu = lo;
    x.q = lo + P;
    x.spv = spv;
    x.rdsig = one / a.dsig[k];
    const size_t o = (size_t)k * HW + jw;

    T dut, dvt, dus, dvs;
    x.momentum(dut, dvt);
    if constexpr (Out::kParts) {
      const T* rho = lo + 2 * P;
      const T* phi = lo + 3 * P;
      T pgu, pgv, phiu, phiv;
      pgf_terms(a.sig[k], x.at(sp, 0, 0), x.at(sp, 0, 1), x.at(sp, 1, 0), x.at(rho, 0, 0),
                x.at(rho, 0, 1), x.at(rho, 1, 0), x.at(phi, 0, 0), x.at(phi, 0, 1),
                x.at(phi, 1, 0), x.rdx_j, x.rdy, pgu, pgv, phiu, phiv);
      x.sigma(dus, dvs);
      const T pu = *point(k, 0) * pu_h;
      const T pv = *point(k, 1) * pv_h;
      const T pv_n = pv - (dvt + dvs + phiv + pgv) * dt;
      out.pu_partial[o] = pu - (dut + dus) * dt;
      out.pg_phi[o] = pgu + phiu;
      out.v_n[o] = pv_n * rv_n;
    } else {
      x.sigma(dus, dvs);
      const T pu = *point(k, 0) * pu_h;
      const T pv = *point(k, 1) * pv_h;
      const T pu_partial = pu - (dut + dus) * dt;
      const T pv_partial = pv - (dvt + dvs) * dt;
      out.u_n[o] = (pu_partial - *point(k, 3) * dt) * ru_n;
      const T v_n = (pv_partial - *point(k, 4) * dt) * rv_n;
      out.v_n[o] = out.keep ? v_n * keep_j : v_n;
    }
    T t_n, q_n;
    x.tracers(*point(k, 2), p_c, rp_n, t_n, q_n);
    out.t_n[o] = t_n;
    out.q_n[o] = q_n;
  }
}

template <typename T, class Out>
__global__ void __launch_bounds__(Tile<T, Out::kParts>::kThreads, TileShape<T>::min_blocks)
    tile_stencil(const Params<T> a, const Out out) {
  tile_body<T, Out, false>(a, out);
}

// The deep form, for more than kRestHeld layers: its shared memory does
// not grow with L.
template <typename T, class Out>
__global__ void __launch_bounds__(Tile<T, Out::kParts>::kThreads, TileShape<T>::min_blocks)
    tile_stencil_deep(const Params<T> a, const Out out) {
  tile_body<T, Out, true>(a, out);
}

// Launch the tiled stencil on the caller's stream, its deep form above
// kRestHeld layers; returns 0 or the CUDA error of the attribute call or
// the launch.  It reads a.spu, a.sv and a.sp for aflux and writes a.p_n.
// A launch that was accepted adds one to *launches (when not null).  A
// plane's offsets are 32-bit.
template <typename T, class Out>
int launch_tile_stencil(const Params<T>& a, const Out& out, cudaStream_t stream,
                        int* launches) {
  using S = Tile<T, Out::kParts>;
  if ((size_t)a.H * a.W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + S::TI - 1) / S::TI, (a.H + S::TJ - 1) / S::TJ);
  if (a.L > held_layers<T>(kRestHeld))
    return launch_kernel(tile_stencil_deep<T, Out>, grid, S::kThreads,
                        Tile<T, Out::kParts, true>::bytes(a.L), stream, launches, a, out);
  return launch_kernel(tile_stencil<T, Out>, grid, S::kThreads, S::bytes(a.L), stream, launches,
                      a, out);
}

}  // namespace gcm
