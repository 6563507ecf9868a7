// Device code shared by the port's stencil kernels: the column recurrences
// (aflux_column, the rest tile's prologue; pgf_column, the pgf tile's and
// K1's column pass) and the pgf forces of one half step of the 2.5D core
// (gcmiipy_tpu_torch/dynamics/core25d.py); the point stencils are in
// stencil_tile.cuh and pgf_tile.cuh.  K1 (fused_parts.cu) and K3-K7
// (mega_stages.cuh) build their stages from these pieces, so the kernels
// round every expression alike.  Neither recurrence keeps a per-layer
// array: its values go to the caller's planes as they are formed.
//
// Every expression keeps the operand order of the plain PyTorch version,
// and the library is built with -fmad=false, so each a*b+c rounds twice as
// the separate PyTorch elementwise ops do.  Fields are unpadded contiguous
// (L,H,W) / (H,W) arrays; every j and i index wraps periodically, as
// torch.roll does in the plain version.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gcm_limits.cuh"

namespace gcm {

__device__ __forceinline__ float power(float x, float y) { return powf(x, y); }
#ifdef GCM_POW_LINKED
// a float64 library: double pow as PyTorch rounds it (gcm_pow.cu)
__device__ double pow_contracted(double x, double y);
__device__ __forceinline__ double power(double x, double y) { return pow_contracted(x, y); }
#else
__device__ __forceinline__ double power(double x, double y) { return pow(x, y); }
#endif
__device__ __forceinline__ float sine(float x) { return sinf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float cosine(float x) { return cosf(x); }
__device__ __forceinline__ double cosine(double x) { return cos(x); }

template <typename T>
struct Params {
  // base state (p is (H,W), the rest (L,H,W))
  const T *p, *u, *v, *t, *q;
  // state the tendencies are evaluated at (sp is (H,W))
  const T *sp, *su, *sv, *st, *sq;
  // filtered zonal mass flux (L,H,W)
  const T *spu;
  // geometry: rows (H), heightmap (H,W), sigma ladder (L), scalars
  const T *dx_j, *dx_h, *lat, *heightmap, *sig, *sigt, *sigb, *dsig, *dy, *ptop;
  // new surface pressure (H,W), written by the rest tile's aflux prologue
  T* p_n;
  // K1's column scratch (L,H,W): geopotential, density
  T *phi, *rho;
  int L, H, W;
  // Python floats of the plain version, cast to T as PyTorch casts them
  T dt, inv_dt, kappa, rd, cp, g, inv_p0, two_omega;
  int coriolis, q_limiter;
};

// Params from the pointer tables of the C entry points.  in: p,u,v,t,q,
// sp,su,sv,st,sq, spu.  geo: dx_j, dx_h, lat, heightmap, sig, sigt, sigb,
// dsig, dy, ptop.  consts: dt, 1/dt, kappa, Rd, Cp, G, 1/P0, 2*omega.
template <typename T>
Params<T> make_params(void* const* in, void* const* geo, int L, int H, int W,
                      const double* c, int coriolis, int q_limiter) {
  Params<T> a;
  const T* const* fin = reinterpret_cast<const T* const*>(in);
  a.p = fin[0]; a.u = fin[1]; a.v = fin[2]; a.t = fin[3]; a.q = fin[4];
  a.sp = fin[5]; a.su = fin[6]; a.sv = fin[7]; a.st = fin[8]; a.sq = fin[9];
  a.spu = fin[10];
  const T* const* g = reinterpret_cast<const T* const*>(geo);
  a.dx_j = g[0]; a.dx_h = g[1]; a.lat = g[2]; a.heightmap = g[3];
  a.sig = g[4]; a.sigt = g[5]; a.sigb = g[6]; a.dsig = g[7]; a.dy = g[8]; a.ptop = g[9];
  a.p_n = nullptr; a.phi = nullptr; a.rho = nullptr;
  a.L = L; a.H = H; a.W = W;
  a.dt = T(c[0]); a.inv_dt = T(c[1]); a.kappa = T(c[2]); a.rd = T(c[3]);
  a.cp = T(c[4]); a.g = T(c[5]); a.inv_p0 = T(c[6]); a.two_omega = T(c[7]);
  a.coriolis = coriolis; a.q_limiter = q_limiter;
  return a;
}

// aflux (core25d.aflux) on column (j,i): the convergence of the filtered
// mass flux conv[k] into col[k * stride], then in place from the top the
// sigma-dot sd[k] = acc - pit*sigb[k], sd[0] = 0, where pit sums conv from
// k = 0 and acc from k = L-1 down, the plain version's orders.  Returns
// p_n = p - pit*dt.  col is a column of the rest tile's shared planes
// (stencil_tile.cuh), so no per-layer array lives in local memory.
template <typename T>
__device__ __forceinline__ T aflux_column(const Params<T>& a, int j, int i, T* col,
                                          int stride) {
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int jp = j + 1 == H ? 0 : j + 1;
  const int jm = j == 0 ? H - 1 : j - 1;
  const int im = i == 0 ? W - 1 : i - 1;
  const size_t c = (size_t)j * W + i;
  const size_t c_jm = (size_t)jm * W + i;
  const size_t c_im = (size_t)j * W + im;
  const T half = T(0.5), one = T(1);
  const T rdx_j = one / a.dx_j[j];
  const T rdy = one / a.dy[0];
  const T sp_c = a.sp[c];
  const T jph_sp = (sp_c + a.sp[(size_t)jp * W + i]) * half;
  const T jph_sp_m = (a.sp[c_jm] + sp_c) * half;

  for (int k = 0; k < L; ++k) {
    const size_t o = k * HW;
    const T spv_c = a.sv[o + c] * jph_sp;
    const T spv_m = a.sv[o + c_jm] * jph_sp_m;
    col[k * stride] =
        ((a.spu[o + c] - a.spu[o + c_im]) * rdx_j + (spv_c - spv_m) * rdy) * a.dsig[k];
  }
  T pit = col[0];
  for (int k = 1; k < L; ++k) pit = pit + col[k * stride];
  T acc = col[(L - 1) * stride];
  for (int k = L - 1; k >= 0; --k) {
    if (k < L - 1) acc = acc + col[k * stride];
    col[k * stride] = k == 0 ? T(0) : acc - pit * a.sigb[k];
  }
  return a.p[c] - pit * a.dt;
}

// aflux's column sum alone, the rest tile's deep form (stencil_tile.cuh):
// pit of column (j,i), the convergences summed from k = 0 with
// aflux_column's expressions, into pit; returns p_n = p - pit*dt.  The deep
// form forms each layer's convergence again in its layer loop, from the
// fields staged in shared memory, and the sigma-dot from it.
template <typename T>
__device__ __forceinline__ T aflux_pit(const Params<T>& a, int j, int i, T& pit) {
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int jp = j + 1 == H ? 0 : j + 1;
  const int jm = j == 0 ? H - 1 : j - 1;
  const int im = i == 0 ? W - 1 : i - 1;
  const size_t c = (size_t)j * W + i;
  const size_t c_jm = (size_t)jm * W + i;
  const size_t c_im = (size_t)j * W + im;
  const T half = T(0.5), one = T(1);
  const T rdx_j = one / a.dx_j[j];
  const T rdy = one / a.dy[0];
  const T sp_c = a.sp[c];
  const T jph_sp = (sp_c + a.sp[(size_t)jp * W + i]) * half;
  const T jph_sp_m = (a.sp[c_jm] + sp_c) * half;
  for (int k = 0; k < L; ++k) {
    const size_t o = k * HW;
    const T spv_c = a.sv[o + c] * jph_sp;
    const T spv_m = a.sv[o + c_jm] * jph_sp_m;
    const T conv =
        ((a.spu[o + c] - a.spu[o + c_im]) * rdx_j + (spv_c - spv_m) * rdy) * a.dsig[k];
    pit = k == 0 ? conv : pit + conv;
  }
  return a.p[c] - pit * a.dt;
}

// The pgf column (core25d.pgf) on the column at (H,W) offset off, one pass
// over k with no per-layer array: layer k's rho goes to rho(k) and stp[k-1]
// to phi(k) (k >= 1) as they are formed, p^kappa of layers k-1 and 0 (for
// the periodic stp[L-1], the plain version's kp) stay in registers, and
// base = sum over k of (s1[k] - sigt[k]*stp[k]) is carried in k order.  A
// second pass turns phi(k) in place into the geopotential ladder, phi[0] =
// base + heightmap*G, phi[k] = phi[k-1] + stp[k-1].  rho and phi map k to a
// T&: the pgf tile's shared planes (pgf_tile.cuh) or K1's scratch planes in
// device memory (fused_parts.cu); sig, sigt, dsig: the geometry's layer
// rows, in shared or device memory.
template <typename T, class Rho, class Phi>
__device__ __forceinline__ void pgf_column(const Params<T>& a, const T* sig, const T* sigt,
                                           const T* dsig, T sp, size_t off, Rho&& rho,
                                           Phi&& phi) {
  const int L = a.L;
  const size_t HW = (size_t)a.H * a.W;
  const T half = T(0.5);
  const T ptop = a.ptop[0];
  const T st0 = a.st[off];
  T st_k = st0, pk0 = T(0), pk_prev = T(0), st_prev = T(0), s1_prev = T(0), base = T(0);
  for (int k = 0; k < L; ++k) {
    const T st_next = k + 1 < L ? a.st[(k + 1) * HW + off] : T(0);
    const T tp = sp * sig[k] + ptop;
    const T pk = power(tp * a.inv_p0, a.kappa);
    const T tt = st_k * pk;
    const T rk = tp / (a.rd * tt);
    rho(k) = rk;
    const T s1 = ((sig[k] * sp) / rk) * dsig[k];
    if (k == 0) {
      pk0 = pk;
    } else {
      const T stp = (a.cp * ((st_prev + st_k) * half)) * (pk_prev - pk);
      phi(k) = stp;
      const T term = s1_prev - sigt[k - 1] * stp;
      base = k == 1 ? term : base + term;
    }
    s1_prev = s1;
    pk_prev = pk;
    st_prev = st_k;
    st_k = st_next;
  }
  const T stp = (a.cp * ((st_prev + st0) * half)) * (pk_prev - pk0);
  const T term = s1_prev - sigt[L - 1] * stp;
  base = L == 1 ? term : base + term;
  T ph = base + a.heightmap[off] * a.g;
  phi(0) = ph;
  for (int k = 1; k < L; ++k) {
    ph = ph + phi(k);
    phi(k) = ph;
  }
}

// pgf_column's pass over k one layer a call, for the pgf tile's deep form
// (pgf_tile.cuh), which holds one layer of rho and phi at a time: with ph
// the ladder's foot phi[0] (pgf_column's value) and st_k the column's st
// at layer 0, layer(k) for k = 0, 1, ... gives layer k's rho and phi[k]
// from pgf_column's expressions, p^kappa of layer k formed again.
template <typename T>
struct PgfLayer {
  T ph, st_k, pk_prev, st_prev;

  __device__ __forceinline__ void layer(const Params<T>& a, const T* sig, T sp, T ptop,
                                        size_t off, size_t HW, int k, T& rho, T& phi) {
    const T st_next = k + 1 < a.L ? a.st[(k + 1) * HW + off] : T(0);
    const T tp = sp * sig[k] + ptop;
    const T pk = power(tp * a.inv_p0, a.kappa);
    const T tt = st_k * pk;
    rho = tp / (a.rd * tt);
    if (k > 0) ph = ph + (a.cp * ((st_prev + st_k) * T(0.5))) * (pk_prev - pk);
    phi = ph;
    pk_prev = pk;
    st_prev = st_k;
    st_k = st_next;
  }
};

// pgf's forces at a point from sp, rho and phi at the point and at its
// i+1 and j+1 neighbours, shared by the pgf tile (pgf_tile.cuh) and K1's
// tiled launch.
template <typename T>
__device__ __forceinline__ void pgf_terms(T sig, T sp_c, T sp_ip, T sp_jp, T rho_c, T rho_ip,
                                          T rho_jp, T phi_c, T phi_ip, T phi_jp, T rdx_j,
                                          T rdy, T& pgu, T& pgv, T& phiu, T& phiv) {
  const T half = T(0.5);
  pgu = ((sig * sp_c + sig * sp_ip) * half) / ((rho_c + rho_ip) * half) *
        ((sp_ip - sp_c) * rdx_j);
  pgv = ((sig * sp_c + sig * sp_jp) * half) / ((rho_c + rho_jp) * half) *
        ((sp_jp - sp_c) * rdy);
  phiu = ((sp_c + sp_ip) * half) * ((phi_ip - phi_c) * rdx_j);
  phiv = ((sp_c + sp_jp) * half) * ((phi_jp - phi_c) * rdy);
}

}  // namespace gcm
