// Device code shared by the port's stencil kernels: the column recurrences
// and the pgf forces of one half step of the 2.5D core
// (gcmiipy_tpu_torch/dynamics/core25d.py); the point stencils are in
// stencil_tile.cuh and pgf_tile.cuh.  K1 (fused_parts.cu) and K3-K7
// (mega_stages.cuh) build their stages from these pieces, so the kernels
// round every expression alike.
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

namespace gcm {

constexpr int kMaxLayers = 32;
constexpr int kBlock = 128;

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
  // new surface pressure (H,W), written by aflux_column
  T* p_n;
  // column scratch (L,H,W): sigma-dot, geopotential, density
  T *sd, *phi, *rho;
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
  a.p_n = nullptr; a.sd = nullptr; a.phi = nullptr; a.rho = nullptr;
  a.L = L; a.H = H; a.W = W;
  a.dt = T(c[0]); a.inv_dt = T(c[1]); a.kappa = T(c[2]); a.rd = T(c[3]);
  a.cp = T(c[4]); a.g = T(c[5]); a.inv_p0 = T(c[6]); a.two_omega = T(c[7]);
  a.coriolis = coriolis; a.q_limiter = q_limiter;
  return a;
}

inline bool bad_shape(int L, int H, int W) {
  return L < 1 || L > kMaxLayers || H < 1 || H > 65535 || W < 1;
}

// aflux (core25d.aflux) on column (j,i): the convergence of the filtered
// mass flux, its column sum pit (from k = 0) and suffix sum sd (from the
// top, sd[0] = 0); p_n = p - pit*dt.  Writes a.sd and a.p_n.
template <typename T>
__device__ __forceinline__ void aflux_column(const Params<T>& a, int j, int i) {
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

  T conv[kMaxLayers];
  for (int k = 0; k < L; ++k) {
    const size_t o = k * HW;
    const T spv_c = a.sv[o + c] * jph_sp;
    const T spv_m = a.sv[o + c_jm] * jph_sp_m;
    conv[k] = ((a.spu[o + c] - a.spu[o + c_im]) * rdx_j + (spv_c - spv_m) * rdy) * a.dsig[k];
  }
  T pit = conv[0];
  for (int k = 1; k < L; ++k) pit = pit + conv[k];
  T acc = conv[L - 1];
  for (int k = L - 1; k >= 0; --k) {
    if (k < L - 1) acc = acc + conv[k];
    a.sd[k * HW + c] = k == 0 ? T(0) : acc - pit * a.sigb[k];
  }
  a.p_n[c] = a.p[c] - pit * a.dt;
}

// The pgf column (core25d.pgf) on column (j,i): p^kappa, rho and the
// geopotential ladder phi, for K1's column pass (the pgf tile of K3-K7
// forms the same values layer by layer, pgf_tile.cuh).  Writes a.rho and
// a.phi.
template <typename T>
__device__ __forceinline__ void pgf_column(const Params<T>& a, int j, int i) {
  const int L = a.L;
  const size_t HW = (size_t)a.H * a.W;
  const size_t c = (size_t)j * a.W + i;
  const T half = T(0.5);
  const T sp_c = a.sp[c];
  const T ptop = a.ptop[0];
  T pk[kMaxLayers], s1[kMaxLayers];
  for (int k = 0; k < L; ++k) {
    const T tp = sp_c * a.sig[k] + ptop;
    pk[k] = power(tp * a.inv_p0, a.kappa);
    const T tt = a.st[k * HW + c] * pk[k];
    const T rho = tp / (a.rd * tt);
    a.rho[k * HW + c] = rho;
    s1[k] = ((a.sig[k] * sp_c) / rho) * a.dsig[k];
  }
  T stp[kMaxLayers];
  for (int k = 0; k < L; ++k) {
    const int kn = k + 1 == L ? 0 : k + 1;
    const T kph_t = (a.st[k * HW + c] + a.st[kn * HW + c]) * half;
    stp[k] = (a.cp * kph_t) * (pk[k] - pk[kn]);
  }
  T base = s1[0] - a.sigt[0] * stp[0];
  for (int k = 1; k < L; ++k) base = base + (s1[k] - a.sigt[k] * stp[k]);
  base = base + a.heightmap[c] * a.g;
  T ph = base;
  a.phi[c] = ph;
  for (int k = 1; k < L; ++k) {
    ph = ph + stp[k - 1];
    a.phi[k * HW + c] = ph;
  }
}

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
