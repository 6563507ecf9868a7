// K1 of the PyTorch port: the "parts" of one half step of the v1 'fused'
// backend, i.e. everything between the two polar-filter applications
// (gcmiipy_tpu_torch/dynamics/core25d.py:half_timestep_parts).
//
// Replaces gcmiipy_tpu/ops/pallas_stencil.py:make_fused_parts_padded (the
// pl.pallas_call at :324).  That kernel runs the JAX core on (8,128)
// wrap-padded latitude tiles held in VMEM; none of that layout carries over.
// Here the inputs are unpadded contiguous (L,H,W) / (H,W) tensors and every
// j and i index wraps periodically, as torch.roll does in the plain version.
//
// Design: two launches on the caller's stream, no torch op between them.
//   1. column_pass, one thread per (j,i) column, loops over k.  It does the
//      vertical recurrences: aflux's column sum pit and suffix sum sd
//      (core25d.py aflux), p_n = p - pit*dt, and the pgf column: p^kappa,
//      rho and the geopotential ladder phi (core25d.py pgf).  It writes p_n
//      and the scratch planes sd, phi, rho.
//   2. stencil_pass, one thread per (k,j,i).  It reads the neighbour
//      columns' sd, phi, rho and p_n from the scratch planes and computes
//      the horizontal stencils (reach 2): momentum advection with optional
//      Coriolis, the pressure-gradient and geopotential forces, sigma
//      advection, t/q advection with the optional ADVECQ clamp.
// Every expression keeps the operand order of the plain version, and the
// library is built with -fmad=false, so each a*b+c rounds twice as the
// separate PyTorch elementwise ops do; the kernel then agrees with
// fused_parts_ref to rounding in float32 and float64.
//
// Bound: bytes.  At 9x512x1024 float32 the function reads 9 (L,H,W) fields,
// 3 (H,W) fields (p, sp, heightmap) and the small geometry rows, about
// 176 MB, and writes 5 (L,H,W) fields and p_n, about 97 MB: 0.081 ms at
// 3.35 TB/s per call, 0.16 ms per Matsuno step (two calls).  The scratch
// planes add about 113 MB of traffic (3 planes written once and read at
// least once), 0.034 ms more, if none of it stays in the 50 MB L2.  The
// arithmetic (a few hundred flops a point, one powf) is far below the
// 67 TFLOP/s float32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kBlock = 128;

__device__ __forceinline__ float power(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double power(double x, double y) { return pow(x, y); }
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
  // outputs: p_n (H,W), the rest (L,H,W)
  T *p_n, *v_n, *t_n, *q_n, *pu_partial, *pg_phi;
  // scratch (L,H,W)
  T *sd, *phi, *rho;
  int L, H, W;
  // Python floats of the plain version, cast to T as PyTorch casts them
  T dt, inv_dt, kappa, rd, cp, g, inv_p0, two_omega;
  int coriolis, q_limiter;
};

template <typename T>
__global__ void column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= a.W) return;
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

  // aflux: conv, pit (sum from k = 0), sd (sum from the top, sd[0] = 0)
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

  // pgf column: p^kappa, rho, and the geopotential ladder
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

template <typename T>
__global__ void stencil_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= a.W) return;
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int ip = i + 1 == W ? 0 : i + 1;
  const int im = i == 0 ? W - 1 : i - 1;
  const int jp = j + 1 == H ? 0 : j + 1;
  const int jm = j == 0 ? H - 1 : j - 1;
  const int kn = k + 1 == L ? 0 : k + 1;   // kp(), periodic as torch.roll
  const T half = T(0.5), one = T(1);
  const T rdx_j = one / a.dx_j[j];
  const T rdx_h = one / a.dx_h[j];
  const T rdy = one / a.dy[0];
  const T rdsig = one / a.dsig[k];
  const T dt = a.dt;

  auto wj = [H](int jj) { return jj == H ? 0 : (jj < 0 ? H - 1 : jj); };
  auto wi = [W](int ii) { return ii == W ? 0 : (ii < 0 ? W - 1 : ii); };
  // (H,W) plane and layer-kk plane of an (L,H,W) field
  auto s2 = [W](const T* x, int jj, int ii) { return x[(size_t)jj * W + ii]; };
  auto s3 = [W, HW](const T* x, int kk, int jj, int ii) {
    return x[kk * HW + (size_t)jj * W + ii];
  };
  // spv = sv * jph(sp) at layer k (calc_pv)
  auto spv = [&](int jj, int ii) {
    return s3(a.sv, k, jj, ii) * ((s2(a.sp, jj, ii) + s2(a.sp, wj(jj + 1), ii)) * half);
  };

  // advec_m_pu(sp, su, sv, spu, spv)
  auto puum = [&](int ii) {
    const int iim = wi(ii - 1);
    return ((s3(a.su, k, j, ii) + s3(a.su, k, j, iim)) * half) *
           ((s3(a.spu, k, j, ii) + s3(a.spu, k, j, iim)) * half);
  };
  auto puvp = [&](int jj) {
    return ((spv(jj, i) + spv(jj, ip)) * half) *
           ((s3(a.su, k, jj, i) + s3(a.su, k, wj(jj + 1), i)) * half);
  };
  auto pvvm = [&](int jj) {
    const int jjm = wj(jj - 1);
    return ((s3(a.sv, k, jj, i) + s3(a.sv, k, jjm, i)) * half) *
           ((spv(jj, i) + spv(jjm, i)) * half);
  };
  auto pvup = [&](int ii) {
    return ((s3(a.sv, k, j, ii) + s3(a.sv, k, j, wi(ii + 1))) * half) *
           ((s3(a.spu, k, j, ii) + s3(a.spu, k, jp, ii)) * half);
  };
  T cor_u = T(0), cor_v = T(0);
  if (a.coriolis) {
    auto jph_spu = [&](int ii) {
      return (s3(a.spu, k, j, ii) + s3(a.spu, k, jp, ii)) * half;
    };
    auto jmh_spv = [&](int ii) { return (spv(j, ii) + spv(jm, ii)) * half; };
    const T pu_at_pv = (jph_spu(i) + jph_spu(im)) * half;
    const T pv_at_pu = (jmh_spv(i) + jmh_spv(ip)) * half;
    const T cp_at_u = sine(a.lat[j]) * a.two_omega;
    const T cp_at_v = sine((a.lat[j] + a.lat[jp]) * half) * a.two_omega;
    cor_u = cp_at_u * -pv_at_pu;
    cor_v = cp_at_v * pu_at_pv;
  }
  const T dut = (puum(i) - puum(ip)) * rdx_j + (puvp(jm) - puvp(j)) * rdy + cor_u;
  const T dvt = (pvvm(j) - pvvm(jp)) * rdy + (pvup(im) - pvup(i)) * rdx_h + cor_v;

  // pgf(sp, st): forces from the column pass's rho and phi
  const T sp_c = s2(a.sp, j, i), sp_ip = s2(a.sp, j, ip), sp_jp = s2(a.sp, jp, i);
  const T sig = a.sig[k];
  const T rho_c = s3(a.rho, k, j, i);
  const T phi_c = s3(a.phi, k, j, i);
  const T pgu = ((sig * sp_c + sig * sp_ip) * half) / ((rho_c + s3(a.rho, k, j, ip)) * half) *
                ((sp_ip - sp_c) * rdx_j);
  const T pgv = ((sig * sp_c + sig * sp_jp) * half) / ((rho_c + s3(a.rho, k, jp, i)) * half) *
                ((sp_jp - sp_c) * rdy);
  const T phiu = ((sp_c + sp_ip) * half) * ((s3(a.phi, k, j, ip) - phi_c) * rdx_j);
  const T phiv = ((sp_c + sp_jp) * half) * ((s3(a.phi, k, jp, i) - phi_c) * rdy);

  // advec_sig: vertical flux at layer kk of q with the sigma-dot sdv
  auto vflux = [&](const T* q, int kk, T sdv) {
    const int kkm = kk == 0 ? L - 1 : kk - 1;
    return ((s3(q, kk, j, i) + s3(q, kkm, j, i)) * half) * sdv;
  };
  auto sd_iph = [&](int kk) { return (s3(a.sd, kk, j, i) + s3(a.sd, kk, j, ip)) * half; };
  auto sd_jph = [&](int kk) { return (s3(a.sd, kk, j, i) + s3(a.sd, kk, jp, i)) * half; };
  const T sd_c = s3(a.sd, k, j, i), sd_n = s3(a.sd, kn, j, i);
  const T dus = -((vflux(a.su, k, sd_iph(k)) - vflux(a.su, kn, sd_iph(kn))) * rdsig);
  const T dvs = -((vflux(a.sv, k, sd_jph(k)) - vflux(a.sv, kn, sd_jph(kn))) * rdsig);

  const size_t o = k * HW + (size_t)j * W + i;
  const T p_c = s2(a.p, j, i);
  const T pu = a.u[o] * ((p_c + s2(a.p, j, ip)) * half);
  const T pv = a.v[o] * ((p_c + s2(a.p, jp, i)) * half);
  const T pn_c = s2(a.p_n, j, i);
  const T pv_n = pv - (dvt + dvs + phiv + pgv) * dt;
  a.pu_partial[o] = pu - (dut + dus) * dt;
  a.pg_phi[o] = pgu + phiu;
  a.v_n[o] = pv_n * (one / ((pn_c + s2(a.p_n, jp, i)) * half));

  // advec_t(spu, spv, x) with x = st or sq
  auto adv_h = [&](const T* x) {
    auto tpu = [&](int ii) {
      return s3(a.spu, k, j, ii) * ((s3(x, k, j, ii) + s3(x, k, j, wi(ii + 1))) * half);
    };
    auto tpv = [&](int jj) {
      return spv(jj, i) * ((s3(x, k, jj, i) + s3(x, k, wj(jj + 1), i)) * half);
    };
    return (tpu(i) - tpu(im)) * rdx_j + (tpv(j) - tpv(jm)) * rdy;
  };
  auto adv_sig = [&](const T* x) {
    return -((vflux(x, k, sd_c) - vflux(x, kn, sd_n)) * rdsig);
  };
  const T rp_n = one / pn_c;
  a.t_n[o] = (a.t[o] * p_c - (adv_h(a.st) + adv_sig(a.st)) * dt) * rp_n;

  T adv_q;
  if (a.q_limiter) {
    // advec_q_limited: faces clamped to half the donor cell's q*p
    auto hq = [&](int jj, int ii) { return half * (s3(a.q, k, jj, ii) * s2(a.p, jj, ii)); };
    auto clamp = [](T x, T lo, T hi) {
      x = x < lo ? lo : x;
      return x > hi ? hi : x;
    };
    const T dt_rdx = dt * rdx_j, dt_rdy = dt * rdy;
    auto fx = [&](int ii) {
      const int iip = wi(ii + 1);
      const T f = (s3(a.spu, k, j, ii) * ((s3(a.sq, k, j, ii) + s3(a.sq, k, j, iip)) * half)) * dt_rdx;
      return clamp(f, -hq(j, iip), hq(j, ii));
    };
    auto fy = [&](int jj) {
      const int jjp = wj(jj + 1);
      const T f = (spv(jj, i) * ((s3(a.sq, k, jj, i) + s3(a.sq, k, jjp, i)) * half)) * dt_rdy;
      return clamp(f, -hq(jjp, i), hq(jj, i));
    };
    adv_q = ((fx(i) - fx(im)) + (fy(j) - fy(jm))) * a.inv_dt;
  } else {
    adv_q = adv_h(a.sq);
  }
  a.q_n[o] = (a.q[o] * p_c - (adv_q + adv_sig(a.sq)) * dt) * rp_n;
}

template <typename T>
int launch(void* const* in, void* const* geo, void* const* out, void* const* scratch,
           int L, int H, int W, const double* c, int coriolis, int q_limiter,
           cudaStream_t stream) {
  if (L < 1 || L > kMaxLayers || H < 1 || H > 65535 || W < 1) return (int)cudaErrorInvalidValue;
  Params<T> a;
  const T* const* fin = reinterpret_cast<const T* const*>(in);
  a.p = fin[0]; a.u = fin[1]; a.v = fin[2]; a.t = fin[3]; a.q = fin[4];
  a.sp = fin[5]; a.su = fin[6]; a.sv = fin[7]; a.st = fin[8]; a.sq = fin[9];
  a.spu = fin[10];
  const T* const* g = reinterpret_cast<const T* const*>(geo);
  a.dx_j = g[0]; a.dx_h = g[1]; a.lat = g[2]; a.heightmap = g[3];
  a.sig = g[4]; a.sigt = g[5]; a.sigb = g[6]; a.dsig = g[7]; a.dy = g[8]; a.ptop = g[9];
  T* const* fo = reinterpret_cast<T* const*>(out);
  a.p_n = fo[0]; a.v_n = fo[1]; a.t_n = fo[2]; a.q_n = fo[3]; a.pu_partial = fo[4]; a.pg_phi = fo[5];
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  a.sd = fs[0]; a.phi = fs[1]; a.rho = fs[2];
  a.L = L; a.H = H; a.W = W;
  a.dt = T(c[0]); a.inv_dt = T(c[1]); a.kappa = T(c[2]); a.rd = T(c[3]);
  a.cp = T(c[4]); a.g = T(c[5]); a.inv_p0 = T(c[6]); a.two_omega = T(c[7]);
  a.coriolis = coriolis; a.q_limiter = q_limiter;

  const dim3 block(kBlock);
  column_pass<T><<<dim3((W + kBlock - 1) / kBlock, H), block, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stencil_pass<T><<<dim3((W + kBlock - 1) / kBlock, H, L), block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// in: p,u,v,t,q, sp,su,sv,st,sq, spu.  geo: dx_j, dx_h, lat, heightmap,
// sig, sigt, sigb, dsig, dy, ptop.  out: p_n, v_n, t_n, q_n, pu_partial,
// pg_phi.  scratch: sd, phi, rho.  consts: dt, 1/dt, kappa, Rd, Cp, G,
// 1/P0, 2*omega.  Returns cudaGetLastError() after the launches.
extern "C" int gcm_fused_parts(int is_double, void* const* in, void* const* geo,
                               void* const* out, void* const* scratch, int L, int H, int W,
                               const double* consts, int coriolis, int q_limiter,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(in, geo, out, scratch, L, H, W, consts, coriolis, q_limiter, s)
                   : launch<float>(in, geo, out, scratch, L, H, W, consts, coriolis, q_limiter, s);
}
