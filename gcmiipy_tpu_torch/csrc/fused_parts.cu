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
// The device code of both passes lives in gcm_stencil.cuh, shared with K6
// (mega_step.cu).  Every expression keeps the operand order of the plain
// version, and the library is built with -fmad=false, so each a*b+c rounds
// twice as the separate PyTorch elementwise ops do; the kernel then agrees
// with fused_parts_ref to rounding in float32 and float64.
//
// Bound: bytes.  At 9x512x1024 float32 the function reads 9 (L,H,W) fields,
// 3 (H,W) fields (p, sp, heightmap) and the small geometry rows, about
// 176 MB, and writes 5 (L,H,W) fields and p_n, about 97 MB: 0.081 ms at
// 3.35 TB/s per call, 0.16 ms per Matsuno step (two calls).  The scratch
// planes add about 113 MB of traffic (3 planes written once and read at
// least once), 0.034 ms more, if none of it stays in the 50 MB L2.  The
// arithmetic (a few hundred flops a point, one powf) is far below the
// 67 TFLOP/s float32 rate.

#include "gcm_stencil.cuh"

namespace {

using gcm::Params;
using gcm::Point;

template <typename T>
struct Outs {
  T *v_n, *t_n, *q_n, *pu_partial, *pg_phi;
};

template <typename T>
__global__ void column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= a.W) return;
  gcm::aflux_column(a, j, i);
  gcm::pgf_column(a, j, i);
}

template <typename T>
__global__ void stencil_pass(const Params<T> a, const Outs<T> out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.W) return;
  const Point<T> x(a, blockIdx.z, blockIdx.y, i);
  T dut, dvt, pgu, pgv, phiu, phiv, dus, dvs;
  x.momentum(dut, dvt);
  x.pgf(pgu, pgv, phiu, phiv);
  x.sigma(dus, dvs);

  const T half = x.half, dt = a.dt;
  const T p_c = x.s2(a.p, x.j, i);
  const T pu = a.u[x.o] * ((p_c + x.s2(a.p, x.j, x.ip)) * half);
  const T pv = a.v[x.o] * ((p_c + x.s2(a.p, x.jp, i)) * half);
  const T pn_c = x.s2(a.p_n, x.j, i);
  const T pv_n = pv - (dvt + dvs + phiv + pgv) * dt;
  out.pu_partial[x.o] = pu - (dut + dus) * dt;
  out.pg_phi[x.o] = pgu + phiu;
  out.v_n[x.o] = pv_n * (x.one / ((pn_c + x.s2(a.p_n, x.jp, i)) * half));
  T t_n, q_n;
  x.tracers(t_n, q_n);
  out.t_n[x.o] = t_n;
  out.q_n[x.o] = q_n;
}

template <typename T>
int launch(void* const* in, void* const* geo, void* const* out, void* const* scratch,
           int L, int H, int W, const double* c, int coriolis, int q_limiter,
           cudaStream_t stream) {
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, c, coriolis, q_limiter);
  T* const* fo = reinterpret_cast<T* const*>(out);
  a.p_n = fo[0];
  const Outs<T> o{fo[1], fo[2], fo[3], fo[4], fo[5]};
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  a.sd = fs[0]; a.phi = fs[1]; a.rho = fs[2];

  const int kb = gcm::kBlock;
  column_pass<T><<<dim3((W + kb - 1) / kb, H), dim3(kb), 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stencil_pass<T><<<dim3((W + kb - 1) / kb, H, L), dim3(kb), 0, stream>>>(a, o);
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
