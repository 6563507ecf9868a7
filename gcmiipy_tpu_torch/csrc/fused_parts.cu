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
//      and the scratch planes sd, phi, rho (gcm_stencil.cuh; the aflux
//      column is stage 4 of K4-K7, and the pgf tile of K3-K7 forms the pgf
//      column's values with the same expressions).
//   2. the tiled stencil launch (stencil_tile.cuh, shared with the rest
//      stencil of K4-K7): one block per (8 x 32) tile of columns looping
//      over the layers, its inputs and the scratch planes staged in shared
//      memory with cp.async.  It computes the horizontal stencils (reach
//      2): momentum advection with optional Coriolis, the pressure-gradient
//      and geopotential forces, sigma advection, t/q advection with the
//      optional ADVECQ clamp.
// Every expression keeps the operand order of the plain version, and the
// library is built with -fmad=false, so each a*b+c rounds twice as the
// separate PyTorch elementwise ops do; the kernel then equals
// fused_parts_ref bit for bit in float32 and float64.
//
// Bound: bytes.  At 9x512x1024 float32 the function reads 9 (L,H,W) fields,
// 3 (H,W) fields (p, sp, heightmap) and the small geometry rows, about
// 176 MB, and writes 5 (L,H,W) fields and p_n, about 97 MB: 0.081 ms at
// 3.35 TB/s per call, 0.16 ms per Matsuno step (two calls).  The scratch
// planes add about 113 MB of traffic (3 planes written once and read
// once by the tiled launch), 0.034 ms more.  The column pass keeps its
// recurrences in per-thread arrays, which live in local memory; it reads
// and writes about 120 MB (0.036 ms) and is not tiled.  The arithmetic (a
// few hundred flops a point, one powf) is far below the 67 TFLOP/s
// float32 rate.

#include "gcm_stencil.cuh"
#include "stencil_tile.cuh"

namespace {

using gcm::Params;

template <typename T>
__global__ void column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= a.W) return;
  gcm::aflux_column(a, j, i);
  gcm::pgf_column(a, j, i);
}

template <typename T>
int launch(void* const* in, void* const* geo, void* const* out, void* const* scratch,
           int L, int H, int W, const double* c, int coriolis, int q_limiter,
           cudaStream_t stream) {
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, c, coriolis, q_limiter);
  T* const* fo = reinterpret_cast<T* const*>(out);
  a.p_n = fo[0];
  const gcm::PartsOut<T> o{fo[1], fo[2], fo[3], fo[4], fo[5]};
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  a.sd = fs[0]; a.phi = fs[1]; a.rho = fs[2];

  const int kb = gcm::kBlock;
  column_pass<T><<<dim3((W + kb - 1) / kb, H), dim3(kb), 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gcm::launch_tile_stencil(a, o, stream, nullptr);
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
