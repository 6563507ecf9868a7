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
//   1. column_pass, one thread per (j,i) column, coalesced over i: the pgf
//      column (core25d.py pgf: p^kappa, rho and the geopotential ladder
//      phi) with gcm_stencil.cuh's pgf_column, the recurrence the pgf tile
//      of K3-K7 runs.  One pass over k writes rho[k] at once and stp[k-1]
//      into phi's plane k, with p^kappa of layers k-1 and 0 and the base in
//      registers; a second pass turns phi's planes into the ladder.  No
//      per-layer array: nothing lives in local memory.
//   2. the tiled stencil launch (stencil_tile.cuh, the rest tile of K4-K7
//      with K1's outputs): one block per (8 x 32) tile of columns.  Its
//      prologue runs aflux on the tile and its halo (sd in shared memory
//      only, p_n written); then it loops over the layers, its inputs and
//      rho and phi staged in shared memory with cp.async, and computes the
//      horizontal stencils (reach 2): momentum advection with optional
//      Coriolis, the pressure-gradient and geopotential forces, sigma
//      advection, t/q advection with the optional ADVECQ clamp.
// Every expression keeps the operand order of the plain version, and the
// library is built with -fmad=false, so each a*b+c rounds twice as the
// separate PyTorch elementwise ops do; the kernel then equals
// fused_parts_ref bit for bit in float32 and float64 wherever the card's
// pow and sin round as PyTorch's do.
//
// Bound: bytes.  At 9x512x1024 float32 the function reads 9 (L,H,W) fields,
// 3 (H,W) fields (p, sp, heightmap) and the small geometry rows, about
// 176 MB, and writes 5 (L,H,W) fields and p_n, about 97 MB: 0.081 ms at
// 3.35 TB/s per call, 0.16 ms per Matsuno step (two calls).  The scratch
// planes rho and phi add about 75 MB of traffic (written by the column
// pass, read by the tiled launch), 0.023 ms more.  The column pass alone
// reads sp, st and the heightmap and writes rho and phi: about 61 MB,
// 0.018 ms.  The arithmetic (a few hundred flops a point, one powf) is far
// below the 67 TFLOP/s float32 rate; the column pass's p^kappa and IEEE
// divisions are long instruction sequences.

#include "gcm_stencil.cuh"
#include "stencil_tile.cuh"

namespace {

using gcm::Params;

template <typename T>
__global__ void column_pass(const Params<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= a.W) return;
  const size_t HW = (size_t)a.H * a.W;
  const size_t c = (size_t)j * a.W + i;
  gcm::pgf_column(a, a.sig, a.sigt, a.dsig, a.sp[c], c,
                  [&](int k) -> T& { return a.rho[k * HW + c]; },
                  [&](int k) -> T& { return a.phi[k * HW + c]; });
}

// The column pass on the caller's stream: a.rho and a.phi from a.sp and
// a.st; adds one to *launches when it was accepted.
template <typename T>
int launch_column_pass(const Params<T>& a, cudaStream_t stream, int* launches) {
  const int kb = gcm::kBlock;
  column_pass<T><<<dim3((a.W + kb - 1) / kb, a.H), dim3(kb), 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

template <typename T>
int launch(void* const* in, void* const* geo, void* const* out, void* const* scratch,
           int L, int H, int W, const double* c, int coriolis, int q_limiter,
           int* column_launches, int* stencil_launches, cudaStream_t stream) {
  *column_launches = 0;
  *stencil_launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, c, coriolis, q_limiter);
  T* const* fo = reinterpret_cast<T* const*>(out);
  a.p_n = fo[0];
  const gcm::PartsOut<T> o{fo[1], fo[2], fo[3], fo[4], fo[5]};
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  a.phi = fs[0]; a.rho = fs[1];

  const int err = launch_column_pass(a, stream, column_launches);
  if (err) return err;
  return gcm::launch_tile_stencil(a, o, stream, stencil_launches);
}

template <typename T>
int column(const void* sp, const void* st, void* const* geo, void* rho, void* phi, int L,
           int H, int W, const double* c, int* launches, cudaStream_t stream) {
  *launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  void* in[11] = {};
  in[5] = const_cast<void*>(sp);
  in[8] = const_cast<void*>(st);
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, c, 0, 0);
  a.rho = static_cast<T*>(rho);
  a.phi = static_cast<T*>(phi);
  return launch_column_pass(a, stream, launches);
}

}  // namespace

// in: p,u,v,t,q, sp,su,sv,st,sq, spu.  geo: dx_j, dx_h, lat, heightmap,
// sig, sigt, sigb, dsig, dy, ptop.  out: p_n, v_n, t_n, q_n, pu_partial,
// pg_phi.  scratch: phi, rho (L,H,W).  consts: dt, 1/dt, kappa, Rd, Cp, G,
// 1/P0, 2*omega.  *column_launches, *stencil_launches: set to the launches
// made of the column pass and of the tiled stencil.  Returns 0 or the
// first CUDA error.
extern "C" int gcm_fused_parts(int is_double, void* const* in, void* const* geo,
                               void* const* out, void* const* scratch, int L, int H, int W,
                               const double* consts, int coriolis, int q_limiter,
                               int* column_launches, int* stencil_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(in, geo, out, scratch, L, H, W, consts, coriolis,
                                    q_limiter, column_launches, stencil_launches, s)
                   : launch<float>(in, geo, out, scratch, L, H, W, consts, coriolis,
                                   q_limiter, column_launches, stencil_launches, s);
}

// K1's column pass alone: rho and phi (L,H,W) of pgf's column from sp (H,W)
// and st (L,H,W).  geo, consts: as gcm_fused_parts (dt is not read).
// *launches: set to the launches made.  Returns 0 or the CUDA error.
extern "C" int gcm_pgf_column(int is_double, const void* sp, const void* st, void* const* geo,
                              void* rho, void* phi, int L, int H, int W, const double* consts,
                              int* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? column<double>(sp, st, geo, rho, phi, L, H, W, consts, launches, s)
                   : column<float>(sp, st, geo, rho, phi, L, H, W, consts, launches, s);
}
