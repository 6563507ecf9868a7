// K3 and K4 of the PyTorch port: the two kernels of the v2 pipeline, whose
// half step is pgf kernel -> one batched polar filter outside the kernels
// -> rest kernel (gcmiipy_tpu_torch/ops/pgf_rest.py: pgf_parts_ref and
// rest_parts_ref are the plain versions).
//
// Replace gcmiipy_tpu/ops/pallas_stencil.py:make_pgf_kernel_padded (the
// pl.pallas_call at :459) and make_rest_kernel_padded (:583).  The TPU
// kernels tile (lat, lon) blocks with a wrap-padded halo in VMEM; here the
// fields stay unpadded, every index wraps in the stencils, and the kernels
// are the stages of mega_stages.cuh (each stage exists once):
//
//   gcm_pgf_parts   one launch of the pgf tile (pgf_tile.cuh): pgf_forces
//                   into the caller's (2L,H,W) stack [spu_raw; pg_phi] and
//                   pg_phiv (L,H,W), rho and phi in shared memory only;
//   gcm_rest_parts  one launch of the rest tile (stencil_tile.cuh): aflux
//                   on the tile and its halo from the filtered spu (the
//                   stack's first L planes; sd in shared memory only, p_n
//                   written), half_timestep_rest and the momentum epilogue
//                   with the filtered pgfu (its planes L..2L, read in
//                   place: no copy) and pg_phiv, with no wall (a null
//                   keep): v's wall row stays with the caller, as in the
//                   JAX package.  It is also stages 4-5 of K5, K6 and K7.
//
// Bound: bytes.  At 9x512x1024 float32 K3 reads sp, su, st and writes the
// stack and pg_phiv (about 98 MB with the geometry, 0.03 ms at 3.35 TB/s);
// K4 reads 10 fields, the stack and pg_phiv and writes 5 fields (about
// 291.5 MB, 0.087 ms).  K3's tile keeps its recurrences (rho, phi) in
// shared memory and reads st a second time, mostly from L2 (pgf_tile.cuh).
// K4's tile reads each plane of its inputs from device memory about once,
// spu and sv a second time for its aflux prologue, mostly from L2, and
// writes no sd (stencil_tile.cuh).  chip_smoke.py works the bounds out
// from its run's tensors.

#include "mega_stages.cuh"

namespace {

void* const kNone[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};

template <typename T>
int pgf(void* const* in, void* const* geo, void* X, void* pg_phiv, int L, int H, int W,
        const double* consts, int* pgf_launches, cudaStream_t stream) {
  *pgf_launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  void* const seval[5] = {in[0], in[1], nullptr, in[2], nullptr};  // sp, su, st
  const gcm::Params<T> a = gcm::half_params<T>(kNone, seval, nullptr, geo, L, H, W, consts, 0, 0,
                                               nullptr);
  return gcm::launch_pgf_tile(a, static_cast<T*>(X), static_cast<T*>(pg_phiv), stream,
                             pgf_launches);
}

// K4: one launch of the rest tile.  out: p_n, u_n, v_n, t_n, q_n; v not
// walled.
template <typename T>
int rest(void* const* in, const void* filt_stack, const void* pg_phiv, void* const* geo,
         void* const* out, int L, int H, int W, const double* consts, int coriolis,
         int q_limiter, int* stencil_launches, cudaStream_t stream) {
  *stencil_launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  const T* stack = static_cast<const T*>(filt_stack);
  T* const* fo = reinterpret_cast<T* const*>(out);
  const gcm::Params<T> a = gcm::half_params<T>(in, in + 5, stack, geo, L, H, W, consts,
                                               coriolis, q_limiter, fo[0]);
  const T* const no_wall = nullptr;
  const gcm::RestOut<T> o{fo[1], fo[2], fo[3], fo[4], stack + (size_t)L * H * W,
                          static_cast<const T*>(pg_phiv), no_wall};
  return gcm::launch_tile_stencil(a, o, stream, stencil_launches);
}

}  // namespace

// K3, the pgf tile alone: pgf_forces(sp, su, st).  in: sp (H,W), su, st
// (L,H,W).  geo: dx_j, dx_h, lat, heightmap, sig, sigt, sigb, dsig, dy,
// ptop.  X: the (2L,H,W) stack out, pg_phiv (L,H,W) out.  consts: dt,
// 1/dt, kappa, Rd, Cp, G, 1/P0, 2*omega (dt is not read).
// *pgf_launches: set to the pgf tile's launches made.  Returns 0 or the
// CUDA error.
extern "C" int gcm_pgf_parts(int is_double, void* const* in, void* const* geo, void* X,
                             void* pg_phiv, int L, int H, int W, const double* consts,
                             int* pgf_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? pgf<double>(in, geo, X, pg_phiv, L, H, W, consts, pgf_launches, s)
                   : pgf<float>(in, geo, X, pg_phiv, L, H, W, consts, pgf_launches, s);
}

// K4: aflux, half_timestep_rest and the momentum epilogue.  in: p,u,v,t,q,
// sp,su,sv,st,sq.  filt_stack: the filtered (2L,H,W) stack [spu; pgfu].
// pg_phiv (L,H,W).  out: p_n (H,W), u_n, v_n (not walled), t_n, q_n
// (L,H,W), none of them aliasing an input.  *stencil_launches: set to the
// rest tile's launches made.  Returns 0 or the CUDA error.
extern "C" int gcm_rest_parts(int is_double, void* const* in, const void* filt_stack,
                              const void* pg_phiv, void* const* geo, void* const* out, int L,
                              int H, int W, const double* consts, int coriolis, int q_limiter,
                              int* stencil_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? rest<double>(in, filt_stack, pg_phiv, geo, out, L, H, W, consts, coriolis,
                                  q_limiter, stencil_launches, s)
                   : rest<float>(in, filt_stack, pg_phiv, geo, out, L, H, W, consts, coriolis,
                                 q_limiter, stencil_launches, s);
}
