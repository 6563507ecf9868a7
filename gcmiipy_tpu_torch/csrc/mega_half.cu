// K5 of the PyTorch port: one half step of the 'mega' backend with the DFT
// polar filter, behind one C entry point
// (gcmiipy_tpu_torch/ops/mega_step.py:mega_half_ref is the plain version).
//
// Replaces gcmiipy_tpu/ops/pallas_stencil.py:make_mega_kernel_padded (the
// pl.pallas_call at :849): pgf_forces, the filter in correction form
// Y = X + ((X@C)(m-1))@Cw + ((X@S)(m-1))@Sw on the stacked [spu_raw; pg_phi],
// half_timestep_rest and the momentum epilogue.  It runs K6's six stages of
// one half (mega_stages.cuh); the polar wall is the keep of the filter
// constants, inside the kernel (the JAX kernel leaves it to its caller).
//
// The TPU kernel sums every row over all W/2 damped wavenumbers.  A chunk
// beyond a row's band has a correction mask of exactly 0, so it adds +0.0
// after the row's own chunks: the host's row list (ops/mega_half.py) gives
// each row its banded trip count, as K6's, and the result is the same to
// the bit.
//
// Bound: operations.  At 9x512x1024 one half filters 2L*H = 9216 rows over
// 1, 2, 3 or 4 chunks, 23040 row-chunks of 2*256*1024 multiply-adds:
// 24.16 GFLOP in double, 0.36 ms at the H100's 67 TFLOP/s double rate; its
// scratch A (R x W doubles) is 75.5 MB.  chip_smoke.py works the bound out
// from its run's tensors and trip counts.

#include "mega_stages.cuh"

namespace {

template <typename T>
int launch(void* const* base, void* const* seval, void* const* geo, void* const* filt,
           const void* rows, const void* counts, int R, int ncols, void* const* out,
           void* const* scratch, int L, int H, int W, const double* consts, int coriolis,
           int q_limiter, cudaStream_t stream) {
  if (gcm::bad_shape(L, H, W) || gcm::bad_filter(R, ncols)) return (int)cudaErrorInvalidValue;
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, rows, counts, R, ncols, scratch, L, H, W,
                                           consts, coriolis, q_limiter, stream);
  return gcm::half_step(s, base, seval, out);
}

}  // namespace

// One half step.  base, seval: p,u,v,t,q (may be the same table).  geo:
// dx_j, dx_h, lat, heightmap, sig, sigt, sigb, dsig, dy, ptop.  filt: CS
// (W,ncols), CwSw (ncols,W), mcc (H,ncols), all double, and keep (H).
// rows, counts: int32 (R,) listed filter rows.  out: p,u,v,t,q, aliasing
// no input.  scratch: X (2L,H,W), pg_phiv, sd, phi, rho (L,H,W), and A
// (R,ncols) in double.  consts: dt, 1/dt, kappa, Rd, Cp, G, 1/P0, 2*omega.
// Returns 0 or the first CUDA error.
extern "C" int gcm_mega_half(int is_double, void* const* base, void* const* seval,
                             void* const* geo, void* const* filt, const void* rows,
                             const void* counts, int R, int ncols, void* const* out,
                             void* const* scratch, int L, int H, int W, const double* consts,
                             int coriolis, int q_limiter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(base, seval, geo, filt, rows, counts, R, ncols, out, scratch, L, H,
                              W, consts, coriolis, q_limiter, s)
             : launch<float>(base, seval, geo, filt, rows, counts, R, ncols, out, scratch, L, H,
                             W, consts, coriolis, q_limiter, s);
}
