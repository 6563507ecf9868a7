// K6 of the PyTorch port: one whole Matsuno step of the 'mega4' backend,
// with the banded DFT polar filter, behind one C entry point
// (gcmiipy_tpu_torch/ops/mega_step.py:mega_step_ref is the plain version).
//
// Replaces gcmiipy_tpu/ops/pallas_stencil.py:make_mega_step_kernel (the
// pl.pallas_call at :1521).  Its stages, their twelve launches, the filter
// and the bound are in mega_stages.cuh, which K7 (stream_steps.cu) shares.

#include "mega_stages.cuh"

namespace {

template <typename T>
int launch(void* const* in, void* const* geo, void* const* filt, const void* rows,
           const void* counts, int R, int ncols, void* const* starred, void* const* out,
           void* const* scratch, int L, int H, int W, const double* consts, int coriolis,
           int q_limiter, cudaStream_t stream) {
  if (gcm::bad_shape(L, H, W) || gcm::bad_filter(R, ncols)) return (int)cudaErrorInvalidValue;
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, rows, counts, R, ncols, scratch, L, H, W,
                                           consts, coriolis, q_limiter, stream);
  return gcm::whole_step(s, in, starred, out);
}

}  // namespace

// One Matsuno step.  in: p,u,v,t,q.  geo: dx_j, dx_h, lat, heightmap, sig,
// sigt, sigb, dsig, dy, ptop.  filt: CS (W,ncols), CwSw (ncols,W), mcc
// (H,ncols), all double, and keep (H).  rows, counts: int32 (R,) listed
// filter rows.  starred, out: p,u,v,t,q of the predictor and of the step.
// scratch: X (2L,H,W), pg_phiv, sd, phi, rho (L,H,W), and A (R,ncols) in
// double.  consts: dt, 1/dt,
// kappa, Rd, Cp, G, 1/P0, 2*omega.  Returns 0 or the first CUDA error.
extern "C" int gcm_mega_step(int is_double, void* const* in, void* const* geo,
                             void* const* filt, const void* rows, const void* counts, int R,
                             int ncols, void* const* starred, void* const* out,
                             void* const* scratch, int L, int H, int W, const double* consts,
                             int coriolis, int q_limiter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(in, geo, filt, rows, counts, R, ncols, starred, out, scratch, L, H,
                              W, consts, coriolis, q_limiter, s)
             : launch<float>(in, geo, filt, rows, counts, R, ncols, starred, out, scratch, L, H,
                             W, consts, coriolis, q_limiter, s);
}
