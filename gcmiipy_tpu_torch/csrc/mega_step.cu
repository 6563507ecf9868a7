// K6 of the PyTorch port: one whole Matsuno step of the 'mega4' backend,
// with the polar filter, behind one C entry point
// (gcmiipy_tpu_torch/ops/mega_step.py:mega_step_ref is the plain version).
//
// Replaces gcmiipy_tpu/ops/pallas_stencil.py:make_mega_step_kernel (the
// pl.pallas_call at :1521).  Its stages, their six launches, the filter
// (fft_filter.cuh) and the bound are in mega_stages.cuh, which K5 and K7
// share.

#include "mega_stages.cuh"

namespace {

template <typename T>
int launch(void* const* in, void* const* geo, void* const* filt, const void* lats, int R,
           const int* plan, int nstages, void* const* starred, void* const* out,
           void* const* scratch, int L, int H, int W, const double* consts, int coriolis,
           int q_limiter, int* const* launches, cudaStream_t stream) {
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, lats, R, plan, nstages, scratch, L, H, W,
                                           consts, coriolis, q_limiter, launches, stream);
  if (gcm::bad_shape(L, H, W) || gcm::bad_fft(s.f)) return (int)cudaErrorInvalidValue;
  return gcm::whole_step(s, in, starred, out);
}

}  // namespace

// One Matsuno step.  in: p,u,v,t,q.  geo: dx_j, dx_h, lat, heightmap, sig,
// sigt, sigb, dsig, dy, ptop.  filt: the filter's mask (H, W/2+1) and
// twiddles (W, 2), both double, and keep (H).  lats: int32 (R) listed
// latitudes; plan: the nstages radices of W.  starred, out: p,u,v,t,q of
// the predictor and of the step.  scratch: X (2L,H,W), pg_phiv (L,H,W).  consts: dt, 1/dt, kappa, Rd, Cp, G, 1/P0, 2*omega.
// *pgf_launches, *filter_launches, *stencil_launches: set to the launches
// made of the pgf tile, the filter kernel and the rest tile.  Returns 0
// or the first CUDA error.
extern "C" int gcm_mega_step(int is_double, void* const* in, void* const* geo,
                             void* const* filt, const void* lats, int R, const int* plan,
                             int nstages, void* const* starred, void* const* out,
                             void* const* scratch, int L, int H, int W, const double* consts,
                             int coriolis, int q_limiter, int* pgf_launches,
                             int* filter_launches, int* stencil_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const launches[3] = {pgf_launches, filter_launches, stencil_launches};
  return is_double
             ? launch<double>(in, geo, filt, lats, R, plan, nstages, starred, out, scratch, L, H,
                              W, consts, coriolis, q_limiter, launches, s)
             : launch<float>(in, geo, filt, lats, R, plan, nstages, starred, out, scratch, L, H,
                             W, consts, coriolis, q_limiter, launches, s);
}
