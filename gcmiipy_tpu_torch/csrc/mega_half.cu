// K5 of the PyTorch port: one half step of the 'mega' backend with the
// polar filter, behind one C entry point
// (gcmiipy_tpu_torch/ops/mega_step.py:mega_half_ref is the plain version).
//
// Replaces gcmiipy_tpu/ops/pallas_stencil.py:make_mega_kernel_padded (the
// pl.pallas_call at :849): pgf_forces, the filter in correction form
// Y = X + ((X@C)(m-1))@Cw + ((X@S)(m-1))@Sw on the stacked [spu_raw; pg_phi],
// half_timestep_rest and the momentum epilogue.  It runs K6's stages of
// one half, three launches (mega_stages.cuh: the pgf tile, the filter and
// the rest tile); the polar wall is the keep of the filter
// constants, inside the kernel (the JAX kernel leaves it to its caller).
//
// The TPU kernel sums every row over all W/2 damped wavenumbers in its DFT
// form; here the round is K6's float64 FFT (fft_filter.cuh) over the
// latitudes with some damping, which computes the same function: a
// wavenumber beyond a row's band has a correction mask of exactly 0.
//
// Bound: bytes, as K6's half (mega_stages.cuh): at 9x512x1024 float32 it
// reads ten fields and writes five; its filter round is the FFT of
// fft_filter.cuh.  chip_smoke.py works the bound out from its run's
// tensors and the radix plan.

#include "mega_stages.cuh"

namespace {

template <typename T>
int launch(void* const* base, void* const* seval, void* const* geo, void* const* filt,
           const void* lats, int R, const int* plan, int nstages, void* const* out,
           void* const* scratch, int L, int H, int W, const double* consts, int coriolis,
           int q_limiter, int* const* launches, cudaStream_t stream) {
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, lats, R, plan, nstages, scratch, L, H, W,
                                           consts, coriolis, q_limiter, launches, stream);
  if (gcm::bad_shape(L, H, W) || gcm::bad_fft(s.f)) return (int)cudaErrorInvalidValue;
  return gcm::half_step(s, base, seval, out);
}

}  // namespace

// One half step.  base, seval: p,u,v,t,q (may be the same table).  geo:
// dx_j, dx_h, lat, heightmap, sig, sigt, sigb, dsig, dy, ptop.  filt: the
// filter's mask (H, W/2+1) and twiddles (W, 2), both double, and keep (H).
// lats: int32 (R) listed latitudes; plan: the nstages radices of W.  out:
// p,u,v,t,q, aliasing no input.  scratch: X (2L,H,W), pg_phiv (L,H,W).  consts: dt, 1/dt, kappa, Rd, Cp, G, 1/P0, 2*omega.
// *pgf_launches, *filter_launches, *stencil_launches: set to the launches
// made of the pgf tile, the filter kernel and the rest tile.  Returns 0
// or the first CUDA error.
extern "C" int gcm_mega_half(int is_double, void* const* base, void* const* seval,
                             void* const* geo, void* const* filt, const void* lats, int R,
                             const int* plan, int nstages, void* const* out,
                             void* const* scratch, int L, int H, int W, const double* consts,
                             int coriolis, int q_limiter, int* pgf_launches,
                             int* filter_launches, int* stencil_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const launches[3] = {pgf_launches, filter_launches, stencil_launches};
  return is_double
             ? launch<double>(base, seval, geo, filt, lats, R, plan, nstages, out, scratch, L, H,
                              W, consts, coriolis, q_limiter, launches, s)
             : launch<float>(base, seval, geo, filt, lats, R, plan, nstages, out, scratch, L, H,
                             W, consts, coriolis, q_limiter, launches, s);
}
