// The polar filter's FFT stage (fft_filter.cuh) as a standalone op behind
// one C entry point: one filter round on stacked fields, in place
// (gcmiipy_tpu_torch/ops/fft_filter.py: fft_filter is the wrapper,
// fft_filter_ref the plain version).  K5, K6 and K7 run the same kernel as
// their filter stage; the TPU code it replaces, its design and its bound
// are in fft_filter.cuh.

#include "fft_filter.cuh"

// One filter round on X (P,H,W), in place.  mask: (H, W/2+1) double, the
// correction mask m - 1; twiddle: (W, 2) double; lats: int32 (R) listed
// latitudes; plan: the nstages radices of W.  *launches: set to the
// kernel launches made (0 or 1).  Returns 0 or the CUDA error.
extern "C" int gcm_fft_filter(int is_double, void* X, int P, int H, int W, const void* mask,
                              const void* twiddle, const void* lats, int R, const int* plan,
                              int nstages, int* launches, void* stream) {
  const gcm::FftFilter f = gcm::make_fft(mask, twiddle, lats, R, P, H, W, plan, nstages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  return is_double ? gcm::fft_filter(static_cast<double*>(X), f, s, launches)
                   : gcm::fft_filter(static_cast<float*>(X), f, s, launches);
}
