// K7 of the PyTorch port: k whole Matsuno steps a call on the packed
// ping-pong buffer of the 'stream' backend, each step followed by the
// column-physics epilogue when the physics is on
// (gcmiipy_tpu_torch/ops/stream_steps.py:stream_steps_ref is the plain
// version).
//
// Replaces gcmiipy_tpu/ops/pallas_stream.py:make_stream_kernel (the
// pl.pallas_call at :652) with its physics_epilogue (:314-347).  The TPU
// kernel streams latitude blocks through VMEM with double-buffered copies
// and runs K6's block body on each; a step's blocks need every
// neighbouring row of the step before, which the TPU's one core gets from
// running its grid in order.  Here each step is K6's ten stage
// launches (mega_stages.cuh) and the epilogue's one launch, enqueued on
// the caller's stream from one C call: the stream order is the grid-wide
// barrier between stages and between steps, with no host work between
// them.
//
// S is (2, planes, H, W): planes p, u (L), v (L), t (L), q (L), and with
// the physics the ground temperature as plane 1+4L.  Step s reads buffer
// s%2 and writes buffer (s+1)%2 by pointer arithmetic, so no stencil's
// output aliases its input and nothing is copied; k is even, so the state
// ends in buffer 0.  The predictor's state and the stages' scratch are
// the caller's, allocated once and reused by every step and call.  The
// epilogue reads the ground temperature from the source buffer (the
// dynamics stages do not write that plane) and runs in place on the
// destination, since it is column-local.
//
// Bound: the larger of the buffer's bytes read and written once and k
// times K6's stencil and FFT arithmetic plus the epilogue's; chip_smoke.py
// works both out from its run's tensors and the radix plan.

#include "column_physics.cuh"
#include "mega_stages.cuh"

namespace {

template <typename T>
int launch(T* S, int planes, int k, const T* utc, void* const* geo, void* const* filt,
           const void* lats, int R, const int* plan, int nstages, void* const* scratch, int L,
           int H, int W, const double* consts, int coriolis, int q_limiter, const double* phys,
           const T* lat, const T* lon, int* filter_launches, int* stencil_launches,
           cudaStream_t stream) {
  const int np = 1 + 4 * L;
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, lats, R, plan, nstages, scratch + 5, L, H,
                                           W, consts, coriolis, q_limiter, filter_launches,
                                           stencil_launches, stream);
  if (gcm::bad_shape(L, H, W) || gcm::bad_fft(s.f) || k < 0 || k % 2 ||
      planes != np + (phys ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  gcm::PhysTable table;
  if (phys) {
    const double* src = phys;
    for (int n = 0; n < gcm::kPhysScalars; ++n) table.s[n] = *src++;
    for (int r = 0; r < gcm::kPhysRows; ++r)
      for (int n = 0; n < gcm::kMaxLayers; ++n) table.r[r][n] = *src++;
  }
  const size_t HW = (size_t)H * W, buffer = (size_t)planes * HW;
  const dim3 columns((W + gcm::kBlock - 1) / gcm::kBlock, H);
  for (int step = 0; step < k; ++step) {
    T* src = S + (size_t)(step % 2) * buffer;
    T* dst = S + (size_t)((step + 1) % 2) * buffer;
    void* in[5];
    void* out[5];
    for (int n = 0; n < 5; ++n) {
      const size_t plane = n == 0 ? 0 : (size_t)(1 + (n - 1) * L) * HW;
      in[n] = src + plane;
      out[n] = dst + plane;
    }
    const int err = gcm::whole_step(s, in, scratch, out);
    if (err) return err;
    if (phys) {
      gcm::ColumnArgs<T> a;
      a.p = dst;
      a.u0 = dst + HW;
      a.v0 = dst + (size_t)(1 + L) * HW;
      a.t = dst + (size_t)(1 + 2 * L) * HW;
      a.gt_in = src + (size_t)np * HW;
      a.gt_out = dst + (size_t)np * HW;
      a.lat = lat;
      a.lon = lon;
      a.utc = utc;
      a.step = step;
      a.L = L; a.H = H; a.W = W;
      gcm::column_physics<T><<<columns, gcm::kBlock, 0, stream>>>(a, table);
      GCM_CHECK();
    }
  }
  return 0;
}

}  // namespace

// k whole steps on S (2, planes, H, W), in place.  utc: 0-dim clock at the
// start of the call.  geo, filt, lats, plan, consts: as gcm_mega_step.
// scratch: the predictor's p,u,v,t,q, then X (2L,H,W), pg_phiv, sd, phi,
// rho (L,H,W).  phys: the PhysTable's doubles (column_physics.cuh), or null
// for the dynamics alone; lat (H), lon (W).  *filter_launches,
// *stencil_launches: set to the launches made of the filter kernel and of
// the rest stencil.  Returns 0 or the first CUDA error.
extern "C" int gcm_stream_steps(int is_double, void* S, int planes, int k, const void* utc,
                                void* const* geo, void* const* filt, const void* lats, int R,
                                const int* plan, int nstages, void* const* scratch, int L,
                                int H, int W, const double* consts, int coriolis, int q_limiter,
                                const double* phys, const void* lat, const void* lon,
                                int* filter_launches, int* stencil_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(static_cast<double*>(S), planes, k, static_cast<const double*>(utc),
                          geo, filt, lats, R, plan, nstages, scratch, L, H, W, consts, coriolis,
                          q_limiter, phys, static_cast<const double*>(lat),
                          static_cast<const double*>(lon), filter_launches, stencil_launches,
                          st);
  return launch<float>(static_cast<float*>(S), planes, k, static_cast<const float*>(utc), geo,
                       filt, lats, R, plan, nstages, scratch, L, H, W, consts, coriolis,
                       q_limiter, phys, static_cast<const float*>(lat),
                       static_cast<const float*>(lon), filter_launches, stencil_launches, st);
}
