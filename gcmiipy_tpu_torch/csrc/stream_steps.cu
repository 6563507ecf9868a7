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
// running its grid in order.  Here each step is K6's six stage
// launches (mega_stages.cuh) and the epilogue's one launch
// (column_physics.cuh), enqueued on the caller's stream from one C call:
// the stream order is the grid-wide barrier between stages and between
// steps, with no host work between them.  The epilogue also has a C entry
// of its own, gcm_column_physics.
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
           const T* lat, const T* lon, int* const* launches, cudaStream_t stream) {
  const int np = 1 + 4 * L;
  const gcm::Step<T> s = gcm::make_step<T>(geo, filt, lats, R, plan, nstages, scratch + 5, L, H,
                                           W, consts, coriolis, q_limiter, launches, stream);
  int* const physics_launches = launches[3];
  *physics_launches = 0;
  if (gcm::bad_shape(L, H, W) || gcm::bad_fft(s.f) || k < 0 || k % 2 ||
      planes != np + (phys ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  const size_t HW = (size_t)H * W, buffer = (size_t)planes * HW;
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
    int err = gcm::whole_step(s, in, scratch, out);
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
      a.table = phys;
      a.step = step;
      a.L = L; a.H = H; a.W = W;
      err = gcm::launch_column_physics(a, stream, physics_launches);
      if (err) return err;
    }
  }
  return 0;
}

// The epilogue alone on one step's new state, in place on t, u0, v0.
template <typename T>
int physics(void* const* fields, const void* lat, const void* lon, const void* utc,
            const double* table, int L, int H, int W, int* launches, cudaStream_t stream) {
  *launches = 0;
  if (gcm::bad_shape(L, H, W)) return (int)cudaErrorInvalidValue;
  T* const* f = reinterpret_cast<T* const*>(fields);
  gcm::ColumnArgs<T> a;
  a.p = f[0];
  a.u0 = f[1];
  a.v0 = f[2];
  a.t = f[3];
  a.gt_in = f[4];
  a.gt_out = f[5];
  a.lat = static_cast<const T*>(lat);
  a.lon = static_cast<const T*>(lon);
  a.utc = static_cast<const T*>(utc);
  a.table = table;
  a.step = 0;
  a.L = L; a.H = H; a.W = W;
  return gcm::launch_column_physics(a, stream, launches);
}

}  // namespace

// k whole steps on S (2, planes, H, W), in place.  utc: 0-dim clock at the
// start of the call.  geo, filt, lats, plan, consts: as gcm_mega_step.
// scratch: the predictor's p,u,v,t,q, then X (2L,H,W), pg_phiv (L,H,W).
// phys: the physics table (column_physics.cuh, kPhysTableSize doubles in
// device memory), or null for the dynamics alone; lat (H), lon (W).  *pgf_launches, *filter_launches, *stencil_launches,
// *physics_launches: set to the launches made of the pgf tile, the filter
// kernel, the rest tile and the epilogue.  Returns 0 or the first CUDA
// error.
extern "C" int gcm_stream_steps(int is_double, void* S, int planes, int k, const void* utc,
                                void* const* geo, void* const* filt, const void* lats, int R,
                                const int* plan, int nstages, void* const* scratch, int L,
                                int H, int W, const double* consts, int coriolis, int q_limiter,
                                const double* phys, const void* lat, const void* lon,
                                int* pgf_launches, int* filter_launches, int* stencil_launches,
                                int* physics_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* const launches[4] = {pgf_launches, filter_launches, stencil_launches, physics_launches};
  if (is_double)
    return launch<double>(static_cast<double*>(S), planes, k, static_cast<const double*>(utc),
                          geo, filt, lats, R, plan, nstages, scratch, L, H, W, consts, coriolis,
                          q_limiter, phys, static_cast<const double*>(lat),
                          static_cast<const double*>(lon), launches, st);
  return launch<float>(static_cast<float*>(S), planes, k, static_cast<const float*>(utc), geo,
                       filt, lats, R, plan, nstages, scratch, L, H, W, consts, coriolis,
                       q_limiter, phys, static_cast<const float*>(lat),
                       static_cast<const float*>(lon), launches, st);
}

// The column-physics epilogue alone, at step 0 of the clock utc (0-dim).
// fields: p (H,W), u0, v0 (layer 0 of u and v, (H,W)) and t (L,H,W), all
// updated in place but p, then gt_in (H,W) read and gt_out (H,W) written.
// lat (H), lon (W); table: as gcm_stream_steps' phys (not null).
// *launches: set to the launches made.  Returns 0 or the CUDA error.
extern "C" int gcm_column_physics(int is_double, void* const* fields, const void* lat,
                                  const void* lon, const void* utc, const double* table, int L,
                                  int H, int W, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? physics<double>(fields, lat, lon, utc, table, L, H, W, launches, st)
                   : physics<float>(fields, lat, lon, utc, table, L, H, W, launches, st);
}
