// The stages of one whole Matsuno step (predictor and corrector) with the
// polar filter, shared by K6 (mega_step.cu, one step a call), K7
// (stream_steps.cu, k steps a call on the packed ping-pong buffer), K5
// (mega_half.cu, one half step a call) and the v2 pair K3/K4 (pgf_rest.cu:
// stages 1-2 and 4-5, the filter outside), so that each stage exists
// once.  gcmiipy_tpu_torch/ops/mega_step.py: mega_step_ref is the plain
// version of one step.
//
// They replace the bodies matsuno_block_body (:1290) and
// matsuno_block_stages (:1009) of gcmiipy_tpu/ops/pallas_stencil.py.  The
// TPU kernel runs both halves on one block of latitude rows held in VMEM
// with an 8-row overlap-recompute halo; at 9x512x1024 one block's fields
// alone are megabytes, far beyond an SM's 227 KB, so that layout does not
// carry over.  A step does:
//
//   per half (base, evaluated):
//   1-2. pgf_tile          the pgf stages (pgf_tile.cuh): one block per
//                          (8 x 32) tile of columns runs the column
//                          recurrence of the tile and its i+1/j+1 halo and
//                          the stencil layer by layer, rho and phi in
//                          shared memory only; pgf_forces, i.e. the stacked
//                          X = [spu_raw; pg_phi] (2L,H,W) and pg_phiv
//     3. fft_filter_pow2   one filter round on X in place (fft_filter.cuh):
//                          one block per (damped latitude, row pair), the
//                          transform in registers and shared memory, at
//                          W = 512, 1024 (the main path), 2048 and 4096;
//        fft_filter_kernel at every other W, one block per (damped
//                          latitude, group of row pairs), ping-pong shared
//                          buffers
//   4-5. tile_stencil      the rest tile (stencil_tile.cuh): one block per
//                          (8 x 32) tile of columns; a prologue runs aflux
//                          on the tile and its i+1/j+1 halo from the
//                          filtered spu (sd of every layer in shared
//                          memory only, p_n written), then the layer loop,
//                          fields staged in shared memory with cp.async:
//                          half_timestep_rest and the momentum epilogue
//                          u = (pu - pgfu dt)/iph(p_n),
//                          v = (pv - pg_phiv dt)/jph(p_n) * keep (the polar
//                          wall, 0 on row H-1)
//
// six launches per step on the caller's stream, no PyTorch op between
// them.  Scratch (X, pg_phiv) lives in device memory and the stream order
// gives the grid-wide dependencies (the corrector's stencils read the
// starred state of neighbour rows) that the TPU got from recomputing
// halos.  Stages 1-2 and 4-5 keep the expressions of K1's device code
// (gcm_stencil.cuh, stencil_tile.cuh), so they round as K1 and the plain
// version do.
//
// The filter is the TPU kernel's banded DFT, Y = X + irfft((m-1) rfft X),
// computed as a float64 FFT (fft_filter.cuh): every sum in double for
// float fields too, the result rounded to T once.  The plain version keeps
// the TPU kernel's banded DFT form (mega_step.banded_filter_ref), so the
// kernel agrees with it to rounding, not bitwise.
//
// Bound: bytes.  At 9x512x1024 float32 a step reads and writes its five
// fields (159 MB with the geometry and the filter's buffers, 0.048 ms at
// 3.35 TB/s); its operations, 1.5 Gop float32 of stencils and 0.72 GFLOP
// double of FFT, take 0.033 ms at the card's peak rates.  chip_smoke.py
// works both out from its run's tensors and the radix plan.

#pragma once

#include "fft_filter.cuh"
#include "gcm_stencil.cuh"
#include "pgf_tile.cuh"
#include "stencil_tile.cuh"

namespace gcm {

template <typename T>
struct Step {
  void* const* geo;
  FftFilter f;
  const T* keep;
  T *X, *pg_phiv;
  int L, H, W;
  const double* consts;
  int coriolis, q_limiter;
  cudaStream_t stream;
  int* pgf_launches;      // host count of the pgf tile's launches
  int* filter_launches;   // host count of the filter kernel's launches
  int* stencil_launches;  // host count of the rest tile's launches
};

// The Params of one half step: base (p,u,v,t,q) advanced with the
// tendencies at seval (sp,su,sv,st,sq), spu the filtered zonal mass flux,
// p_n the new surface pressure.  A pointer that the caller's stages do not
// read may be null.
template <typename T>
Params<T> half_params(void* const* base, void* const* seval, const T* spu, void* const* geo,
                      int L, int H, int W, const double* consts, int coriolis, int q_limiter,
                      T* p_n) {
  void* in[11];
  for (int n = 0; n < 5; ++n) {
    in[n] = base[n];
    in[5 + n] = seval[n];
  }
  in[10] = const_cast<T*>(spu);
  Params<T> a = gcm::make_params<T>(in, geo, L, H, W, consts, coriolis, q_limiter);
  a.p_n = p_n;
  return a;
}

// One half step: base (p,u,v,t,q) advanced with the tendencies at seval;
// writes out = (p_n, u_n, v_n, t_n, q_n).
template <typename T>
int half_step(const Step<T>& s, void* const* base, void* const* seval, void* const* out) {
  T* const* fo = reinterpret_cast<T* const*>(out);
  // spu: the filtered spu, the first L planes of X after stage 3
  const Params<T> a = half_params<T>(base, seval, s.X, s.geo, s.L, s.H, s.W, s.consts,
                                     s.coriolis, s.q_limiter, fo[0]);
  // stages 1-2: pgf_forces(sp, su, st) into X = [spu_raw; pg_phi], pg_phiv
  int err = launch_pgf_tile(a, s.X, s.pg_phiv, s.stream, s.pgf_launches);
  if (err) return err;
  err = fft_filter(s.X, s.f, s.stream, s.filter_launches);
  if (err) return err;
  const T* pgfu = s.X + (size_t)s.L * s.H * s.W;
  // stages 4-5: aflux, half_timestep_rest and the momentum epilogue
  return launch_tile_stencil(a, RestOut<T>{fo[1], fo[2], fo[3], fo[4], pgfu, s.pg_phiv, s.keep},
                             s.stream, s.stencil_launches);
}

// The per-step arguments of half_step from the C entry points' tables.
// filt: the filter's mask (H, W/2+1) and twiddles (W, 2), both double, and
// keep (H).  lats: int32 (R) listed latitudes; plan: nstages radices.
// scratch: X (2L,H,W), pg_phiv (L,H,W).  launches: the host counts of the
// pgf tile's, the filter kernel's and the rest tile's launches, each set
// to 0; each launch adds one to its count.
template <typename T>
Step<T> make_step(void* const* geo, void* const* filt, const void* lats, int R, const int* plan,
                  int nstages, void* const* scratch, int L, int H, int W, const double* consts,
                  int coriolis, int q_limiter, int* const* launches, cudaStream_t stream) {
  Step<T> s;
  s.geo = geo;
  s.f = make_fft(filt[0], filt[1], lats, R, 2 * L, H, W, plan, nstages);
  s.keep = static_cast<const T*>(filt[2]);
  T* const* fs = reinterpret_cast<T* const*>(scratch);
  s.X = fs[0]; s.pg_phiv = fs[1];
  s.L = L; s.H = H; s.W = W;
  s.consts = consts;
  s.coriolis = coriolis; s.q_limiter = q_limiter;
  s.stream = stream;
  s.pgf_launches = launches[0];
  s.filter_launches = launches[1];
  s.stencil_launches = launches[2];
  for (int n = 0; n < 3; ++n) *launches[n] = 0;
  return s;
}

// One whole step: in = (p,u,v,t,q) -> out, the predictor's state in starred.
template <typename T>
int whole_step(const Step<T>& s, void* const* in, void* const* starred, void* const* out) {
  const int err = half_step(s, in, in, starred);  // predictor
  if (err) return err;
  return half_step(s, in, starred, out);          // corrector
}

}  // namespace gcm
