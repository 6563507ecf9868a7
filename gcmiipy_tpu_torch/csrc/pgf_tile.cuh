// The pgf stages of a half step as one tiled launch: pgf_forces(sp, su,
// st), i.e. X[k] = spu_raw = su * iph(sp), X[L+k] = pgu + phiu and pg_phiv
// = pgv + phiv (gcmiipy_tpu_torch/dynamics/core25d.py: pgf, pgf_forces).
// It is K3 (pgf_rest.cu) and stages 1-2 of K5, K6 and K7
// (mega_stages.cuh), and replaces the column pass and the
// one-thread-per-point stencil that wrote rho and phi, 2L planes, to
// device memory and read them back at three points each.
//
// One block owns an (8 x 32) tile of (j,i) columns.  The pgf stencil reads
// rho, phi and sp at a point and at its i+1 and j+1 neighbours, so the
// block also runs the column recurrence of column i0+32 of each tile row
// and of row j0+8 of each tile column: 9*33-1 columns, one thread each
// (320 threads, 24 of them idle; two columns for some threads, or a 16-row
// tile at float32, measured no faster on the H100).  Every column's (j,i)
// wraps once, when its offsets are formed; the halo rows and columns of a
// grid off the tiles are the wrapped ones the plain version's torch.roll
// reads.
//
// The recurrence (gcm_stencil.cuh's pgf_column, which K1's column pass
// shares) runs once per column, k = 0 .. L-1, and keeps no per-layer array
// in registers or local memory: layer k's rho and stp[k-1] go into layer
// k's planes of rho and phi in shared memory, and the column's base, the
// sum over k of s1[k] - sigt[k]*stp[k] plus heightmap*G, is carried in k
// order (stp[L-1] from layer 0's p^kappa: the periodic kp of the plain
// version).  A second loop over the column's phi plane turns it into the
// geopotential ladder, phi[0] = base, phi[k] = phi[k-1] + stp[k-1].  After
// one barrier the tile's threads compute the stencil layer by layer from
// the planes and from sp, staged once, with su read one layer ahead.  Up
// to kPgfHeld (40) layers both planes are held whole: 2 * 40 * 297
// values of 8 bytes at float64 (190 KB; the tile has 8 rows at both types
// for that).  Above it the deep form (pgf_tile_deep) holds one layer of
// each at a time, in two slots, and forms p^kappa twice: once in a pass
// for the ladder's foot, once as the layer's planes are filled.
//
// Every expression keeps the operand order of the plain version (the
// column's and the stencil's, pgf_column and pgf_terms of gcm_stencil.cuh;
// built with -fmad=false), so
// the launch equals pgf_parts_ref bit for bit wherever the card's pow
// rounds as PyTorch's does.
//
// Bound: bytes.  At 9x512x1024 float32 it reads sp, su, st and the
// geometry and writes the stack and pg_phiv: about 98.6 MB, 0.029 ms at
// 3.35 TB/s.  Beyond that it reads each halo column's sp and st once more
// (the halo is 16% of the tile) and computes its p^kappa once more.
// chip_smoke.py works the bound out from its run's tensors.  On the H100
// the launch is held back by instruction issue, not bytes: p^kappa and
// the IEEE divisions of every point are the CUDA math library's long
// instruction sequences (PERF.md).

#pragma once

#include "gcm_stencil.cuh"
#include "stencil_tile.cuh"

namespace gcm {

// Shared-memory layout of the pgf tile, in elements of T: sp, then the
// geometry's layer rows, then L planes of rho and L planes of phi (the deep
// form: two slots of one rho and one phi plane); a plane holds rows j0 ..
// j0+8 and columns i0 .. i0+32 (the corner is not used).
template <typename T, bool Deep = false>
struct PgfTile {
  static constexpr int TJ = 8, TI = 32;
  static constexpr int kTile = TJ * TI;  // threads 0 .. kTile-1: the tile's columns
  static constexpr int kHalo = TJ + TI;  // threads kTile .. kTile+kHalo-1: the halo's
  static constexpr int kThreads = (kTile + kHalo + 31) / 32 * 32;
  static constexpr int C = TI + 1;
  static constexpr int kPlane = (TJ + 1) * C;
  static constexpr int kHeld = held_layers<T>(kPgfHeld);
  static constexpr int kRows = Deep ? kMaxLayers : kHeld;
  static constexpr int kSigAt = kPlane;  // sig, sigt, dsig (kRows each)
  static constexpr int kRhoAt = kSigAt + 3 * kRows;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 1;  // __launch_bounds__
  static size_t bytes(int L) { return (size_t)(kRhoAt + 2 * (Deep ? 2 : L) * kPlane) * sizeof(T); }
  static_assert((kRhoAt + 2 * (Deep ? 2 : kHeld) * kPlane) * sizeof(T) <= kMaxSharedBytes,
                "pgf tile exceeds a block's shared memory");
};

// The column of the tile or of its halo that thread tid runs: its point
// of the tile, or column i0+32 of row j0+h (h < TJ) or row j0+TJ of
// column i0+h-TJ of the halo, h = tid-kTile; j and i wrap here, once.
// Sets the column's (H,W) offset and its index in a plane; false for a
// thread without a column.
template <class S>
__device__ __forceinline__ bool pgf_tile_column(int tid, int j0, int i0, int H, int W, int& off,
                                                int& at) {
  int r = tid / S::TI, cc = tid % S::TI;
  if (tid >= S::kTile) {
    const int h = tid - S::kTile;
    r = h < S::TJ ? h : S::TJ;
    cc = h < S::TJ ? S::TI : h - S::TJ;
  }
  off = ((j0 + r) % H) * W + (i0 + cc) % W;
  at = r * S::C + cc;
  return tid < S::kTile + S::kHalo;
}

// The tiled pgf launch: grid (ceil(W/32), ceil(H/8)), kThreads threads,
// PgfTile<T>::bytes(L) of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(PgfTile<T>::kThreads, PgfTile<T>::kMinBlocks)
    pgf_tile(const Params<T> a, T* X, T* pg_phiv) {
  using S = PgfTile<T>;
  constexpr int C = S::C, P = S::kPlane;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* const sm = reinterpret_cast<T*>(tile_smem);
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.x;
  const int ti = tid % S::TI, tj = tid / S::TI;
  const int i0 = blockIdx.x * S::TI, j0 = blockIdx.y * S::TJ;
  const int i = i0 + ti, j = j0 + tj;
  const T half = T(0.5);
  T* const sig = sm + S::kSigAt;
  T* const sigt = sig + S::kRows;
  T* const dsig = sigt + S::kRows;
  T* const rho = sm + S::kRhoAt;  // layer k at rho[k * P]
  T* const phi = rho + L * P;

  int off, at;
  const bool has_col = pgf_tile_column<S>(tid, j0, i0, H, W, off, at);
  if (has_col) sm[at] = a.sp[off];
  for (int k = tid; k < L; k += S::kThreads) {
    sig[k] = a.sig[k];
    sigt[k] = a.sigt[k];
    dsig[k] = a.dsig[k];
  }
  __syncthreads();

  // the column recurrence (gcm_stencil.cuh's pgf_column): layer k's rho
  // into rho[k], stp[k-1] into phi[k], then the ladder in place
  if (has_col) {
    T* const rho_c = rho + at;
    T* const phi_c = phi + at;
    pgf_column(a, sig, sigt, dsig, sm[at], (size_t)off,
               [&](int k) -> T& { return rho_c[k * P]; },
               [&](int k) -> T& { return phi_c[k * P]; });
  }
  __syncthreads();  // every column's planes are whole
  if (tid >= S::kTile || i >= W || j >= H) return;

  // the stencil, layer by layer; what does not depend on k first
  const int c0 = tj * C + ti;
  const T* const sps = sm + c0;
  const T rdx_j = T(1) / a.dx_j[j];
  const T rdy = T(1) / a.dy[0];
  const T iph_sp = (sps[0] + sps[1]) * half;
  const size_t jw = (size_t)j * W + i;
  T su_k = a.su[jw];
  for (int k = 0; k < L; ++k) {
    const T su_next = k + 1 < L ? a.su[(k + 1) * HW + jw] : T(0);
    const T* const rk = rho + k * P + c0;
    const T* const pk = phi + k * P + c0;
    T pgu, pgv, phiu, phiv;
    pgf_terms(sig[k], sps[0], sps[1], sps[C], rk[0], rk[1], rk[C], pk[0], pk[1], pk[C], rdx_j,
              rdy, pgu, pgv, phiu, phiv);
    const size_t o = (size_t)k * HW + jw;
    X[o] = su_k * iph_sp;
    X[(size_t)L * HW + o] = pgu + phiu;
    pg_phiv[o] = pgv + phiv;
    su_k = su_next;
  }
}

// The pgf tile's deep form, for more than kPgfHeld layers: the same
// block, grid and columns, with two slots of one rho and one phi plane in
// place of L of each, so that its shared memory does not grow with L.
// Each column first runs pgf_column whole for the ladder's foot phi[0]
// alone, then the layers one at a time (PgfLayer: layer k's rho and
// phi[k], p^kappa formed a second time) into slot k mod 2; after one
// barrier a layer the tile's threads run the stencil of layer k from that
// slot.  The next layer's slot is the one the stencil of layer k-1 read,
// free after that barrier.  The same expressions as the held form, so the
// same bits.
template <typename T>
__global__ void __launch_bounds__(PgfTile<T, true>::kThreads, PgfTile<T, true>::kMinBlocks)
    pgf_tile_deep(const Params<T> a, T* X, T* pg_phiv) {
  using S = PgfTile<T, true>;
  constexpr int C = S::C, P = S::kPlane;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* const sm = reinterpret_cast<T*>(tile_smem);
  const int L = a.L, H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.x;
  const int ti = tid % S::TI, tj = tid / S::TI;
  const int i0 = blockIdx.x * S::TI, j0 = blockIdx.y * S::TJ;
  const int i = i0 + ti, j = j0 + tj;
  const T half = T(0.5);
  T* const sig = sm + S::kSigAt;
  T* const sigt = sig + S::kRows;
  T* const dsig = sigt + S::kRows;
  T* const slots = sm + S::kRhoAt;  // slot s: rho at slots[2*s*P], phi at slots[(2*s+1)*P]

  int off, at;
  const bool has_col = pgf_tile_column<S>(tid, j0, i0, H, W, off, at);
  if (has_col) sm[at] = a.sp[off];
  for (int k = tid; k < L; k += S::kThreads) {
    sig[k] = a.sig[k];
    sigt[k] = a.sigt[k];
    dsig[k] = a.dsig[k];
  }
  __syncthreads();

  // the foot of this thread's column's ladder: pgf_column's phi[0], every
  // other value it forms dropped
  PgfLayer<T> col{};
  if (has_col) {
    T sink;
    pgf_column(a, sig, sigt, dsig, sm[at], (size_t)off, [&](int) -> T& { return sink; },
               [&](int k) -> T& { return k ? sink : col.ph; });
    col.st_k = a.st[off];
  }

  // the stencil's thread: what does not depend on k (a thread off the grid
  // reads row 0 and writes nothing)
  const bool point = tid < S::kTile && i < W && j < H;
  const int c0 = tj * C + ti;
  const T* const sps = sm + c0;
  const T rdx_j = T(1) / a.dx_j[point ? j : 0];
  const T rdy = T(1) / a.dy[0];
  const T iph_sp = (sps[0] + sps[1]) * half;
  const size_t jw = point ? (size_t)j * W + i : 0;
  const T ptop = a.ptop[0];
  T su_k = point ? a.su[jw] : T(0);
  for (int k = 0; k < L; ++k) {
    T* const rho = slots + (k & 1) * 2 * P;
    T* const phi = rho + P;
    if (has_col) col.layer(a, sig, sm[at], ptop, (size_t)off, HW, k, rho[at], phi[at]);
    __syncthreads();  // layer k's planes are whole
    if (!point) continue;
    const T su_next = k + 1 < L ? a.su[(k + 1) * HW + jw] : T(0);
    const T* const rk = rho + c0;
    const T* const pk = phi + c0;
    T pgu, pgv, phiu, phiv;
    pgf_terms(sig[k], sps[0], sps[1], sps[C], rk[0], rk[1], rk[C], pk[0], pk[1], pk[C], rdx_j,
              rdy, pgu, pgv, phiu, phiv);
    const size_t o = (size_t)k * HW + jw;
    X[o] = su_k * iph_sp;
    X[(size_t)L * HW + o] = pgu + phiu;
    pg_phiv[o] = pgv + phiv;
    su_k = su_next;
  }
}

// Launch the tiled pgf stage on the caller's stream, its deep form above
// kPgfHeld layers; returns 0 or the CUDA error of the attribute call or
// the launch.  A launch that was accepted adds one to *launches (when not
// null).  A plane's offsets are 32-bit.
template <typename T>
int launch_pgf_tile(const Params<T>& a, T* X, T* pg_phiv, cudaStream_t stream, int* launches) {
  using S = PgfTile<T>;
  if ((size_t)a.H * a.W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + S::TI - 1) / S::TI, (a.H + S::TJ - 1) / S::TJ);
  if (a.L > S::kHeld)
    return launch_kernel(pgf_tile_deep<T>, grid, S::kThreads, PgfTile<T, true>::bytes(a.L),
                         stream, launches, a, X, pg_phiv);
  return launch_kernel(pgf_tile<T>, grid, S::kThreads, S::bytes(a.L), stream, launches, a, X,
                       pg_phiv);
}

}  // namespace gcm
