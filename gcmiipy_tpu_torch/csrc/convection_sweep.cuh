// One bottom-up sweep of the convective adjustment over a column's L-1
// layer pairs (gcmiipy_tpu_torch/physics/convection.py's pair), shared by
// the adaptive convection's kernel (convection.cu), which sweeps until a
// sweep finds the column stable, and K7's epilogue (column_physics.cuh),
// which runs its fixed number of sweeps.
//
// t(k) is layer k's temperature as a T&, updated in place; m(k) its mass
// p*dsig_k; lr(k) and im(k) log(p_k / p_k+1) and 1 / (m_k + m_k+1).  The
// caller passes 1/G as it rounds it.  Every expression keeps the plain
// version's operand order (the libraries build with -fmad=false).

#pragma once

#include <cuda_runtime.h>

namespace gcm {

// Returns whether any pair of the column was unstable (and so moved).
template <typename T, class Temp, class Mass, class Lr, class Im>
__device__ __forceinline__ bool convection_sweep(int L, T rd, T inv_g, T lapse, Temp&& t,
                                                 Mass&& m, Lr&& lr, Im&& im) {
  bool changed = false;
  T t_dn = t(0);
  T m_dn = m(0);
  for (int k = 0; k + 1 < L; ++k) {
    const T t_up = t(k + 1);
    const T m_up = m(k + 1);
    const T tbar = T(0.5) * (t_dn + t_up);
    const T dz = ((rd * tbar) * inv_g) * lr(k);
    const T D = lapse * dz;
    if (t_up < t_dn - D) {
      const T t_dn_new = ((m_dn * t_dn + m_up * t_up) + m_up * D) * im(k);
      t(k) = t_dn_new;
      t_dn = t_dn_new - D;
      t(k + 1) = t_dn;
      changed = true;
    } else {
      t_dn = t_up;
    }
    m_dn = m_up;
  }
  return changed;
}

}  // namespace gcm
