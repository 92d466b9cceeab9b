// The per-pair physics of the port's pair kernels (csrc/cellpair.cu, the
// cell-slot engine, and csrc/nlist.cu, the neighbor-list engine), one copy
// for both: the device form of models/pair/styles.py pair_terms.
//
//   buck: F = A exp(-r/rho) / rho - 6 C / r^7, E = A exp(-r/rho) - C / r^6
//   - offset, strict cut test rsq < cut_ljsq;
//   lj/charmm (VDW = 1): forcelj = lj1 r^-12 - lj2 r^-6, philj = lj3 r^-12
//   - lj4 r^-6, and for rsq > inner_sq the energy switch F = forcelj
//   switch1 + philj switch2, E = philj switch1 (zero at the cutoff);
//   coul/long (COUL): grij = g_ewald r, expm2 = exp(-grij^2), erfc by the
//   Abramowitz & Stegun 5-term polynomial with the JAX constants (not
//   erfcf), prefactor = qqrd2e qi qj / r, F = prefactor (erfc + 2/sqrt(pi)
//   grij expm2), E = prefactor erfc, strict cut test rsq < cut_coulsq;
//   special bonds (SPECIAL): the LJ term scaled by f_lj where it is
//   evaluated (skipped when f_lj is 0: a 1-2 pair's LJ term is ~5e5
//   kcal/mol and must not be formed and cancelled in f32), the Coulomb
//   term kept as prefactor (erfc + ... - (1 - f_coul)), because k-space
//   holds every pair.
// The coefficient row cf is one (T, T, 8) entry of styles.py COEF_NAMES:
//   buck     [buck1, buck2, a, c, rhoinv, cut_ljsq, offset, cut_coulsq]
//   ljcharmm [lj1, lj2, lj3, lj4, 0, cut_ljsq, 0, cut_coulsq].
// The order of operations is that of the plain torch version.

#pragma once

#include <cuda_runtime.h>

namespace pairterms {

constexpr int kNcoef = 8;  // COEF_NAMES column layout of styles.py
// Abramowitz & Stegun 7.1.26 (styles.py EWALD_F, EWALD_P, ERFC_A)
constexpr double kEwaldF = 1.12837917;
constexpr double kEwaldP = 0.3275911;
constexpr double kA1 = 0.254829592, kA2 = -0.284496736, kA3 = 1.421413741,
                 kA4 = -1.453152027, kA5 = 1.061405429;

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// rsq clamped from below as the plain version clamps it
template <typename T>
__device__ __forceinline__ T clamp_rsq(T rsq) {
  return rsq > T(1e-12) ? rsq : T(1e-12);
}

// The strict cut tests of a (clamped) rsq against the row's cutoffs.
template <typename T, bool COUL>
__device__ __forceinline__ bool cut_tests(T rsq, const T* cf, bool& in_lj,
                                          bool& in_coul) {
  in_lj = rsq < cf[5];
  in_coul = COUL && rsq < cf[7];
  return in_lj || in_coul;
}

// fpair / rsq of a pair inside range (so that F_i += it * (x_i - x_j)),
// with its energies when EV.  qqi = qqrd2e * q_i; qj points at q_j and is
// read only inside the Coulomb cutoff.
template <typename T, bool EV, bool COUL, int VDW, bool SPECIAL>
__device__ __forceinline__ T pair_force(T rsq, bool in_lj, bool in_coul,
                                        const T* cf, T qqi, const T* qj,
                                        T f_lj, T f_coul, T g_ewald,
                                        T inner_sq, T denom_lj, T& evdwl,
                                        T& ecoul) {
  const T r2inv = T(1) / rsq;
  const T r = dev_sqrt(rsq);
  T fpair = 0;
  evdwl = 0;
  ecoul = 0;
  if (in_lj && (!SPECIAL || f_lj != T(0))) {
    const T r6inv = r2inv * r2inv * r2inv;
    if (VDW == 0) {
      const T rexp = dev_exp(-r * cf[4]);
      fpair = r * rexp * cf[0] - r6inv * cf[1];  // buck1, buck2; rhoinv
      if (EV) evdwl = cf[2] * rexp - cf[3] * r6inv - cf[6];
    } else {
      const T forcelj = r6inv * r6inv * cf[0] - r6inv * cf[1];
      const T philj = r6inv * r6inv * cf[2] - cf[3] * r6inv;
      fpair = forcelj;
      evdwl = philj;
      if (rsq > inner_sq) {
        const T tt = cf[5] - rsq;
        const T switch1 =
            tt * tt * (cf[5] + T(2) * rsq - T(3) * inner_sq) / denom_lj;
        const T switch2 = T(12) * rsq * tt * (rsq - inner_sq) / denom_lj;
        fpair = forcelj * switch1 + philj * switch2;
        evdwl = philj * switch1;
      }
    }
    if (SPECIAL) {
      fpair *= f_lj;
      evdwl *= f_lj;
    }
  }
  if (COUL && in_coul) {
    const T prefactor = qqi * *qj * (r * r2inv);
    const T grij = g_ewald * r;
    const T expm2 = dev_exp(-grij * grij);
    const T t = T(1) / (T(1) + static_cast<T>(kEwaldP) * grij);
    const T erfc =
        t * (T(kA1) + t * (T(kA2) + t * (T(kA3) + t * (T(kA4) +
             t * T(kA5))))) * expm2;
    T fcoul = prefactor * (erfc + static_cast<T>(kEwaldF) * grij * expm2);
    if (EV) ecoul = prefactor * erfc;
    if (SPECIAL) {
      const T adjust = (T(1) - f_coul) * prefactor;
      fcoul -= adjust;
      ecoul -= adjust;
    }
    fpair += fcoul;
  }
  return fpair * r2inv;
}

}  // namespace pairterms
