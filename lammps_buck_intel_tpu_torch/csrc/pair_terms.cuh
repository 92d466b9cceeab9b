// The per-pair physics of the port's pair kernels (csrc/cellpair.cu, the
// cell-slot engine, and csrc/nlist.cu, the neighbor-list engine), one copy
// for both: the device form of models/pair/styles.py pair_terms.
//
//   buck: F = A exp(-r/rho) / rho - 6 C / r^7, E = A exp(-r/rho) - C / r^6
//   - offset, strict cut test rsq < cut_ljsq;
//   lj/charmm (VDW = kVdwCharmm): forcelj = lj1 r^-12 - lj2 r^-6, philj =
//   lj3 r^-12 - lj4 r^-6, and for rsq > inner_sq the energy switch F =
//   forcelj switch1 + philj switch2, E = philj switch1 (zero at the cutoff);
//   lj/cut (VDW = kVdwLj): F = lj1 r^-12 - lj2 r^-6, E = lj3 r^-12 - lj4
//   r^-6 - offset;
//   DISP_LONG (styles.py :361-380 of the JAX package): lj/long (VDW =
//   kVdwLj) or buck/long (VDW = kVdwBuck), the undamped repulsion rep_f,
//   rep_e (lj1 r^-12, lj3 r^-12; or A exp(-r/rho) / rho r, A exp(-r/rho))
//   beside the r^-6 term damped by the Ewald split, grij2 = g6^2 rsq, a2 =
//   1 / grij2, x2 = a2 exp(-grij2) c6 (lj4 or C), F = rep_f - g6^8 x2 rsq
//   (((6 a2 + 6) a2 + 3) a2 + 1), E = rep_e - g6^6 x2 ((a2 + 1) a2 + 0.5),
//   no offset; the accurate expf, because g6^2 rsq reaches ~14 at the
//   cutoff of the hexane deck.  With COUL == kCoulLong both terms of one
//   pair are formed in one evaluation (buck/long: three exponentials);
//   coul/long (COUL == kCoulLong): grij = g_ewald r, expm2 = exp(-grij^2),
//   erfc by the Abramowitz & Stegun 5-term polynomial with the JAX
//   constants (not erfcf), prefactor = qqrd2e qi qj / r, F = prefactor
//   (erfc + 2/sqrt(pi) grij expm2), E = prefactor erfc, strict cut test
//   rsq < cut_coulsq;
//   coul/cut (COUL == kCoulCut, styles.py :402-404 of the JAX package):
//   F = E = qqrd2e qi qj / r f_coul, strict cut test rsq < cut_coulsq, no
//   erfc and no k-space;
//   special bonds (SPECIAL): the LJ term scaled by f_lj where it is
//   evaluated (skipped when f_lj is 0: a 1-2 pair's LJ term is ~5e5
//   kcal/mol and must not be formed and cancelled in f32); under
//   DISP_LONG corrected additively on the undamped term, because k-space
//   holds every pair: lj t = r^-6 (1 - f_lj), F += t (lj2 - r^-6 lj1), E
//   += t (lj4 - r^-6 lj3); buck (f_lj - 1) times the undamped Buckingham
//   term, F += (f_lj - 1) (rep_f - r^-6 buck2), E += (f_lj - 1) (rep_e - C
//   r^-6); the coul/long term kept as prefactor (erfc +
//   ... - (1 - f_coul)), the coul/cut term scaled by f_coul.
// The coefficient row cf is one (T, T, 8) entry of styles.py COEF_NAMES:
//   buck     [buck1, buck2, a, c, rhoinv, cut_ljsq, offset, cut_coulsq]
//   lj       [lj1, lj2, lj3, lj4, 0, cut_ljsq, offset, cut_coulsq]
//   ljcharmm [lj1, lj2, lj3, lj4, 0, cut_ljsq, 0, cut_coulsq].
// The order of operations is that of the plain torch version.

#pragma once

#include <cuda_runtime.h>

namespace pairterms {

constexpr int kNcoef = 8;  // COEF_NAMES column layout of styles.py
// The COUL template mode of the pair kernels (styles.py PairConfig.coul)
constexpr int kCoulNone = 0, kCoulLong = 1, kCoulCut = 2;
// The VDW template mode (styles.py VDW_MODE)
constexpr int kVdwBuck = 0, kVdwCharmm = 1, kVdwLj = 2;

// The dispersion splitting constants of DISP_LONG: g6^2, g6^6, g6^8.
template <typename T>
struct DispConst {
  T g2, g6, g8;
};
// Abramowitz & Stegun 7.1.26 (styles.py EWALD_F, EWALD_P, ERFC_A)
constexpr double kEwaldF = 1.12837917;
constexpr double kEwaldP = 0.3275911;
constexpr double kA1 = 0.254829592, kA2 = -0.284496736, kA3 = 1.421413741,
                 kA4 = -1.453152027, kA5 = 1.061405429;

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// dx^2 + dy^2 + dz^2 with every product and sum rounded on its own, as
// the plain torch version rounds it: the _rn intrinsics are never
// contracted into an FMA, so a pair within an ulp of a strict cutoff falls
// on the same side of it in the kernel and in the plain version (coul/cut
// steps by qqrd2e qi qj / rc^2 there).
__device__ __forceinline__ float dist_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
__device__ __forceinline__ double dist_sq(double dx, double dy, double dz) {
  return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                   __dmul_rn(dz, dz));
}

// rsq clamped from below as the plain version clamps it
template <typename T>
__device__ __forceinline__ T clamp_rsq(T rsq) {
  return rsq > T(1e-12) ? rsq : T(1e-12);
}

// The strict cut tests of a (clamped) rsq against the row's cutoffs.
template <typename T, int COUL>
__device__ __forceinline__ bool cut_tests(T rsq, const T* cf, bool& in_lj,
                                          bool& in_coul) {
  in_lj = rsq < cf[5];
  in_coul = COUL != kCoulNone && rsq < cf[7];
  return in_lj || in_coul;
}

// fpair / rsq of a pair inside range (so that F_i += it * (x_i - x_j)),
// with its energies when EV.  qqi = qqrd2e * q_i; qj points at q_j and is
// read only inside the Coulomb cutoff; dc is read only under DISP_LONG.
template <typename T, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG = false>
__device__ __forceinline__ T pair_force(T rsq, bool in_lj, bool in_coul,
                                        const T* cf, T qqi, const T* qj,
                                        T f_lj, T f_coul, T g_ewald,
                                        T inner_sq, T denom_lj,
                                        DispConst<T> dc, T& evdwl,
                                        T& ecoul) {
  static_assert(!DISP_LONG || VDW == kVdwLj || VDW == kVdwBuck,
                "lj/long and buck/long only");
  const T r2inv = T(1) / rsq;
  const T r = dev_sqrt(rsq);
  T fpair = 0;
  evdwl = 0;
  ecoul = 0;
  if (in_lj && (!SPECIAL || DISP_LONG || f_lj != T(0))) {
    const T r6inv = r2inv * r2inv * r2inv;
    if (DISP_LONG) {
      T rep_f, rep_e;
      if (VDW == kVdwBuck) {
        const T rexp = dev_exp(-r * cf[4]);
        rep_f = r * rexp * cf[0];
        rep_e = cf[2] * rexp;
      } else {
        rep_f = r6inv * r6inv * cf[0];
        rep_e = r6inv * r6inv * cf[2];
      }
      const T grij2 = dc.g2 * rsq;
      const T a2 = T(1) / (grij2 > T(1e-30) ? grij2 : T(1e-30));
      const T x2 = a2 * dev_exp(-grij2) * cf[3];
      fpair = rep_f - dc.g8 * x2 * rsq *
                          (((T(6) * a2 + T(6)) * a2 + T(3)) * a2 + T(1));
      if (EV) evdwl = rep_e - dc.g6 * x2 * ((a2 + T(1)) * a2 + T(0.5));
      if (SPECIAL) {
        if (VDW == kVdwBuck) {
          const T tadd = f_lj - T(1);
          fpair += tadd * (rep_f - r6inv * cf[1]);
          if (EV) evdwl += tadd * (rep_e - cf[3] * r6inv);
        } else {
          const T tl = r6inv * (T(1) - f_lj);
          fpair += tl * (cf[1] - r6inv * cf[0]);
          if (EV) evdwl += tl * (cf[3] - r6inv * cf[2]);
        }
      }
    } else if (VDW == kVdwBuck) {
      const T rexp = dev_exp(-r * cf[4]);
      fpair = r * rexp * cf[0] - r6inv * cf[1];  // buck1, buck2; rhoinv
      if (EV) evdwl = cf[2] * rexp - cf[3] * r6inv - cf[6];
    } else if (VDW == kVdwLj) {
      fpair = r6inv * r6inv * cf[0] - r6inv * cf[1];
      if (EV) evdwl = r6inv * r6inv * cf[2] - cf[3] * r6inv - cf[6];
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
    if (SPECIAL && !DISP_LONG) {
      fpair *= f_lj;
      evdwl *= f_lj;
    }
  }
  if (COUL == kCoulCut && in_coul) {
    T fcoul = qqi * *qj * (r * r2inv);
    if (SPECIAL) fcoul *= f_coul;
    if (EV) ecoul = fcoul;
    fpair += fcoul;
  }
  if (COUL == kCoulLong && in_coul) {
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
