// Bonded forces of a molecular deck over the slot planes (sm_90a): harmonic
// bonds and harmonic / CHARMM angles with Urey-Bradley (bonded_bond_angle),
// CHARMM dihedrals with baked 1-4 pair terms (dihedral_charmm), harmonic
// impropers (improper_harmonic), and the per-atom energy and virial of all
// four (bonded_peratom).
//
// Replaces: lammps_buck_intel_tpu/models/bonded/harmonic.py compute_bonded
//   (:116; bonds :154-184, angles :186-229, Urey-Bradley :231-264),
//   lammps_buck_intel_tpu/models/bonded/charmm.py dihedral_charmm_forces
//   (:114, energy :54) and improper_harmonic_forces (:185, energy :85);
//   bonded_peratom (K18b) <- harmonic.py compute_bonded_peratom (:294).
//
// Design.  One thread per term.  The term tables hold ATOM indices
// ([type, atoms...] rows, int32); a thread finds its atoms' slots through
// the slot-of-atom map `inv` (rebuilt after each rebin; null = identity),
// reads their positions from the slot planes, takes the minimum image of
// each difference per axis as d - rint(d * (1/L)) * L (half to even, the
// JAX package's jnp.round) and adds its forces to the acc-typed force
// planes with atomicAdd: two to four atoms per term, many terms per atom.
// Energies and the 6-virial are reduced per block in a fixed shuffle tree
// into partial[block][NV]; the caller sums the partials in a second,
// deterministic pass.  With f32 force planes the atomics' order of arrival
// decides the last bit of a force; with f64 planes the sums agree with the
// plain version to rounding.
//
// The JAX package gets the dihedral and improper forces from jax.grad of
// the energy in the three bond vectors b1 = x1 - x2, b2 = x3 - x2,
// b3 = x4 - x3.  Here the gradient is written out.  With n1 = b1 x b2,
// n2 = b2 x b3, C = n1.n2 and S = |b2| (b1.n2), the angle is LAMMPS'
// (dihedral_charmm.cpp, improper_harmonic.cpp: normals -n1 and n2, a trans
// chain at 180 degrees), phi = atan2(-S, -C); the JAX package's atan2(S, C)
// is that plus 180 degrees (models/bonded/charmm.py).  Either way
//   dphi/db1 = |b2| n1 / |n1|^2,   dphi/db3 = |b2| n2 / |n2|^2,
//   dphi/db2 = -[(b1.b2) dphi/db1 + (b2.b3) dphi/db3] / |b2|^2
// (the last from phi's invariance under rotation and under scaling of b2).
// The torsion energy K [1 + cos(n phi) cos(d)] has dE/dphi = -K n sin(n phi)
// cos(d), with cos(n phi), sin(n phi) by the complex power of the
// normalised (-C, -S); the improper's chi = |atan2(-S, -C)| has
// dchi/db = -sign(S) dphi/db, zero at a planar improper (S = 0, the kink of
// |phi|).  The JAX package's chi = arccos(cos phi clipped to +-(1 - 1e-7))
// gives no force within ~4.5e-4 rad of planar; here the force follows the
// energy there too, unless the improper type's clip (the third column of
// its coefficients, which the mapped JAX coefficients set) asks for the
// JAX package's chi and clip.
// Forces map as f1 = -g1, f2 = g1 + g2, f3 = g3 - g2, f4 = -g3,
// and the virial is -sum_k b_k (x) g_k.
//
// Per atom (K18b, bonded_peratom).  One thread per term of any kind
// (bonds, then angles, dihedrals, impropers), in atom order.  Each
// computes its term's energy and 6-virial with the arithmetic of K14a-c
// and atomicAdds the 1/m shares into eatom and vatom (the ev_tally
// equal-division convention): a bond's two atoms, an angle's three (its
// Urey-Bradley term on the outer two), a dihedral's or improper's four.
// A dihedral's 1-4 pair term goes in halves to its atoms 1 and 4 of e14
// and v14 (the pair channel).  The virials: a bond's fbond d (x) d, an
// angle's d1 (x) f1 + d2 (x) f3, a dihedral's or improper's -sum_k b_k (x)
// g_k with g the gradient of the torsion (or improper) energy alone, the
// 1-4 term's fpair r14 (x) r14.  The atomics (f64 on sm_90 in a double
// acc) make the sums depend on the order of arrival in the last bits.
//
// What bounds it on the H100.  Bytes, and only a few megabytes of them
// (indices, two to four gathered positions and as many force
// read-modify-writes per term), so each kernel's bound is microseconds and
// launch latency decides what a step pays.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double).  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_rint(float v) { return rintf(v); }
__device__ __forceinline__ double dev_rint(double v) { return rint(v); }
__device__ __forceinline__ float dev_acos(float v) { return acosf(v); }
__device__ __forceinline__ double dev_acos(double v) { return acos(v); }
__device__ __forceinline__ float dev_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double dev_atan2(double y, double x) {
  return atan2(y, x);
}

template <typename T>
struct Vec {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ T dot(const Vec<T>& a, const Vec<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ Vec<T> cross(const Vec<T>& a, const Vec<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ Vec<T> axpby(T a, const Vec<T>& u, T b,
                                        const Vec<T>& v) {
  return {a * u.x + b * v.x, a * u.y + b * v.y, a * u.z + b * v.z};
}

// Positions, the slot map and the box of one launch.
template <typename T>
struct Frame {
  const T* x;
  const T* y;
  const T* z;
  const int* inv;  // slot of atom, or null when the planes are in atom order
  T L[3], Linv[3];
  const T* dev;  // box lengths on the card (variable-cell path), or null

  // take the box from the card where it lives there; the reciprocal is
  // then taken in T, as the plain version takes it
  __device__ __forceinline__ void resolve() {
    if (!dev) return;
    for (int a = 0; a < 3; ++a) {
      L[a] = dev[a];
      Linv[a] = T(1) / dev[a];
    }
  }

  __device__ __forceinline__ int slot(int atom) const {
    return inv ? inv[atom] : atom;
  }
  // minimum image of (position of slot a) - (position of slot b)
  __device__ __forceinline__ Vec<T> diff(int a, int b) const {
    Vec<T> d = {x[a] - x[b], y[a] - y[b], z[a] - z[b]};
    d.x -= dev_rint(d.x * Linv[0]) * L[0];
    d.y -= dev_rint(d.y * Linv[1]) * L[1];
    d.z -= dev_rint(d.z * Linv[2]) * L[2];
    return d;
  }
};

template <typename T, typename A>
struct Forces {
  A* fx;
  A* fy;
  A* fz;
  __device__ __forceinline__ void add(int s, const Vec<T>& f) const {
    atomicAdd(fx + s, static_cast<A>(f.x));
    atomicAdd(fy + s, static_cast<A>(f.y));
    atomicAdd(fz + s, static_cast<A>(f.z));
  }
};

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// partial[blockIdx.x][0..NV) = sum over the block's threads of vals.
template <typename A, int NV>
__device__ void block_reduce(const A (&vals)[NV], A* __restrict__ partial) {
  __shared__ A red[kThreads / 32][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const A s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const A s = warp_sum(lane < kThreads / 32 ? red[lane][k] : A(0));
      if (lane == 0) partial[blockIdx.x * NV + k] = s;
    }
  }
}

// vals[o..o+6) += w * (a (x) b) in the order xx, yy, zz, xy, xz, yz
template <typename T, typename A>
__device__ __forceinline__ void tally(A* v, T w, const Vec<T>& a,
                                      const Vec<T>& b) {
  v[0] += static_cast<A>(w * a.x * b.x);
  v[1] += static_cast<A>(w * a.y * b.y);
  v[2] += static_cast<A>(w * a.z * b.z);
  v[3] += static_cast<A>(w * a.x * b.y);
  v[4] += static_cast<A>(w * a.x * b.z);
  v[5] += static_cast<A>(w * a.y * b.z);
}

// ---- K14a: bonds (threads [0, nb)) and angles (threads [nb, nb + na)) ----
// bcoef: (Tb, 2) [K, r0]; acoef: (Ta, 4) [K, theta0 (rad), K_ub, r_ub].
// partial columns: ebond, eangle (Urey-Bradley included), virial[6].
template <typename T, typename A, bool EV>
__global__ void bond_angle_kernel(Frame<T> fr, const int* __restrict__ bonds,
                                  int nb, const T* __restrict__ bcoef,
                                  const int* __restrict__ angles, int na,
                                  const T* __restrict__ acoef,
                                  Forces<T, A> out, A* __restrict__ partial) {
  fr.resolve();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (t < nb) {
    const int bt = bonds[3 * t];
    const int i = fr.slot(bonds[3 * t + 1]), j = fr.slot(bonds[3 * t + 2]);
    const T K = bcoef[2 * bt], r0 = bcoef[2 * bt + 1];
    const Vec<T> d = fr.diff(i, j);
    const T r = dev_sqrt(dot(d, d));
    const T dr = r - r0;
    const T rk = K * dr;
    const T fbond = r > T(0) ? T(-2) * rk / r : T(0);
    const Vec<T> f = {fbond * d.x, fbond * d.y, fbond * d.z};
    out.add(i, f);
    out.add(j, {-f.x, -f.y, -f.z});
    if (EV) {
      vals[0] = static_cast<A>(rk * dr);
      tally(vals + 2, fbond, d, d);
    }
  } else if (t < nb + na) {
    const int a = t - nb;
    const int at = angles[4 * a];
    const int i = fr.slot(angles[4 * a + 1]), j = fr.slot(angles[4 * a + 2]),
              k = fr.slot(angles[4 * a + 3]);
    const T K = acoef[4 * at], th0 = acoef[4 * at + 1];
    const T kub = acoef[4 * at + 2], rub = acoef[4 * at + 3];
    const Vec<T> d1 = fr.diff(i, j), d2 = fr.diff(k, j);
    const T r1sq = dot(d1, d1), r2sq = dot(d2, d2);
    const T r1 = dev_sqrt(r1sq), r2 = dev_sqrt(r2sq);
    T c = dot(d1, d2) / (r1 * r2);
    c = c > T(1) ? T(1) : (c < T(-1) ? T(-1) : c);
    T ssq = T(1) - c * c;
    ssq = ssq > T(1e-8) ? ssq : T(1e-8);
    const T s = dev_sqrt(ssq);
    const T dtheta = dev_acos(c) - th0;
    const T tk = K * dtheta;
    const T aa = T(-2) * tk / s;
    const T a11 = aa * c / r1sq, a12 = -aa / (r1 * r2), a22 = aa * c / r2sq;
    Vec<T> f1 = axpby(a11, d1, a12, d2);
    Vec<T> f3 = axpby(a22, d2, a12, d1);
    out.add(j, {-(f1.x + f3.x), -(f1.y + f3.y), -(f1.z + f3.z)});
    if (EV) {
      vals[1] = static_cast<A>(tk * dtheta);
      tally(vals + 2, T(1), d1, f1);
      tally(vals + 2, T(1), d2, f3);
    }
    if (kub != T(0)) {  // Urey-Bradley 1-3 term of angle charmm
      const Vec<T> d = fr.diff(i, k);
      T rsq = dot(d, d);
      rsq = rsq > T(1e-12) ? rsq : T(1e-12);
      const T r = dev_sqrt(rsq);
      const T dr = r - rub;
      const T rk = kub * dr;
      const T fub = T(-2) * rk / r;
      f1 = axpby(T(1), f1, fub, d);
      f3 = axpby(T(1), f3, -fub, d);
      if (EV) {
        vals[1] += static_cast<A>(rk * dr);
        tally(vals + 2, fub, d, d);
      }
    }
    out.add(i, f1);
    out.add(k, f3);
  }
  if (EV) block_reduce<A, 8>(vals, partial);
}

// d phi / d b_k of phi = atan2(|b2| b1.n2, n1.n2), each scaled by `w`.
template <typename T>
__device__ __forceinline__ void phi_gradient(T w, const Vec<T>& b1,
                                             const Vec<T>& b2,
                                             const Vec<T>& b3,
                                             const Vec<T>& n1,
                                             const Vec<T>& n2, T b2sq,
                                             Vec<T>& g1, Vec<T>& g2,
                                             Vec<T>& g3) {
  T n1sq = dot(n1, n1), n2sq = dot(n2, n2);
  n1sq = n1sq > T(1e-30) ? n1sq : T(1e-30);
  n2sq = n2sq > T(1e-30) ? n2sq : T(1e-30);
  const T b2n = dev_sqrt(b2sq);
  const T w1 = w * b2n / n1sq, w3 = w * b2n / n2sq;
  g1 = {w1 * n1.x, w1 * n1.y, w1 * n1.z};
  g3 = {w3 * n2.x, w3 * n2.y, w3 * n2.z};
  g2 = axpby(-dot(b1, b2) / b2sq, g1, -dot(b2, b3) / b2sq, g3);
}

// f1 = -g1, f2 = g1 + g2, f3 = g3 - g2, f4 = -g3; virial -= b_k (x) g_k
template <typename T, typename A, bool EV>
__device__ __forceinline__ void scatter_four(
    const Forces<T, A>& out, int i1, int i2, int i3, int i4,
    const Vec<T>& b1, const Vec<T>& b2, const Vec<T>& b3, const Vec<T>& g1,
    const Vec<T>& g2, const Vec<T>& g3, A* vir) {
  out.add(i1, {-g1.x, -g1.y, -g1.z});
  out.add(i2, {g1.x + g2.x, g1.y + g2.y, g1.z + g2.z});
  out.add(i3, {g3.x - g2.x, g3.y - g2.y, g3.z - g2.z});
  out.add(i4, {-g3.x, -g3.y, -g3.z});
  if (EV) {
    // one rounding to acc per component, as the plain version's sum
    const T xx = -b1.x * g1.x - b2.x * g2.x - b3.x * g3.x;
    const T yy = -b1.y * g1.y - b2.y * g2.y - b3.y * g3.y;
    const T zz = -b1.z * g1.z - b2.z * g2.z - b3.z * g3.z;
    const T xy = -b1.x * g1.y - b2.x * g2.y - b3.x * g3.y;
    const T xz = -b1.x * g1.z - b2.x * g2.z - b3.x * g3.z;
    const T yz = -b1.y * g1.z - b2.y * g2.z - b3.y * g3.z;
    vir[0] = static_cast<A>(xx);
    vir[1] = static_cast<A>(yy);
    vir[2] = static_cast<A>(zz);
    vir[3] = static_cast<A>(xy);
    vir[4] = static_cast<A>(xz);
    vir[5] = static_cast<A>(yz);
  }
}

// An improper's chi - chi0 and w = dE/dphi = 2 K (chi - chi0) sign(sin
// phi), chi = |phi| of LAMMPS' angle phi = atan2(-S, -C); w is 0 at a
// planar improper (S = 0), the kink of |phi|.  With clip > 0, the JAX
// package's chi = arccos(cos phi clipped to +-(1 - clip)) and w = 0 where
// the clip holds.
template <typename T>
__device__ __forceinline__ T improper_dchi(const Vec<T>& b1, const Vec<T>& n1,
                                           const Vec<T>& n2, T b2sq, T K,
                                           T chi0, T clip, T& w) {
  const T sinval = -dev_sqrt(b2sq) * dot(b1, n2);
  const T cosval = -dot(n1, n2);
  bool on = sinval != T(0);
  T chi;
  if (clip > T(0)) {
    T nn = dot(n1, n1) * dot(n2, n2);
    nn = nn > T(1e-20) ? nn : T(1e-20);
    const T craw = cosval / dev_sqrt(nn);
    const T hi = T(1) - clip, lo = clip - T(1);
    on = on && craw > lo && craw < hi;
    chi = dev_acos(craw < lo ? lo : (craw > hi ? hi : craw));
  } else {
    chi = dev_atan2(sinval, cosval);
    chi = chi < T(0) ? -chi : chi;
  }
  const T dchi = chi - chi0;
  w = on ? (sinval > T(0) ? T(2) : T(-2)) * K * dchi : T(0);
  return dchi;
}

// ---- K14b: CHARMM dihedrals with baked 1-4 pair terms ----
// dcoef: (Td, 2) [K, cos(d)]; dmult: (Td,) multiplicity n; d14: (Nd, 3)
// [a12, a6, qq] per dihedral, or null.  partial columns: edihed, e14_lj,
// e14_coul, virial[6].
template <typename T, typename A, bool EV>
__global__ void dihedral_charmm_kernel(Frame<T> fr,
                                       const int* __restrict__ dihedrals,
                                       int nd, const T* __restrict__ dcoef,
                                       const int* __restrict__ dmult,
                                       const T* __restrict__ d14,
                                       Forces<T, A> out,
                                       A* __restrict__ partial) {
  fr.resolve();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (t < nd) {
    const int dt = dihedrals[5 * t];
    const int i1 = fr.slot(dihedrals[5 * t + 1]),
              i2 = fr.slot(dihedrals[5 * t + 2]),
              i3 = fr.slot(dihedrals[5 * t + 3]),
              i4 = fr.slot(dihedrals[5 * t + 4]);
    const T K = dcoef[2 * dt], dcos = dcoef[2 * dt + 1];
    const int mult = dmult[dt];
    const Vec<T> b1 = fr.diff(i1, i2), b2 = fr.diff(i3, i2),
                 b3 = fr.diff(i4, i3);
    const Vec<T> n1 = cross(b1, b2), n2 = cross(b2, b3);
    T b2sq = dot(b2, b2);
    b2sq = b2sq > T(1e-12) ? b2sq : T(1e-12);
    // LAMMPS' angle (a trans chain at 180 degrees): normals -n1 and n2
    const T cosval = -dot(n1, n2);
    const T sinval = -dot(cross(n1, n2), b2) / dev_sqrt(b2sq);
    T nsq = cosval * cosval + sinval * sinval;
    nsq = nsq > T(1e-20) ? nsq : T(1e-20);
    const T norm = dev_sqrt(nsq);
    const T c = cosval / norm, s = sinval / norm;
    // (c + i s)^mult; multiplicity 0 keeps cos = sin = 0, as the JAX loop
    T cn = 1, sn = 0, cos_n = 0, sin_n = 0;
    for (int k = 1; k <= mult; ++k) {
      const T cnew = cn * c - sn * s;
      sn = cn * s + sn * c;
      cn = cnew;
      if (k == mult) {
        cos_n = cn;
        sin_n = sn;
      }
    }
    const T dedphi = -K * static_cast<T>(mult) * sin_n * dcos;
    Vec<T> g1, g2, g3;
    phi_gradient(dedphi, b1, b2, b3, n1, n2, b2sq, g1, g2, g3);
    T e14lj = 0, e14c = 0;
    if (d14 != nullptr) {
      const T a12 = d14[3 * t], a6 = d14[3 * t + 1], qq = d14[3 * t + 2];
      const Vec<T> r14 = {b1.x - b2.x - b3.x, b1.y - b2.y - b3.y,
                          b1.z - b2.z - b3.z};
      T rsq = dot(r14, r14);
      rsq = rsq > T(1e-12) ? rsq : T(1e-12);
      const T r6inv = T(1) / (rsq * rsq * rsq);
      e14lj = r6inv * (a12 * r6inv - a6);
      e14c = qq / dev_sqrt(rsq);
      // dE/dr14 = -fpair r14; r14 = b1 - b2 - b3
      const T fpair =
          (r6inv * (T(12) * a12 * r6inv - T(6) * a6) + e14c) / rsq;
      g1 = axpby(T(1), g1, -fpair, r14);
      g2 = axpby(T(1), g2, fpair, r14);
      g3 = axpby(T(1), g3, fpair, r14);
    }
    scatter_four<T, A, EV>(out, i1, i2, i3, i4, b1, b2, b3, g1, g2, g3,
                           vals + 3);
    if (EV) {
      vals[0] = static_cast<A>(K * (T(1) + cos_n * dcos));
      vals[1] = static_cast<A>(e14lj);
      vals[2] = static_cast<A>(e14c);
    }
  }
  if (EV) block_reduce<A, 9>(vals, partial);
}

// ---- K14c: harmonic impropers ----
// icoef: (Ti, 3) [K, chi0 (rad), clip].  partial columns: eimp,
// virial[6].
template <typename T, typename A, bool EV>
__global__ void improper_harmonic_kernel(Frame<T> fr,
                                         const int* __restrict__ impropers,
                                         int ni, const T* __restrict__ icoef,
                                         Forces<T, A> out,
                                         A* __restrict__ partial) {
  fr.resolve();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[7] = {0, 0, 0, 0, 0, 0, 0};
  if (t < ni) {
    const int it = impropers[5 * t];
    const int i1 = fr.slot(impropers[5 * t + 1]),
              i2 = fr.slot(impropers[5 * t + 2]),
              i3 = fr.slot(impropers[5 * t + 3]),
              i4 = fr.slot(impropers[5 * t + 4]);
    const T K = icoef[3 * it], chi0 = icoef[3 * it + 1],
            clip = icoef[3 * it + 2];
    const Vec<T> b1 = fr.diff(i1, i2), b2 = fr.diff(i3, i2),
                 b3 = fr.diff(i4, i3);
    const Vec<T> n1 = cross(b1, b2), n2 = cross(b2, b3);
    T b2sq = dot(b2, b2);
    b2sq = b2sq > T(1e-12) ? b2sq : T(1e-12);
    T w;
    const T dchi = improper_dchi(b1, n1, n2, b2sq, K, chi0, clip, w);
    Vec<T> g1, g2, g3;
    phi_gradient(w, b1, b2, b3, n1, n2, b2sq, g1, g2, g3);
    scatter_four<T, A, EV>(out, i1, i2, i3, i4, b1, b2, b3, g1, g2, g3,
                           vals + 1);
    if (EV) vals[0] = static_cast<A>(K * dchi * dchi);
  }
  if (EV) block_reduce<A, 7>(vals, partial);
}

// the atomic 1/m shares of one term's energy and virial
template <typename T, typename A>
__device__ __forceinline__ void share(A* __restrict__ ea, A* __restrict__ va,
                                      const int* atoms, int m, T e,
                                      const T (&v)[6]) {
  const A am = static_cast<A>(m);
  const A es = static_cast<A>(e) / am;
  A vs[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) vs[c] = static_cast<A>(v[c]) / am;
  for (int a = 0; a < m; ++a) {
    atomicAdd(ea + atoms[a], es);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      atomicAdd(va + static_cast<size_t>(atoms[a]) * 6 + c, vs[c]);
  }
}

// w a (x) b as a T 6-vector (xx, yy, zz, xy, xz, yz)
template <typename T>
__device__ __forceinline__ void outer6(T w, const Vec<T>& a, const Vec<T>& b,
                                       T (&v)[6]) {
  v[0] = w * a.x * b.x;
  v[1] = w * a.y * b.y;
  v[2] = w * a.z * b.z;
  v[3] = w * a.x * b.y;
  v[4] = w * a.x * b.z;
  v[5] = w * a.y * b.z;
}

// -sum_k b_k (x) g_k, the order of terms of the JAX package's expression
template <typename T>
__device__ __forceinline__ void grad_virial(const Vec<T>& b1,
                                            const Vec<T>& b2,
                                            const Vec<T>& b3,
                                            const Vec<T>& g1,
                                            const Vec<T>& g2,
                                            const Vec<T>& g3, T (&v)[6]) {
  v[0] = -b1.x * g1.x - b2.x * g2.x - b3.x * g3.x;
  v[1] = -b1.y * g1.y - b2.y * g2.y - b3.y * g3.y;
  v[2] = -b1.z * g1.z - b2.z * g2.z - b3.z * g3.z;
  v[3] = -b1.x * g1.y - b2.x * g2.y - b3.x * g3.y;
  v[4] = -b1.x * g1.z - b2.x * g2.z - b3.x * g3.z;
  v[5] = -b1.y * g1.z - b2.y * g2.z - b3.y * g3.z;
}

// ---- K18b: per-atom tallies of all four kinds ----
// threads [0, nb) bonds, then na angles, nd dihedrals, ni impropers (a
// kind left out has count 0).  Coefficient tables as in K14a-c; atoms are
// in atom order (fr.inv null).
template <typename T, typename A>
__global__ void bonded_peratom_kernel(
    Frame<T> fr, const int* __restrict__ bonds, int nb,
    const T* __restrict__ bcoef, const int* __restrict__ angles, int na,
    const T* __restrict__ acoef, const int* __restrict__ dihedrals, int nd,
    const T* __restrict__ dcoef, const int* __restrict__ dmult,
    const T* __restrict__ d14, const int* __restrict__ impropers, int ni,
    const T* __restrict__ icoef, A* __restrict__ eatom,
    A* __restrict__ vatom, A* __restrict__ e14, A* __restrict__ v14) {
  fr.resolve();
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  T v[6];
  if (t < nb) {
    const int bt = bonds[3 * t];
    const int at[2] = {bonds[3 * t + 1], bonds[3 * t + 2]};
    const T K = bcoef[2 * bt], r0 = bcoef[2 * bt + 1];
    const Vec<T> d = fr.diff(at[0], at[1]);
    const T r = dev_sqrt(dot(d, d));
    const T dr = r - r0;
    const T rk = K * dr;
    const T fbond = r > T(0) ? T(-2) * rk / r : T(0);
    outer6(fbond, d, d, v);
    share<T, A>(eatom, vatom, at, 2, rk * dr, v);
    return;
  }
  t -= nb;
  if (t < na) {
    const int ty = angles[4 * t];
    const int at[3] = {angles[4 * t + 1], angles[4 * t + 2],
                       angles[4 * t + 3]};
    const T K = acoef[4 * ty], th0 = acoef[4 * ty + 1];
    const T kub = acoef[4 * ty + 2], rub = acoef[4 * ty + 3];
    const Vec<T> d1 = fr.diff(at[0], at[1]), d2 = fr.diff(at[2], at[1]);
    const T r1sq = dot(d1, d1), r2sq = dot(d2, d2);
    const T r1 = dev_sqrt(r1sq), r2 = dev_sqrt(r2sq);
    T c = dot(d1, d2) / (r1 * r2);
    c = c > T(1) ? T(1) : (c < T(-1) ? T(-1) : c);
    T ssq = T(1) - c * c;
    ssq = ssq > T(1e-8) ? ssq : T(1e-8);
    const T s = dev_sqrt(ssq);
    const T dtheta = dev_acos(c) - th0;
    const T tk = K * dtheta;
    const T aa = T(-2) * tk / s;
    const T a11 = aa * c / r1sq, a12 = -aa / (r1 * r2), a22 = aa * c / r2sq;
    const Vec<T> f1 = axpby(a11, d1, a12, d2);
    const Vec<T> f3 = axpby(a22, d2, a12, d1);
    v[0] = d1.x * f1.x + d2.x * f3.x;
    v[1] = d1.y * f1.y + d2.y * f3.y;
    v[2] = d1.z * f1.z + d2.z * f3.z;
    v[3] = d1.x * f1.y + d2.x * f3.y;
    v[4] = d1.x * f1.z + d2.x * f3.z;
    v[5] = d1.y * f1.z + d2.y * f3.z;
    share<T, A>(eatom, vatom, at, 3, tk * dtheta, v);
    if (kub != T(0)) {  // Urey-Bradley: shared by the outer atoms
      const int outer[2] = {at[0], at[2]};
      const Vec<T> d = fr.diff(at[0], at[2]);
      T rsq = dot(d, d);
      rsq = rsq > T(1e-12) ? rsq : T(1e-12);
      const T r = dev_sqrt(rsq);
      const T dr = r - rub;
      const T rk = kub * dr;
      outer6(T(-2) * rk / r, d, d, v);
      share<T, A>(eatom, vatom, outer, 2, rk * dr, v);
    }
    return;
  }
  t -= na;
  if (t < nd) {
    const int dt = dihedrals[5 * t];
    const int at[4] = {dihedrals[5 * t + 1], dihedrals[5 * t + 2],
                       dihedrals[5 * t + 3], dihedrals[5 * t + 4]};
    const T K = dcoef[2 * dt], dcos = dcoef[2 * dt + 1];
    const int mult = dmult[dt];
    const Vec<T> b1 = fr.diff(at[0], at[1]), b2 = fr.diff(at[2], at[1]),
                 b3 = fr.diff(at[3], at[2]);
    const Vec<T> n1 = cross(b1, b2), n2 = cross(b2, b3);
    T b2sq = dot(b2, b2);
    b2sq = b2sq > T(1e-12) ? b2sq : T(1e-12);
    // LAMMPS' angle (a trans chain at 180 degrees): normals -n1 and n2
    const T cosval = -dot(n1, n2);
    const T sinval = -dot(cross(n1, n2), b2) / dev_sqrt(b2sq);
    T nsq = cosval * cosval + sinval * sinval;
    nsq = nsq > T(1e-20) ? nsq : T(1e-20);
    const T norm = dev_sqrt(nsq);
    const T c = cosval / norm, s = sinval / norm;
    T cn = 1, sn = 0, cos_n = 0, sin_n = 0;
    for (int k = 1; k <= mult; ++k) {
      const T cnew = cn * c - sn * s;
      sn = cn * s + sn * c;
      cn = cnew;
      if (k == mult) {
        cos_n = cn;
        sin_n = sn;
      }
    }
    Vec<T> g1, g2, g3;
    phi_gradient(-K * static_cast<T>(mult) * sin_n * dcos, b1, b2, b3, n1,
                 n2, b2sq, g1, g2, g3);
    grad_virial(b1, b2, b3, g1, g2, g3, v);
    share<T, A>(eatom, vatom, at, 4, K * (T(1) + cos_n * dcos), v);
    if (d14 != nullptr) {
      const T a12 = d14[3 * t], a6 = d14[3 * t + 1], qq = d14[3 * t + 2];
      const Vec<T> r14 = {b1.x - b2.x - b3.x, b1.y - b2.y - b3.y,
                          b1.z - b2.z - b3.z};
      T rsq = dot(r14, r14);
      rsq = rsq > T(1e-12) ? rsq : T(1e-12);
      const T r6inv = T(1) / (rsq * rsq * rsq);
      const T elj = r6inv * (a12 * r6inv - a6);
      const T ec = qq / dev_sqrt(rsq);
      const T fpair =
          (r6inv * (T(12) * a12 * r6inv - T(6) * a6) + ec) / rsq;
      const int ends[2] = {at[0], at[3]};
      outer6(fpair, r14, r14, v);
      share<T, A>(e14, v14, ends, 2, elj + ec, v);
    }
    return;
  }
  t -= nd;
  if (t < ni) {
    const int it = impropers[5 * t];
    const int at[4] = {impropers[5 * t + 1], impropers[5 * t + 2],
                       impropers[5 * t + 3], impropers[5 * t + 4]};
    const T K = icoef[3 * it], chi0 = icoef[3 * it + 1],
            clip = icoef[3 * it + 2];
    const Vec<T> b1 = fr.diff(at[0], at[1]), b2 = fr.diff(at[2], at[1]),
                 b3 = fr.diff(at[3], at[2]);
    const Vec<T> n1 = cross(b1, b2), n2 = cross(b2, b3);
    T b2sq = dot(b2, b2);
    b2sq = b2sq > T(1e-12) ? b2sq : T(1e-12);
    T w;
    const T dchi = improper_dchi(b1, n1, n2, b2sq, K, chi0, clip, w);
    Vec<T> g1, g2, g3;
    phi_gradient(w, b1, b2, b3, n1, n2, b2sq, g1, g2, g3);
    grad_virial(b1, b2, b3, g1, g2, g3, v);
    share<T, A>(eatom, vatom, at, 4, K * dchi * dchi, v);
  }
}

template <typename T>
Frame<T> make_frame(const void* x, const void* y, const void* z,
                    const void* inv, double Lx, double Ly, double Lz,
                    const void* Ldev) {
  Frame<T> fr;
  fr.x = static_cast<const T*>(x);
  fr.y = static_cast<const T*>(y);
  fr.z = static_cast<const T*>(z);
  fr.inv = static_cast<const int*>(inv);
  const double L[3] = {Lx, Ly, Lz};
  for (int a = 0; a < 3; ++a) {
    fr.L[a] = static_cast<T>(L[a]);
    fr.Linv[a] = static_cast<T>(1.0 / L[a]);  // f64 reciprocal, rounded once
  }
  fr.dev = static_cast<const T*>(Ldev);
  return fr;
}

inline int blocks_for(int nterms) { return (nterms + kThreads - 1) / kThreads; }

template <typename T, typename A>
int launch_bond_angle(int ev, const void* x, const void* y, const void* z,
                      const void* inv, const void* bonds, int nb,
                      const void* bcoef, const void* angles, int na,
                      const void* acoef, double Lx, double Ly, double Lz,
                      const void* Ldev, void* fx, void* fy, void* fz,
                      void* partial, cudaStream_t s) {
  const Frame<T> fr = make_frame<T>(x, y, z, inv, Lx, Ly, Lz, Ldev);
  const Forces<T, A> out = {static_cast<A*>(fx), static_cast<A*>(fy),
                            static_cast<A*>(fz)};
  const int blocks = blocks_for(nb + na);
#define BOND_ANGLE_ARGS                                                  \
  fr, static_cast<const int*>(bonds), nb, static_cast<const T*>(bcoef),  \
      static_cast<const int*>(angles), na, static_cast<const T*>(acoef), \
      out, static_cast<A*>(partial)
  if (ev)
    bond_angle_kernel<T, A, true><<<blocks, kThreads, 0, s>>>(BOND_ANGLE_ARGS);
  else
    bond_angle_kernel<T, A, false><<<blocks, kThreads, 0, s>>>(
        BOND_ANGLE_ARGS);
#undef BOND_ANGLE_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_dihedral(int ev, const void* x, const void* y, const void* z,
                    const void* inv, const void* dihedrals, int nd,
                    const void* dcoef, const void* dmult, const void* d14,
                    double Lx, double Ly, double Lz, const void* Ldev,
                    void* fx, void* fy, void* fz, void* partial,
                    cudaStream_t s) {
  const Frame<T> fr = make_frame<T>(x, y, z, inv, Lx, Ly, Lz, Ldev);
  const Forces<T, A> out = {static_cast<A*>(fx), static_cast<A*>(fy),
                            static_cast<A*>(fz)};
  const int blocks = blocks_for(nd);
#define DIHEDRAL_ARGS                                                        \
  fr, static_cast<const int*>(dihedrals), nd, static_cast<const T*>(dcoef), \
      static_cast<const int*>(dmult), static_cast<const T*>(d14), out,      \
      static_cast<A*>(partial)
  if (ev)
    dihedral_charmm_kernel<T, A, true><<<blocks, kThreads, 0, s>>>(
        DIHEDRAL_ARGS);
  else
    dihedral_charmm_kernel<T, A, false><<<blocks, kThreads, 0, s>>>(
        DIHEDRAL_ARGS);
#undef DIHEDRAL_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_improper(int ev, const void* x, const void* y, const void* z,
                    const void* inv, const void* impropers, int ni,
                    const void* icoef, double Lx, double Ly, double Lz,
                    const void* Ldev, void* fx, void* fy, void* fz,
                    void* partial, cudaStream_t s) {
  const Frame<T> fr = make_frame<T>(x, y, z, inv, Lx, Ly, Lz, Ldev);
  const Forces<T, A> out = {static_cast<A*>(fx), static_cast<A*>(fy),
                            static_cast<A*>(fz)};
  const int blocks = blocks_for(ni);
#define IMPROPER_ARGS                                                        \
  fr, static_cast<const int*>(impropers), ni, static_cast<const T*>(icoef), \
      out, static_cast<A*>(partial)
  if (ev)
    improper_harmonic_kernel<T, A, true><<<blocks, kThreads, 0, s>>>(
        IMPROPER_ARGS);
  else
    improper_harmonic_kernel<T, A, false><<<blocks, kThreads, 0, s>>>(
        IMPROPER_ARGS);
#undef IMPROPER_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_peratom(const void* x, const void* y, const void* z,
                   const void* bonds, int nb, const void* bcoef,
                   const void* angles, int na, const void* acoef,
                   const void* dihedrals, int nd, const void* dcoef,
                   const void* dmult, const void* d14, const void* impropers,
                   int ni, const void* icoef, double Lx, double Ly,
                   double Lz, const void* Ldev, void* eatom, void* vatom,
                   void* e14, void* v14, cudaStream_t s) {
  const int total = nb + na + nd + ni;
  if (total <= 0) return 0;
  const Frame<T> fr = make_frame<T>(x, y, z, nullptr, Lx, Ly, Lz, Ldev);
  bonded_peratom_kernel<T, A><<<blocks_for(total), kThreads, 0, s>>>(
      fr, static_cast<const int*>(bonds), nb, static_cast<const T*>(bcoef),
      static_cast<const int*>(angles), na, static_cast<const T*>(acoef),
      static_cast<const int*>(dihedrals), nd, static_cast<const T*>(dcoef),
      static_cast<const int*>(dmult), static_cast<const T*>(d14),
      static_cast<const int*>(impropers), ni, static_cast<const T*>(icoef),
      static_cast<A*>(eatom), static_cast<A*>(vatom), static_cast<A*>(e14),
      static_cast<A*>(v14));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// In all three: prec 0 = (float, float), 1 = (float, double), 2 = (double,
// double); x/y/z are flt slot planes, inv the int32 slot-of-atom map (null:
// the planes are in atom order), Lx/Ly/Lz the host box or, with Ldev not
// null, the 3 flt box lengths read on the card (the variable-cell path),
// fx/fy/fz acc planes that the forces are
// ADDED to.  ev != 0 also writes partial[blocks][NV] (acc), blocks =
// ceil(terms / 128); the term count must be positive.
#define BY_PRECISION(fn, ...)                                   \
  switch (prec) {                                               \
    case 0: return fn<float, float>(__VA_ARGS__);               \
    case 1: return fn<float, double>(__VA_ARGS__);              \
    case 2: return fn<double, double>(__VA_ARGS__);             \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

// NV = 8: ebond, eangle, virial[6].  bonds (nb, 3), angles (na, 4) int32.
extern "C" int bonded_bond_angle(int prec, int ev, const void* x,
                                 const void* y, const void* z,
                                 const void* inv, const void* bonds, int nb,
                                 const void* bcoef, const void* angles,
                                 int na, const void* acoef, double Lx,
                                 double Ly, double Lz, const void* Ldev,
                                 void* fx, void* fy, void* fz, void* partial,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_PRECISION(launch_bond_angle, ev, x, y, z, inv, bonds, nb, bcoef, angles,
               na, acoef, Lx, Ly, Lz, Ldev, fx, fy, fz, partial, s)
}

// NV = 9: edihed, e14_lj, e14_coul, virial[6].  dihedrals (nd, 5) int32.
extern "C" int dihedral_charmm(int prec, int ev, const void* x,
                               const void* y, const void* z, const void* inv,
                               const void* dihedrals, int nd,
                               const void* dcoef, const void* dmult,
                               const void* d14, double Lx, double Ly,
                               double Lz, const void* Ldev, void* fx,
                               void* fy, void* fz, void* partial,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_PRECISION(launch_dihedral, ev, x, y, z, inv, dihedrals, nd, dcoef, dmult,
               d14, Lx, Ly, Lz, Ldev, fx, fy, fz, partial, s)
}

// NV = 7: eimp, virial[6].  impropers (ni, 5) int32.
extern "C" int improper_harmonic(int prec, int ev, const void* x,
                                 const void* y, const void* z,
                                 const void* inv, const void* impropers,
                                 int ni, const void* icoef, double Lx,
                                 double Ly, double Lz, const void* Ldev,
                                 void* fx, void* fy, void* fz, void* partial,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_PRECISION(launch_improper, ev, x, y, z, inv, impropers, ni, icoef, Lx,
               Ly, Lz, Ldev, fx, fy, fz, partial, s)
}

// K18b.  prec as above; x/y/z flt planes in atom order; the four term
// tables with their counts (0 leaves a kind out) and coefficient tables as
// in the three force kernels, d14 (nd, 3) or null; Lx/Ly/Lz and Ldev as
// above.  eatom, e14 (n) and vatom, v14 (n, 6) acc, zeroed by the caller,
// take the atomic shares.
extern "C" int bonded_peratom(int prec, const void* x, const void* y,
                              const void* z, const void* bonds, int nb,
                              const void* bcoef, const void* angles, int na,
                              const void* acoef, const void* dihedrals,
                              int nd, const void* dcoef, const void* dmult,
                              const void* d14, const void* impropers, int ni,
                              const void* icoef, double Lx, double Ly,
                              double Lz, const void* Ldev, void* eatom,
                              void* vatom, void* e14, void* v14,
                              void* stream) {
  if (nb < 0 || na < 0 || nd < 0 || ni < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_PRECISION(launch_peratom, x, y, z, bonds, nb, bcoef, angles, na, acoef,
               dihedrals, nd, dcoef, dmult, d14, impropers, ni, icoef, Lx,
               Ly, Lz, Ldev, eatom, vatom, e14, v14, s)
}
