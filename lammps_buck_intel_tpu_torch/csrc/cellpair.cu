// Cell-pair Buckingham, lj/cut, lj/long or lj/charmm (+ Ewald real-space
// or cut Coulomb, + special bonds, + same-molecule exclusion) forces over
// the sorted cell-slot layout (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/models/pair/cellpair.py
//   compute_cell_tiles_newton (:291) with styles.py pair_terms (:300),
//   buck: F = A exp(-r/rho) / rho - 6 C / r^7, E = A exp(-r/rho) - C / r^6
//   - offset, strict cut test rsq < cut_ljsq; coul/long (COUL == kCoulLong
//   variant): grij = g_ewald r, expm2 = exp(-grij^2), erfc by the
//   Abramowitz & Stegun 5-term polynomial with the JAX constants (not
//   erfcf), prefactor = qqrd2e qi qj / r, F = prefactor (erfc + 2/sqrt(pi)
//   grij expm2), E = prefactor erfc, strict cut test rsq < cut_coulsq;
//   coul/cut (COUL == kCoulCut, styles.py :402-404): F = E = qqrd2e qi qj
//   / r, strict cut test rsq < cut_coulsq, no erfc;
//   lj/charmm (VDW = 1, styles.py :343-360): forcelj = lj1 r^-12 - lj2
//   r^-6, philj = lj3 r^-12 - lj4 r^-6, and for rsq > inner_sq the energy
//   switch F = forcelj switch1 + philj switch2, E = philj switch1, which
//   reaches zero at the cutoff (no offset);
//   lj/cut (VDW = kVdwLj): F = lj1 r^-12 - lj2 r^-6, E = lj3 r^-12 - lj4
//   r^-6 - offset; lj/long and buck/long (kVdwLj or kVdwBuck with
//   DISP_LONG, styles.py :361-380; coul none or coul long): the r^-6 term
//   damped by the Ewald split of the dispersion PPPM;
//   same-molecule exclusion (cellpair.py :399-402 and :528
//   slot_mol_gather, the pair semantics of fix rigid/small): with a slot
//   mol plane a pair whose two slots carry one molecule id is skipped;
//   special bonds (SPECIAL, cellpair.py :448-461 and styles.py :412-419):
//   a pair whose j atom is a 1-2/1-3/1-4 partner of atom i takes
//   special_lj[code] on its LJ term and keeps prefactor (erfc + ... -
//   (1 - special_coul[code])) of its coul/long term, because k-space holds
//   every pair, or special_coul[code] of its coul/cut term.
//
// The per-pair expressions live in pair_terms.cuh, shared with the
// neighbor-list kernel (csrc/nlist.cu).
//
// Design.  One thread block per cell, one thread per slot of the cell
// (blockDim = cap rounded up to a warp).  The block walks the FULL
// (3, 3, 2*reach_z+1) stencil of neighbour cells; for each it stages the
// j-cell's x/y/z/aid/typ (and q for COUL) in shared memory with the
// periodic shift added on load (shift = +-L exactly where the stencil
// wraps), then every thread sums the forces of its slot over the staged
// slots.  No Newton: each pair is evaluated from both sides, so forces
// need no atomics and are deterministic; energy and virial are halved by
// the caller.  Empty slots (aid >= n) and aid_i == aid_j are skipped, and
// with a mol plane (one int a slot, staged beside aid; -1 on empty slots)
// every pair of one molecule: a runtime test on a uniform pointer, so the
// exclusion doubles no template variant.
// Energy and virial per block are reduced in a fixed shuffle tree into
// partial[cell][8] = (evdwl, ecoul, vxx, vyy, vzz, vxy, vxz, vyz) in acc;
// the caller sums the partials over cells in a second, deterministic pass.
// ecoul is a sum of large terms of both signs, so it stays in acc like
// evdwl.  The buck-only variant (COUL = kCoulNone) compiles to the kernel
// of the buck decks with no Coulomb work; VDW and SPECIAL are template
// constants too, so the buck and Coulomb kernels carry none of the
// lj/charmm or special-bond code, and coul/cut none of the erfc.
//
// Special bonds.  The JAX package gathers each slot's partner ids per
// rebin and compares them with every candidate's id.  Here the partner
// table stays in atom order (packed idx * 4 + code, S per atom, -1 =
// none): a thread copies the S entries of its own atom into shared memory
// once, and compares them with the j atom's id only for candidates that
// passed a cutoff test.  The LJ term of a special pair is scaled where it
// is evaluated (skipped when the factor is 0), never computed whole and
// subtracted: a 1-2 pair at 1.09 A has an LJ term near 5e5 kcal/mol, and
// an f32 difference of such terms would leave errors of order 1e-2.  The
// match is symmetric (the table lists both directions), as the full
// stencil needs.
//
// What bounds it on the H100.  Candidate pairs, not bytes: at buck_big
// (192k atoms, cut 5.0 + skin 0.3, reach_z 1, cap 192) each atom tests
// 27 * 192 candidates of which ~1/10 fall inside the cutoff; every
// candidate costs a shared load, a distance and a compare, and every pair
// inside the cutoff two exponentials with Coulomb.  The tile staging keeps
// device-memory traffic at one read of each neighbour cell per block.
// Faster forms (Newton with atomic reaction forces, compacted candidate
// lists, cluster-pair layouts) are later work; this kernel is the simple
// correct one.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double).  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

using pairterms::DispConst;
using pairterms::kCoulNone;
using pairterms::kNcoef;
using pairterms::kVdwBuck;
using pairterms::kVdwCharmm;
using pairterms::kVdwLj;
constexpr int kMaxThreads = 1024;

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// COUL: pairterms::kCoulNone / kCoulLong / kCoulCut; VDW: kVdwBuck,
// kVdwCharmm or kVdwLj; DISP_LONG: the damped r^-6 term of lj/long or
// buck/long.
template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG>
__global__ void cellpair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const int* __restrict__ aid,
    const int* __restrict__ mol, const T* __restrict__ coef, int ntypes,
    int n, int ncx, int ncy, int ncz, int cap, int reach_z, double Lx,
    double Ly, double Lz, T g_ewald, T qqrd2e, T inner_sq, T denom_lj,
    DispConst<T> dc, const int* __restrict__ special, int nspecial,
    const T* __restrict__ special_fac, A* __restrict__ fx,
    A* __restrict__ fy, A* __restrict__ fz, A* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncoef = ntypes * ntypes * kNcoef;
  T* s_coef = reinterpret_cast<T*>(smem_raw);
  T* s_fac = s_coef + ncoef;  // special_lj[4], special_coul[4]
  T* s_x = s_fac + (SPECIAL ? 8 : 0);
  T* s_y = s_x + cap;
  T* s_z = s_y + cap;
  T* s_q = s_z + cap;
  int* s_aid = reinterpret_cast<int*>(s_q + (COUL ? cap : 0));
  int* s_typ = s_aid + cap;
  int* s_mol = s_typ + cap;  // [cap] when mol is given
  int* s_sp = s_mol + (mol ? cap : 0);  // [nspecial][blockDim]: partners

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < ncoef; k += blockDim.x) s_coef[k] = coef[k];
  if (SPECIAL && tid < 8) s_fac[tid] = special_fac[tid];

  const int cz = c % ncz;
  const int cy = (c / ncz) % ncy;
  const int cx = c / (ncz * ncy);
  const bool has_i = tid < cap;
  const int si = c * cap + tid;
  int ai = n, ti = 0, mi = -1;
  T xi = 0, yi = 0, zi = 0, qi = 0;
  if (has_i) {
    ai = aid[si];
    ti = typ[si];
    if (mol) mi = mol[si];
    xi = x[si];
    yi = y[si];
    zi = z[si];
    if (COUL) qi = q[si];
  }
  const bool active = has_i && ai < n;
  if (SPECIAL) {
    for (int k = 0; k < nspecial; ++k)
      s_sp[k * blockDim.x + tid] = active ? special[ai * nspecial + k] : -1;
  }
  // qqrd2e * qi once per slot: the plain version's (qqrd2e * qi) * qj
  const T qqi = qqrd2e * qi;
  A fxi = 0, fyi = 0, fzi = 0;
  A ev = 0, ec = 0, v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0;

  const int nz = 2 * reach_z + 1;
  const int S = 9 * nz;
  for (int k = 0; k < S; ++k) {
    int tx = cx + k / (3 * nz) - 1;
    int ty = cy + (k / nz) % 3 - 1;
    int tz = cz + k % nz - reach_z;
    const int wx = (tx >= ncx) - (tx < 0);
    const int wy = (ty >= ncy) - (ty < 0);
    const int wz = (tz >= ncz) - (tz < 0);
    tx -= wx * ncx;
    ty -= wy * ncy;
    tz -= wz * ncz;
    // f64 product rounded once to T, as the JAX package's shift table
    const T shx = static_cast<T>(wx * Lx);
    const T shy = static_cast<T>(wy * Ly);
    const T shz = static_cast<T>(wz * Lz);
    const int cj = (tx * ncy + ty) * ncz + tz;
    __syncthreads();  // the previous j tile is consumed
    for (int j = tid; j < cap; j += blockDim.x) {
      const int sj = cj * cap + j;
      s_x[j] = x[sj] + shx;
      s_y[j] = y[sj] + shy;
      s_z[j] = z[sj] + shz;
      if (COUL) s_q[j] = q[sj];
      s_aid[j] = aid[sj];
      s_typ[j] = typ[sj];
      if (mol) s_mol[j] = mol[sj];
    }
    __syncthreads();
    if (!active) continue;
    const T* crow = s_coef + ti * ntypes * kNcoef;
    for (int j = 0; j < cap; ++j) {
      const int aj = s_aid[j];
      if (aj >= n || aj == ai) continue;
      if (mol && s_mol[j] == mi) continue;  // one molecule: excluded
      const T dx = xi - s_x[j];
      const T dy = yi - s_y[j];
      const T dz = zi - s_z[j];
      const T rsq = pairterms::clamp_rsq(pairterms::dist_sq(dx, dy, dz));
      const T* cf = crow + s_typ[j] * kNcoef;
      // strict cut tests (COUL is a template constant)
      bool in_lj, in_coul;
      if (!pairterms::cut_tests<T, COUL>(rsq, cf, in_lj, in_coul)) continue;
      T f_lj = 1, f_coul = 1;
      if (SPECIAL) {
        int code = 0;
        for (int k = 0; k < nspecial; ++k) {
          const int p = s_sp[k * blockDim.x + tid];
          if ((p >> 2) == aj) code = p & 3;  // p = -1 matches no atom
        }
        f_lj = s_fac[code];
        f_coul = s_fac[4 + code];
      }
      T evdwl, ecoul;
      const T fs =
          pairterms::pair_force<T, EV, COUL, VDW, SPECIAL, DISP_LONG>(
              rsq, in_lj, in_coul, cf, qqi, s_q + j, f_lj, f_coul, g_ewald,
              inner_sq, denom_lj, dc, evdwl, ecoul);
      fxi += static_cast<A>(fs * dx);
      fyi += static_cast<A>(fs * dy);
      fzi += static_cast<A>(fs * dz);
      if (EV) {
        ev += static_cast<A>(evdwl);
        ec += static_cast<A>(ecoul);
        v0 += static_cast<A>(fs * dx * dx);
        v1 += static_cast<A>(fs * dy * dy);
        v2 += static_cast<A>(fs * dz * dz);
        v3 += static_cast<A>(fs * dx * dy);
        v4 += static_cast<A>(fs * dx * dz);
        v5 += static_cast<A>(fs * dy * dz);
      }
    }
  }
  if (has_i) {
    fx[si] = fxi;
    fy[si] = fyi;
    fz[si] = fzi;
  }
  if (EV) {
    __shared__ A red[kMaxThreads / 32][8];
    A vals[8] = {ev, ec, v0, v1, v2, v3, v4, v5};
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const A s = warp_sum(vals[k]);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (warp == 0) {
      const int nwarps = blockDim.x >> 5;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const A s = warp_sum(lane < nwarps ? red[lane][k] : A(0));
        if (lane == 0) partial[c * 8 + k] = s;
      }
    }
  }
}

template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG>
int launch(const void* x, const void* y, const void* z, const void* q,
           const void* typ, const void* aid, const void* mol,
           const void* coef, int ntypes, int n, int ncx, int ncy, int ncz,
           int cap, int reach_z, double Lx, double Ly, double Lz,
           double g_ewald, double qqrd2e, double inner_sq, double denom_lj,
           const double* disp, const void* special, int nspecial,
           const void* special_fac, void* fx, void* fy, void* fz,
           void* partial, cudaStream_t stream) {
  const int threads = ((cap + 31) / 32) * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(T) * (ntypes * ntypes * kNcoef + (SPECIAL ? 8 : 0) +
                   (COUL ? 4 : 3) * cap) +
      sizeof(int) * ((mol ? 3 : 2) * cap +
                     (SPECIAL ? nspecial * threads : 0));
  // the host's f64 powers g6^2, g6^6, g6^8 rounded once to T, as the
  // plain version's python floats
  const DispConst<T> dc{static_cast<T>(disp[0]), static_cast<T>(disp[1]),
                        static_cast<T>(disp[2])};
  auto kernel = cellpair_kernel<T, A, EV, COUL, VDW, SPECIAL, DISP_LONG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<ncx * ncy * ncz, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(q),
      static_cast<const int*>(typ), static_cast<const int*>(aid),
      static_cast<const int*>(mol), static_cast<const T*>(coef), ntypes, n,
      ncx, ncy, ncz, cap, reach_z, Lx, Ly, Lz, static_cast<T>(g_ewald),
      static_cast<T>(qqrd2e), static_cast<T>(inner_sq),
      static_cast<T>(denom_lj), dc, static_cast<const int*>(special),
      nspecial,
      static_cast<const T*>(special_fac), static_cast<A*>(fx),
      static_cast<A*>(fy), static_cast<A*>(fz), static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

#define CELLPAIR_PARAMS                                                      \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *aid, const void *mol, const void *coef,   \
      int ntypes, int n, int ncx, int ncy, int ncz, int cap, int reach_z,    \
      double Lx, double Ly, double Lz, double g_ewald, double qqrd2e,        \
      double inner_sq, double denom_lj, const double *disp,                  \
      const void *special, int nspecial, const void *special_fac, void *fx,  \
      void *fy, void *fz, void *partial, cudaStream_t s
#define CELLPAIR_ARGS                                                       \
  x, y, z, q, typ, aid, mol, coef, ntypes, n, ncx, ncy, ncz, cap, reach_z, \
      Lx, Ly, Lz, g_ewald, qqrd2e, inner_sq, denom_lj, disp, special,      \
      nspecial, special_fac, fx, fy, fz, partial, s

template <typename T, typename A, bool EV, int COUL, int VDW, bool DISP_LONG>
int with_special(int has_special, CELLPAIR_PARAMS) {
  return has_special
             ? launch<T, A, EV, COUL, VDW, true, DISP_LONG>(CELLPAIR_ARGS)
             : launch<T, A, EV, COUL, VDW, false, DISP_LONG>(CELLPAIR_ARGS);
}

template <typename T, typename A, bool EV, int COUL>
int dispatch_vdw(int vdw, int disp_long, int has_special, CELLPAIR_PARAMS) {
  if (disp_long) {
    // lj/long and buck/long with coul none or coul long only (see the
    // header): four instantiations, so the build time stays bounded
    if constexpr (COUL == kCoulNone || COUL == pairterms::kCoulLong) {
      if (vdw == kVdwLj)
        return with_special<T, A, EV, COUL, kVdwLj, true>(has_special,
                                                          CELLPAIR_ARGS);
      if (vdw == kVdwBuck)
        return with_special<T, A, EV, COUL, kVdwBuck, true>(has_special,
                                                            CELLPAIR_ARGS);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vdw == kVdwBuck)
    return with_special<T, A, EV, COUL, kVdwBuck, false>(has_special,
                                                         CELLPAIR_ARGS);
  if (vdw == kVdwLj)
    return with_special<T, A, EV, COUL, kVdwLj, false>(has_special,
                                                       CELLPAIR_ARGS);
  // lj/charmm exists only with a Coulomb term (styles.py check_ported)
  if constexpr (COUL == kCoulNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (vdw == kVdwCharmm)
      return with_special<T, A, EV, COUL, kVdwCharmm, false>(has_special,
                                                             CELLPAIR_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename A, bool EV>
int dispatch_variant(int coul, int vdw, int disp_long, int has_special,
                     CELLPAIR_PARAMS) {
  switch (coul) {
    case 0: return dispatch_vdw<T, A, EV, 0>(vdw, disp_long, has_special,
                                             CELLPAIR_ARGS);
    case 1: return dispatch_vdw<T, A, EV, 1>(vdw, disp_long, has_special,
                                             CELLPAIR_ARGS);
    case 2: return dispatch_vdw<T, A, EV, 2>(vdw, disp_long, has_special,
                                             CELLPAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename A>
int dispatch(int ev, int coul, int vdw, int disp_long, int has_special,
             CELLPAIR_PARAMS) {
  return ev ? dispatch_variant<T, A, true>(coul, vdw, disp_long,
                                           has_special, CELLPAIR_ARGS)
            : dispatch_variant<T, A, false>(coul, vdw, disp_long,
                                            has_special, CELLPAIR_ARGS);
}

}  // namespace

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double).
// ev != 0 also writes partial[ncell][8]; fx/fy/fz are acc-typed (ncell*cap).
// coul: 0 none (q may be null), 1 the Ewald real-space Coulomb term (reads
// q, g_ewald, qqrd2e), 2 the cut Coulomb term (reads q, qqrd2e).  vdw: 0
// buck, 1 lj/charmm (reads inner_sq, denom_lj; needs coul), 2 lj/cut; with
// disp_long buck/long or lj/long (coul 0 or 1 only), which read g2_g6_g8:
// the host array (g6^2, g6^6, g6^8) of the splitting parameter g6.  mol: null, or
// the (ncell * cap) int32 slot plane of molecule ids (-1 on empty slots)
// whose same-molecule pairs are skipped.  special: null, or the (n *
// nspecial) packed partner table with special_fac = special_lj[4],
// special_coul[4].
extern "C" int cellpair_forces(int prec, int ev, int coul, int vdw,
                               int disp_long, const void* x, const void* y,
                               const void* z, const void* q, const void* typ,
                               const void* aid, const void* mol,
                               const void* coef, int ntypes, int n, int ncx,
                               int ncy, int ncz, int cap, int reach_z,
                               double Lx, double Ly, double Lz,
                               double g_ewald, double qqrd2e, double inner_sq,
                               double denom_lj, const double* g2_g6_g8,
                               const void* special, int nspecial,
                               const void* special_fac, void* fx, void* fy,
                               void* fz, void* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int has_special = special != nullptr && nspecial > 0;
  const double zero3[3] = {0.0, 0.0, 0.0};
  const double* disp = g2_g6_g8 ? g2_g6_g8 : zero3;
  switch (prec) {
    case 0:
      return dispatch<float, float>(ev, coul, vdw, disp_long, has_special,
                                    CELLPAIR_ARGS);
    case 1:
      return dispatch<float, double>(ev, coul, vdw, disp_long, has_special,
                                     CELLPAIR_ARGS);
    case 2:
      return dispatch<double, double>(ev, coul, vdw, disp_long, has_special,
                                      CELLPAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
