// Cell-pair Buckingham or lj/charmm (+ Ewald real-space Coulomb, + special
// bonds) forces over the sorted cell-slot layout (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/models/pair/cellpair.py
//   compute_cell_tiles_newton (:291) with styles.py pair_terms (:300),
//   buck: F = A exp(-r/rho) / rho - 6 C / r^7, E = A exp(-r/rho) - C / r^6
//   - offset, strict cut test rsq < cut_ljsq; coul/long (the COUL
//   variant): grij = g_ewald r, expm2 = exp(-grij^2), erfc by the
//   Abramowitz & Stegun 5-term polynomial with the JAX constants (not
//   erfcf), prefactor = qqrd2e qi qj / r, F = prefactor (erfc + 2/sqrt(pi)
//   grij expm2), E = prefactor erfc, strict cut test rsq < cut_coulsq;
//   lj/charmm (VDW = 1, styles.py :343-360): forcelj = lj1 r^-12 - lj2
//   r^-6, philj = lj3 r^-12 - lj4 r^-6, and for rsq > inner_sq the energy
//   switch F = forcelj switch1 + philj switch2, E = philj switch1, which
//   reaches zero at the cutoff (no offset);
//   special bonds (SPECIAL, cellpair.py :448-461 and styles.py :412-419):
//   a pair whose j atom is a 1-2/1-3/1-4 partner of atom i takes
//   special_lj[code] on its LJ term and keeps prefactor (erfc + ... -
//   (1 - special_coul[code])) of its Coulomb term, because k-space holds
//   every pair.
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
// the caller.  Empty slots (aid >= n) and aid_i == aid_j are skipped.
// Energy and virial per block are reduced in a fixed shuffle tree into
// partial[cell][8] = (evdwl, ecoul, vxx, vyy, vzz, vxy, vxz, vyz) in acc;
// the caller sums the partials over cells in a second, deterministic pass.
// ecoul is a sum of large terms of both signs, so it stays in acc like
// evdwl.  The buck-only variant (COUL = false) compiles to the kernel of
// the buck decks with no Coulomb work; VDW and SPECIAL are template
// constants too, so the buck and coul/long kernels carry none of the
// lj/charmm or special-bond code.
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

using pairterms::kNcoef;
constexpr int kMaxThreads = 1024;

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// VDW: 0 = buck, 1 = lj/charmm.
template <typename T, typename A, bool EV, bool COUL, int VDW, bool SPECIAL>
__global__ void cellpair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const int* __restrict__ aid,
    const T* __restrict__ coef, int ntypes, int n, int ncx, int ncy, int ncz,
    int cap, int reach_z, double Lx, double Ly, double Lz, T g_ewald,
    T qqrd2e, T inner_sq, T denom_lj, const int* __restrict__ special,
    int nspecial, const T* __restrict__ special_fac, A* __restrict__ fx,
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
  int* s_sp = s_typ + cap;  // [nspecial][blockDim]: a thread's partners

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < ncoef; k += blockDim.x) s_coef[k] = coef[k];
  if (SPECIAL && tid < 8) s_fac[tid] = special_fac[tid];

  const int cz = c % ncz;
  const int cy = (c / ncz) % ncy;
  const int cx = c / (ncz * ncy);
  const bool has_i = tid < cap;
  const int si = c * cap + tid;
  int ai = n, ti = 0;
  T xi = 0, yi = 0, zi = 0, qi = 0;
  if (has_i) {
    ai = aid[si];
    ti = typ[si];
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
    }
    __syncthreads();
    if (!active) continue;
    const T* crow = s_coef + ti * ntypes * kNcoef;
    for (int j = 0; j < cap; ++j) {
      const int aj = s_aid[j];
      if (aj >= n || aj == ai) continue;
      const T dx = xi - s_x[j];
      const T dy = yi - s_y[j];
      const T dz = zi - s_z[j];
      const T rsq = pairterms::clamp_rsq(dx * dx + dy * dy + dz * dz);
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
      const T fs = pairterms::pair_force<T, EV, COUL, VDW, SPECIAL>(
          rsq, in_lj, in_coul, cf, qqi, s_q + j, f_lj, f_coul, g_ewald,
          inner_sq, denom_lj, evdwl, ecoul);
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

template <typename T, typename A, bool EV, bool COUL, int VDW, bool SPECIAL>
int launch(const void* x, const void* y, const void* z, const void* q,
           const void* typ, const void* aid, const void* coef, int ntypes,
           int n, int ncx, int ncy, int ncz, int cap, int reach_z, double Lx,
           double Ly, double Lz, double g_ewald, double qqrd2e,
           double inner_sq, double denom_lj, const void* special,
           int nspecial, const void* special_fac, void* fx, void* fy,
           void* fz, void* partial, cudaStream_t stream) {
  const int threads = ((cap + 31) / 32) * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(T) * (ntypes * ntypes * kNcoef + (SPECIAL ? 8 : 0) +
                   (COUL ? 4 : 3) * cap) +
      sizeof(int) * (2 * cap + (SPECIAL ? nspecial * threads : 0));
  auto kernel = cellpair_kernel<T, A, EV, COUL, VDW, SPECIAL>;
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
      static_cast<const T*>(coef), ntypes, n, ncx, ncy, ncz, cap, reach_z, Lx,
      Ly, Lz, static_cast<T>(g_ewald), static_cast<T>(qqrd2e),
      static_cast<T>(inner_sq), static_cast<T>(denom_lj),
      static_cast<const int*>(special), nspecial,
      static_cast<const T*>(special_fac), static_cast<A*>(fx),
      static_cast<A*>(fy), static_cast<A*>(fz), static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

#define CELLPAIR_PARAMS                                                      \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *aid, const void *coef, int ntypes, int n, \
      int ncx, int ncy, int ncz, int cap, int reach_z, double Lx, double Ly, \
      double Lz, double g_ewald, double qqrd2e, double inner_sq,             \
      double denom_lj, const void *special, int nspecial,                    \
      const void *special_fac, void *fx, void *fy, void *fz, void *partial,  \
      cudaStream_t s
#define CELLPAIR_ARGS                                                       \
  x, y, z, q, typ, aid, coef, ntypes, n, ncx, ncy, ncz, cap, reach_z, Lx,  \
      Ly, Lz, g_ewald, qqrd2e, inner_sq, denom_lj, special, nspecial,      \
      special_fac, fx, fy, fz, partial, s

template <typename T, typename A, bool EV>
int dispatch_variant(int coul, int vdw, int has_special, CELLPAIR_PARAMS) {
  // lj/charmm exists only with coul/long (styles.py check_ported)
  if (vdw != 0 && !coul) return static_cast<int>(cudaErrorInvalidValue);
  switch ((vdw ? 4 : 0) + (has_special ? 2 : 0) + (coul ? 1 : 0)) {
    case 0: return launch<T, A, EV, false, 0, false>(CELLPAIR_ARGS);
    case 1: return launch<T, A, EV, true, 0, false>(CELLPAIR_ARGS);
    case 2: return launch<T, A, EV, false, 0, true>(CELLPAIR_ARGS);
    case 3: return launch<T, A, EV, true, 0, true>(CELLPAIR_ARGS);
    case 5: return launch<T, A, EV, true, 1, false>(CELLPAIR_ARGS);
    default: return launch<T, A, EV, true, 1, true>(CELLPAIR_ARGS);
  }
}

template <typename T, typename A>
int dispatch(int ev, int coul, int vdw, int has_special, CELLPAIR_PARAMS) {
  return ev ? dispatch_variant<T, A, true>(coul, vdw, has_special,
                                           CELLPAIR_ARGS)
            : dispatch_variant<T, A, false>(coul, vdw, has_special,
                                            CELLPAIR_ARGS);
}

}  // namespace

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double).
// ev != 0 also writes partial[ncell][8]; fx/fy/fz are acc-typed (ncell*cap).
// coul != 0 adds the Ewald real-space Coulomb term (reads q, g_ewald,
// qqrd2e); with coul == 0 q may be null.  vdw: 0 buck, 1 lj/charmm (reads
// inner_sq, denom_lj; needs coul).  special: null, or the (n * nspecial)
// packed partner table with special_fac = special_lj[4], special_coul[4].
extern "C" int cellpair_forces(int prec, int ev, int coul, int vdw,
                               const void* x, const void* y, const void* z,
                               const void* q, const void* typ,
                               const void* aid, const void* coef, int ntypes,
                               int n, int ncx, int ncy, int ncz, int cap,
                               int reach_z, double Lx, double Ly, double Lz,
                               double g_ewald, double qqrd2e, double inner_sq,
                               double denom_lj, const void* special,
                               int nspecial, const void* special_fac,
                               void* fx, void* fy, void* fz, void* partial,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int has_special = special != nullptr && nspecial > 0;
  switch (prec) {
    case 0:
      return dispatch<float, float>(ev, coul, vdw, has_special,
                                    CELLPAIR_ARGS);
    case 1:
      return dispatch<float, double>(ev, coul, vdw, has_special,
                                     CELLPAIR_ARGS);
    case 2:
      return dispatch<double, double>(ev, coul, vdw, has_special,
                                      CELLPAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
