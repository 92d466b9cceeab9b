// Neighbor lists in atom order (sm_90a): the binned list build
// (nlist_bin, nlist_sort, nlist_build) and the pair pass over the list
// (nlist_pair), for the variable-cell NPT engine.
//
// Replaces: lammps_buck_intel_tpu/neighbor/neighbor_list.py build_cell
//   (:210) with _special_codes (:171), and models/pair/driver.py
//   compute_pair (:78) with styles.py pair_terms (:300), which XLA lowered
//   for the TPU as (tile, 27 * cap) candidate gathers with a top_k prune and
//   (N, K) gather + row-sum passes.
//
// Build.  The box is read from the card: geo = (lo[3], L[3]) in flt, so a
// box that changes every step never comes to the host.
//   nlist_bin    one thread per atom: s = (x - lo) / L folded into [0, 1)
//                (s - floor(s)), cell c = clip(int(s * nc), 0, nc - 1) per
//                axis, rank = atomicAdd(count[c], 1), cells[c][rank] = atom;
//                rank >= cap raises the overflow flag (the atom is dropped,
//                never silently: the flag is read at thermo and at the end
//                of a run and raises).
//   nlist_sort   one thread per cell puts its atoms in ascending id order
//                (insertion sort of at most cap entries), so the cells hold
//                what the JAX package's stable argsort gives them and the
//                list is the same from run to run, whatever order the
//                atomics landed in.
//   nlist_build  one thread per atom scans the 27 cells around its own (>= 3
//                cells per axis, so no cell twice) in the JAX package's
//                stencil order and keeps every j != i with rsq <= cutsq,
//                the difference minimum-imaged as d - rint(d / L) L (the
//                JAX package's core/box.py minimum_image).  The list is
//                K-major, idx[k][N] and sb[k][N], so neighbouring threads
//                write neighbouring words; columns past the count hold the
//                sentinel N and code 0; nnei[i] is the full count and
//                nnei > K raises the overflow flag.  The special code of a
//                kept pair is the sum of the codes of i's partner entries
//                (special_idx / special_code, (N, S) in atom order) equal to
//                j, as _special_codes sums them.
// The JAX package keeps the K NEAREST candidates (top_k on rsq); this
// build keeps them in scan order.  Without overflow both keep every
// candidate inside cutsq, so the set is the same and only the order of
// the columns differs; with overflow both raise.
//
// Pair pass.  nlist_pair: one thread per atom i over its min(nnei, K)
// columns (K-major, so the index loads coalesce), each pair visited from
// both sides (a full list) and no atomics: F_i += fs (x_i - x_j) with the
// difference minimum-imaged as d - rint(d * (1/L)) L under the CURRENT box
// (the JAX package's minimum_image_planes), the physics of pair_terms.cuh
// shared with csrc/cellpair.cu, the special factors special_lj[sb],
// special_coul[sb].  The 6-virial sum fs d_a d_b is always reduced (the
// barostat reads it every step); EV adds evdwl and ecoul.  Per block a
// fixed shuffle tree writes partial[block][8] = (evdwl, ecoul, vxx, vyy,
// vzz, vxy, vxz, vyz); the caller sums the partials and halves them (each
// pair counted twice).
//
// What bounds it on the H100.  The build: distance tests, 27 cells of
// ~cap/2 atoms per atom (~700 at the rhodo density), each a gathered
// position (L1/L2 resident) and ~10 operations.  The pair pass: per pair
// one gathered position, type and charge and the pair physics (~55
// operations inside the cutoff); ~110 list entries per atom of which
// ~40% lie inside the 10 A cutoff, so both bytes (the index and code
// planes, 5 bytes an entry) and operations count.
//
// Precision: the build in flt; the pair pass templated on (flt, acc) =
// (float, float), (float, double), (double, double).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 128;
using pairterms::kNcoef;

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }
__device__ __forceinline__ float dev_rint(float v) { return rintf(v); }
__device__ __forceinline__ double dev_rint(double v) { return rint(v); }

struct CellGeom {
  int ncx, ncy, ncz, cap;
};

// cell coordinate of position p on an axis of nc cells
template <typename T>
__device__ __forceinline__ int cell_of(T p, T lo, T L, int nc) {
  T s = (p - lo) / L;
  s = s - dev_floor(s);  // fold into [0, 1)
  int c = static_cast<int>(s * static_cast<T>(nc));
  return c < 0 ? 0 : (c > nc - 1 ? nc - 1 : c);
}

template <typename T>
__global__ void nlist_bin_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ z,
                                 const T* __restrict__ geo, int n,
                                 CellGeom g, int* __restrict__ count,
                                 int* __restrict__ cells,
                                 int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cx = cell_of(x[i], geo[0], geo[3], g.ncx);
  const int cy = cell_of(y[i], geo[1], geo[4], g.ncy);
  const int cz = cell_of(z[i], geo[2], geo[5], g.ncz);
  const int c = (cx * g.ncy + cy) * g.ncz + cz;
  const int rank = atomicAdd(count + c, 1);
  if (rank < g.cap)
    cells[c * g.cap + rank] = i;
  else
    *overflow = 1;
}

__global__ void nlist_sort_kernel(const int* __restrict__ count,
                                  int* __restrict__ cells, int ncell,
                                  int cap) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int m = count[c] < cap ? count[c] : cap;
  int* row = cells + c * cap;
  for (int a = 1; a < m; ++a) {
    const int v = row[a];
    int b = a - 1;
    while (b >= 0 && row[b] > v) {
      row[b + 1] = row[b];
      --b;
    }
    row[b + 1] = v;
  }
}

template <typename T>
__global__ void nlist_build_kernel(const T* __restrict__ x,
                                   const T* __restrict__ y,
                                   const T* __restrict__ z,
                                   const T* __restrict__ geo, int n,
                                   CellGeom g, const int* __restrict__ count,
                                   const int* __restrict__ cells, T cutsq,
                                   int kmax, const int* __restrict__ sp_idx,
                                   const int* __restrict__ sp_code, int nsp,
                                   int* __restrict__ idx,
                                   signed char* __restrict__ sb,
                                   int* __restrict__ nnei,
                                   int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi = x[i], yi = y[i], zi = z[i];
  const T Lx = geo[3], Ly = geo[4], Lz = geo[5];
  const int cx = cell_of(xi, geo[0], Lx, g.ncx);
  const int cy = cell_of(yi, geo[1], Ly, g.ncy);
  const int cz = cell_of(zi, geo[2], Lz, g.ncz);
  int k = 0;
  for (int ox = -1; ox <= 1; ++ox) {
    const int tx = (cx + ox + g.ncx) % g.ncx;
    for (int oy = -1; oy <= 1; ++oy) {
      const int ty = (cy + oy + g.ncy) % g.ncy;
      for (int oz = -1; oz <= 1; ++oz) {
        const int tz = (cz + oz + g.ncz) % g.ncz;
        const int c = (tx * g.ncy + ty) * g.ncz + tz;
        const int m = count[c] < g.cap ? count[c] : g.cap;
        const int* row = cells + c * g.cap;
        for (int a = 0; a < m; ++a) {
          const int j = row[a];
          if (j == i) continue;
          T dx = xi - x[j], dy = yi - y[j], dz = zi - z[j];
          dx = dx - dev_rint(dx / Lx) * Lx;
          dy = dy - dev_rint(dy / Ly) * Ly;
          dz = dz - dev_rint(dz / Lz) * Lz;
          const T rsq = dx * dx + dy * dy + dz * dz;
          if (!(rsq <= cutsq)) continue;
          if (k < kmax) {
            int code = 0;
            for (int s = 0; s < nsp; ++s)
              if (sp_idx[i * nsp + s] == j) code += sp_code[i * nsp + s];
            idx[k * n + i] = j;
            sb[k * n + i] = static_cast<signed char>(code);
          }
          ++k;
        }
      }
    }
  }
  nnei[i] = k;
  if (k > kmax) *overflow = 1;
  for (int c = k; c < kmax; ++c) {
    idx[c * n + i] = n;
    sb[c * n + i] = 0;
  }
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename A, bool EV, bool COUL, int VDW, bool SPECIAL>
__global__ void nlist_pair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const T* __restrict__ boxL,
    const T* __restrict__ coef, int ntypes, int n,
    const int* __restrict__ idx, const signed char* __restrict__ sb,
    const int* __restrict__ nnei, int kmax, T g_ewald, T qqrd2e, T inner_sq,
    T denom_lj, const T* __restrict__ special_fac, A* __restrict__ fx,
    A* __restrict__ fy, A* __restrict__ fz, A* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncoef = ntypes * ntypes * kNcoef;
  T* s_coef = reinterpret_cast<T*>(smem_raw);
  T* s_fac = s_coef + ncoef;  // special_lj[4], special_coul[4]
  for (int k = threadIdx.x; k < ncoef; k += blockDim.x) s_coef[k] = coef[k];
  if (SPECIAL && threadIdx.x < 8) s_fac[threadIdx.x] = special_fac[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  A fxi = 0, fyi = 0, fzi = 0;
  A ev = 0, ec = 0, v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0;
  if (i < n) {
    const T L[3] = {boxL[0], boxL[1], boxL[2]};
    const T Linv[3] = {T(1) / L[0], T(1) / L[1], T(1) / L[2]};
    const T xi = x[i], yi = y[i], zi = z[i];
    const T qqi = COUL ? qqrd2e * q[i] : T(0);
    const T* crow = s_coef + typ[i] * ntypes * kNcoef;
    const int m = nnei[i] < kmax ? nnei[i] : kmax;
    for (int k = 0; k < m; ++k) {
      const int j = idx[k * n + i];
      T dx = xi - x[j], dy = yi - y[j], dz = zi - z[j];
      dx = dx - dev_rint(dx * Linv[0]) * L[0];
      dy = dy - dev_rint(dy * Linv[1]) * L[1];
      dz = dz - dev_rint(dz * Linv[2]) * L[2];
      const T rsq = pairterms::clamp_rsq(dx * dx + dy * dy + dz * dz);
      const T* cf = crow + typ[j] * kNcoef;
      bool in_lj, in_coul;
      if (!pairterms::cut_tests<T, COUL>(rsq, cf, in_lj, in_coul)) continue;
      T f_lj = 1, f_coul = 1;
      if (SPECIAL) {
        const int code = sb[k * n + i];
        f_lj = s_fac[code];
        f_coul = s_fac[4 + code];
      }
      T evdwl, ecoul;
      const T fs = pairterms::pair_force<T, EV, COUL, VDW, SPECIAL>(
          rsq, in_lj, in_coul, cf, qqi, q + j, f_lj, f_coul, g_ewald,
          inner_sq, denom_lj, evdwl, ecoul);
      fxi += static_cast<A>(fs * dx);
      fyi += static_cast<A>(fs * dy);
      fzi += static_cast<A>(fs * dz);
      if (EV) {
        ev += static_cast<A>(evdwl);
        ec += static_cast<A>(ecoul);
      }
      v0 += static_cast<A>(fs * dx * dx);
      v1 += static_cast<A>(fs * dy * dy);
      v2 += static_cast<A>(fs * dz * dz);
      v3 += static_cast<A>(fs * dx * dy);
      v4 += static_cast<A>(fs * dx * dz);
      v5 += static_cast<A>(fs * dy * dz);
    }
    fx[i] = fxi;
    fy[i] = fyi;
    fz[i] = fzi;
  }
  __shared__ A red[kThreads / 32][8];
  A vals[8] = {ev, ec, v0, v1, v2, v3, v4, v5};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const A s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const A s = warp_sum(lane < kThreads / 32 ? red[lane][k] : A(0));
      if (lane == 0) partial[blockIdx.x * 8 + k] = s;
    }
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_build(const void* x, const void* y, const void* z,
                 const void* geo, int n, CellGeom g, void* count, void* cells,
                 double cutsq, int kmax, const void* sp_idx,
                 const void* sp_code, int nsp, void* idx, void* sb,
                 void* nnei, void* overflow, cudaStream_t s) {
  const T* px = static_cast<const T*>(x);
  const T* py = static_cast<const T*>(y);
  const T* pz = static_cast<const T*>(z);
  const T* pg = static_cast<const T*>(geo);
  int* of = static_cast<int*>(overflow);
  nlist_bin_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      px, py, pz, pg, n, g, static_cast<int*>(count),
      static_cast<int*>(cells), of);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncell = g.ncx * g.ncy * g.ncz;
  nlist_sort_kernel<<<blocks_for(ncell), kThreads, 0, s>>>(
      static_cast<const int*>(count), static_cast<int*>(cells), ncell, g.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nlist_build_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      px, py, pz, pg, n, g, static_cast<const int*>(count),
      static_cast<const int*>(cells), static_cast<T>(cutsq), kmax,
      static_cast<const int*>(sp_idx), static_cast<const int*>(sp_code), nsp,
      static_cast<int*>(idx), static_cast<signed char*>(sb),
      static_cast<int*>(nnei), of);
  return static_cast<int>(cudaGetLastError());
}

#define PAIR_PARAMS                                                          \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *boxL, const void *coef, int ntypes, int n, \
      const void *idx, const void *sb, const void *nnei, int kmax,           \
      double g_ewald, double qqrd2e, double inner_sq, double denom_lj,       \
      const void *special_fac, void *fx, void *fy, void *fz, void *partial,  \
      cudaStream_t s
#define PAIR_ARGS                                                          \
  x, y, z, q, typ, boxL, coef, ntypes, n, idx, sb, nnei, kmax, g_ewald,    \
      qqrd2e, inner_sq, denom_lj, special_fac, fx, fy, fz, partial, s

template <typename T, typename A, bool EV, bool COUL, int VDW, bool SPECIAL>
int launch_pair(PAIR_PARAMS) {
  const size_t smem = sizeof(T) * (ntypes * ntypes * kNcoef + 8);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  nlist_pair_kernel<T, A, EV, COUL, VDW, SPECIAL>
      <<<blocks_for(n), kThreads, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(z), static_cast<const T*>(q),
          static_cast<const int*>(typ), static_cast<const T*>(boxL),
          static_cast<const T*>(coef), ntypes, n,
          static_cast<const int*>(idx),
          static_cast<const signed char*>(sb),
          static_cast<const int*>(nnei), kmax, static_cast<T>(g_ewald),
          static_cast<T>(qqrd2e), static_cast<T>(inner_sq),
          static_cast<T>(denom_lj), static_cast<const T*>(special_fac),
          static_cast<A*>(fx), static_cast<A*>(fy), static_cast<A*>(fz),
          static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, bool EV>
int pair_variant(int coul, int vdw, int special, PAIR_PARAMS) {
  // lj/charmm exists only with coul/long (styles.py check_ported)
  if (vdw != 0 && !coul) return static_cast<int>(cudaErrorInvalidValue);
  switch ((vdw ? 4 : 0) + (special ? 2 : 0) + (coul ? 1 : 0)) {
    case 0: return launch_pair<T, A, EV, false, 0, false>(PAIR_ARGS);
    case 1: return launch_pair<T, A, EV, true, 0, false>(PAIR_ARGS);
    case 2: return launch_pair<T, A, EV, false, 0, true>(PAIR_ARGS);
    case 3: return launch_pair<T, A, EV, true, 0, true>(PAIR_ARGS);
    case 5: return launch_pair<T, A, EV, true, 1, false>(PAIR_ARGS);
    default: return launch_pair<T, A, EV, true, 1, true>(PAIR_ARGS);
  }
}

template <typename T, typename A>
int pair_dispatch(int ev, int coul, int vdw, int special, PAIR_PARAMS) {
  return ev ? pair_variant<T, A, true>(coul, vdw, special, PAIR_ARGS)
            : pair_variant<T, A, false>(coul, vdw, special, PAIR_ARGS);
}

}  // namespace

// Rows of the pair pass's partials (one per block of atoms).
extern "C" int nlist_partial_rows(int n) { return blocks_for(n); }

// dbl: 0 float, 1 double positions and geo (lo[3], L[3]).  count (ncell)
// int32 must be zeroed by the caller; cells (ncell * cap) int32; idx (kmax,
// n) int32 and sb (kmax, n) int8, K-major; nnei (n) int32; overflow an
// int32 flag the build sets to 1 (never clears).  sp_idx / sp_code: (n,
// nsp) int32 partner table, or null with nsp = 0.
extern "C" int nlist_build(int dbl, const void* x, const void* y,
                           const void* z, const void* geo, int n, int ncx,
                           int ncy, int ncz, int cap, void* count,
                           void* cells, double cutsq, int kmax,
                           const void* sp_idx, const void* sp_code, int nsp,
                           void* idx, void* sb, void* nnei, void* overflow,
                           void* stream) {
  if (n <= 0 || kmax <= 0 || cap <= 0 || ncx < 3 || ncy < 3 || ncz < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const CellGeom g{ncx, ncy, ncz, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_build<double>(x, y, z, geo, n, g, count, cells, cutsq,
                                    kmax, sp_idx, sp_code, nsp, idx, sb,
                                    nnei, overflow, s)
             : launch_build<float>(x, y, z, geo, n, g, count, cells, cutsq,
                                   kmax, sp_idx, sp_code, nsp, idx, sb, nnei,
                                   overflow, s);
}

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double).
// fx/fy/fz acc (n); partial[nlist_partial_rows(n)][8] acc, always written.
// coul / vdw / special select the variant as in csrc/cellpair.cu; with
// coul == 0 q may be null; special_fac = special_lj[4], special_coul[4].
extern "C" int nlist_pair(int prec, int ev, int coul, int vdw, int special,
                          const void* x, const void* y, const void* z,
                          const void* q, const void* typ, const void* boxL,
                          const void* coef, int ntypes, int n,
                          const void* idx, const void* sb, const void* nnei,
                          int kmax, double g_ewald, double qqrd2e,
                          double inner_sq, double denom_lj,
                          const void* special_fac, void* fx, void* fy,
                          void* fz, void* partial, void* stream) {
  if (n <= 0 || kmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case 0:
      return pair_dispatch<float, float>(ev, coul, vdw, special, PAIR_ARGS);
    case 1:
      return pair_dispatch<float, double>(ev, coul, vdw, special, PAIR_ARGS);
    case 2:
      return pair_dispatch<double, double>(ev, coul, vdw, special, PAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
