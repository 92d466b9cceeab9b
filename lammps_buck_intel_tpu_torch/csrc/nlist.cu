// Neighbor lists in atom order (sm_90a): the binned list build
// (nlist_bin, nlist_sort, nlist_build), the dense O(N^2) build
// (nlist_dense), the pair pass over the list (nlist_pair) and its
// per-atom variant (nlist_pair_peratom), for the neighbor-list engines (the
// static-box Simulation and the variable-cell NPT engine) and for the
// per-atom computes of every engine.
//
// Replaces: lammps_buck_intel_tpu/neighbor/neighbor_list.py build_cell
//   (:210) and build_dense (:184) with _special_codes (:171), and
//   models/pair/driver.py compute_pair (:78) and compute_pair_peratom
//   (:196) with styles.py pair_terms (:300), which XLA lowered for the TPU as (tile, 27 * cap) candidate
//   gathers or an (N, N) masked distance matrix with a top_k prune, and
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
// Dense build (N <= 512 or fewer than 3 cells on an axis, where the
// 27-cell stencil would visit a cell twice).
//   nlist_dense  one warp per atom i; the CTA stages kDenseTile positions
//                j in shared memory and each warp walks them 32 at a time,
//                lane l testing j = tile + 32 c + l: the minimum image with
//                the box lengths read on the card (d - rint(d / L) L, the
//                division of build_cell), rsq <= cutsq and j != i.  A
//                __ballot_sync of the hits and __popc(mask & lanemask_lt)
//                give each hit its column, so the columns hold the hits in
//                ascending j; columns past K are counted, not written.  The
//                codes, the sentinel fill, nnei and the overflow flag are
//                nlist_build's.  No per-atom array is sized by N, indices
//                stay 32-bit below 2^31 atoms and the (K, N) offsets are
//                64-bit, so a thin slab of 10^5 atoms that takes this path
//                stays correct (at N^2 cost).
// The JAX package keeps the K NEAREST candidates (top_k on rsq); both
// builds keep them in scan order (the dense build: ascending j).  Without overflow both keep every
// candidate inside cutsq, so the set is the same and only the order of
// the columns differs; with overflow both raise.
//
// Pair pass.  nlist_pair: one thread per atom i over its min(nnei, K)
// columns (K-major, so the index loads coalesce), each pair visited from
// both sides (a full list) and no atomics: F_i += fs (x_i - x_j) with the
// difference minimum-imaged as d - rint(d * (1/L)) L under the CURRENT box
// (the JAX package's minimum_image_planes), the physics of pair_terms.cuh
// shared with csrc/cellpair.cu (buck, lj/cut or lj/charmm, with no Coulomb term,
// coul/long or coul/cut: the COUL template mode; buck/long and lj/long,
// the Ewald-split r^-6 term of the dispersion PPPM, with coul none or
// long: the DISP_LONG template flag), the special factors
// special_lj[sb], special_coul[sb].  The 6-virial sum fs d_a d_b is always reduced (the
// barostat reads it every step); EV adds evdwl and ecoul.  Per block a
// fixed shuffle tree writes partial[block][8] = (evdwl, ecoul, vxx, vyy,
// vzz, vxy, vxz, vyz); the caller sums the partials and halves them (each
// pair counted twice).
//
// Per-atom pass (K9d).  nlist_pair_peratom is the same kernel with PERATOM
// set: the thread that owns row i of the full list writes eatom[i] = half
// its row's evdwl + ecoul and vatom[i][6] = half its row's fs d_a d_b, the
// eflag_atom / vflag_atom tallies of pair_buck_intel.cpp:303-322 (each
// atom takes half of every pair it is in).  No forces, no atomics, no
// block partials.  It is instantiated for (float, float) and (double,
// double) only: the per-atom computes run the pair pass in f32, the
// record and the card tests in f64.
//
// What bounds it on the H100.  The build: distance tests, 27 cells of
// ~cap/2 atoms per atom (~700 at the rhodo density), each a gathered
// position (L1/L2 resident) and ~10 operations.  The dense build: N^2
// distance tests from shared memory (three divisions each) and the (K, N)
// list written once.  The pair pass: per pair
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
using pairterms::kCoulNone;
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

constexpr int kDenseWarps = 8;                 // atoms per CTA
constexpr int kDenseTile = kDenseWarps * 32;   // staged positions

template <typename T>
__global__ void nlist_dense_kernel(const T* __restrict__ x,
                                   const T* __restrict__ y,
                                   const T* __restrict__ z,
                                   const T* __restrict__ boxL, int n,
                                   T cutsq, int kmax,
                                   const int* __restrict__ sp_idx,
                                   const int* __restrict__ sp_code, int nsp,
                                   int* __restrict__ idx,
                                   signed char* __restrict__ sb,
                                   int* __restrict__ nnei,
                                   int* __restrict__ overflow) {
  __shared__ T s_x[kDenseTile], s_y[kDenseTile], s_z[kDenseTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kDenseWarps + warp;
  const bool live = i < n;  // a warp past N still helps stage the tiles
  const T Lx = boxL[0], Ly = boxL[1], Lz = boxL[2];
  T xi = 0, yi = 0, zi = 0;
  if (live) {
    xi = x[i];
    yi = y[i];
    zi = z[i];
  }
  const unsigned lt = (1u << lane) - 1u;
  int k = 0;  // hits so far, the same in every lane of the warp
  for (int t0 = 0; t0 < n; t0 += kDenseTile) {
    const int jl = t0 + threadIdx.x;
    if (jl < n) {
      s_x[threadIdx.x] = x[jl];
      s_y[threadIdx.x] = y[jl];
      s_z[threadIdx.x] = z[jl];
    }
    __syncthreads();
    const int m = n - t0 < kDenseTile ? n - t0 : kDenseTile;
    if (live) {
      for (int c = 0; c < m; c += 32) {
        const int a = c + lane;
        const int j = t0 + a;
        bool hit = false;
        if (a < m && j != i) {
          T dx = xi - s_x[a], dy = yi - s_y[a], dz = zi - s_z[a];
          dx = dx - dev_rint(dx / Lx) * Lx;
          dy = dy - dev_rint(dy / Ly) * Ly;
          dz = dz - dev_rint(dz / Lz) * Lz;
          const T rsq = dx * dx + dy * dy + dz * dz;
          hit = rsq <= cutsq;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        const int col = k + __popc(mask & lt);
        if (hit && col < kmax) {
          int code = 0;
          for (int s = 0; s < nsp; ++s)
            if (sp_idx[static_cast<size_t>(i) * nsp + s] == j)
              code += sp_code[static_cast<size_t>(i) * nsp + s];
          idx[static_cast<size_t>(col) * n + i] = j;
          sb[static_cast<size_t>(col) * n + i] = static_cast<signed char>(code);
        }
        k += __popc(mask);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (lane == 0) {
    nnei[i] = k;
    if (k > kmax) *overflow = 1;
  }
  for (int c = k + lane; c < kmax; c += 32) {
    idx[static_cast<size_t>(c) * n + i] = n;
    sb[static_cast<size_t>(c) * n + i] = 0;
  }
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG, bool PERATOM>
__global__ void nlist_pair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const T* __restrict__ boxL,
    const T* __restrict__ coef, int ntypes, int n,
    const int* __restrict__ idx, const signed char* __restrict__ sb,
    const int* __restrict__ nnei, int kmax, T g_ewald, T qqrd2e, T inner_sq,
    T denom_lj, pairterms::DispConst<T> dc,
    const T* __restrict__ special_fac, A* __restrict__ fx,
    A* __restrict__ fy, A* __restrict__ fz, A* __restrict__ partial,
    A* __restrict__ eatom, A* __restrict__ vatom) {
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
      const T fs =
          pairterms::pair_force<T, EV, COUL, VDW, SPECIAL, DISP_LONG>(
              rsq, in_lj, in_coul, cf, qqi, q + j, f_lj, f_coul, g_ewald,
              inner_sq, denom_lj, dc, evdwl, ecoul);
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
    if constexpr (PERATOM) {
      const A half = A(0.5);
      eatom[i] = half * (ev + ec);
      A* vi = vatom + static_cast<size_t>(i) * 6;
      vi[0] = half * v0;
      vi[1] = half * v1;
      vi[2] = half * v2;
      vi[3] = half * v3;
      vi[4] = half * v4;
      vi[5] = half * v5;
    } else {
      fx[i] = fxi;
      fy[i] = fyi;
      fz[i] = fzi;
    }
  }
  if constexpr (PERATOM) return;
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

template <typename T>
int launch_dense(const void* x, const void* y, const void* z,
                 const void* boxL, int n, double cutsq, int kmax,
                 const void* sp_idx, const void* sp_code, int nsp, void* idx,
                 void* sb, void* nnei, void* overflow, cudaStream_t s) {
  const int blocks = (n + kDenseWarps - 1) / kDenseWarps;
  nlist_dense_kernel<T><<<blocks, kDenseTile, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(boxL), n,
      static_cast<T>(cutsq), kmax, static_cast<const int*>(sp_idx),
      static_cast<const int*>(sp_code), nsp, static_cast<int*>(idx),
      static_cast<signed char*>(sb), static_cast<int*>(nnei),
      static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

#define PAIR_PARAMS                                                          \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *boxL, const void *coef, int ntypes, int n, \
      const void *idx, const void *sb, const void *nnei, int kmax,           \
      double g_ewald, double qqrd2e, double inner_sq, double denom_lj,       \
      const double *disp, const void *special_fac, void *fx, void *fy,       \
      void *fz, void *partial, void *eatom, void *vatom, cudaStream_t s
#define PAIR_ARGS                                                          \
  x, y, z, q, typ, boxL, coef, ntypes, n, idx, sb, nnei, kmax, g_ewald,    \
      qqrd2e, inner_sq, denom_lj, disp, special_fac, fx, fy, fz, partial,  \
      eatom, vatom, s

template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG, bool PERATOM>
int launch_pair(PAIR_PARAMS) {
  const size_t smem = sizeof(T) * (ntypes * ntypes * kNcoef + 8);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const pairterms::DispConst<T> dc{static_cast<T>(disp[0]),
                                   static_cast<T>(disp[1]),
                                   static_cast<T>(disp[2])};
  nlist_pair_kernel<T, A, EV, COUL, VDW, SPECIAL, DISP_LONG, PERATOM>
      <<<blocks_for(n), kThreads, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(z), static_cast<const T*>(q),
          static_cast<const int*>(typ), static_cast<const T*>(boxL),
          static_cast<const T*>(coef), ntypes, n,
          static_cast<const int*>(idx),
          static_cast<const signed char*>(sb),
          static_cast<const int*>(nnei), kmax, static_cast<T>(g_ewald),
          static_cast<T>(qqrd2e), static_cast<T>(inner_sq),
          static_cast<T>(denom_lj), dc, static_cast<const T*>(special_fac),
          static_cast<A*>(fx), static_cast<A*>(fy), static_cast<A*>(fz),
          static_cast<A*>(partial), static_cast<A*>(eatom),
          static_cast<A*>(vatom));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, bool EV, bool PA, int COUL, int VDW,
          bool DISP_LONG>
int pair_special(int special, PAIR_PARAMS) {
  return special
             ? launch_pair<T, A, EV, COUL, VDW, true, DISP_LONG, PA>(PAIR_ARGS)
             : launch_pair<T, A, EV, COUL, VDW, false, DISP_LONG, PA>(
                   PAIR_ARGS);
}

template <typename T, typename A, bool EV, bool PA, int COUL>
int pair_vdw(int vdw, int disp_long, int special, PAIR_PARAMS) {
  if (disp_long) {
    // lj/long and buck/long with coul none or coul long only, as in
    // csrc/cellpair.cu: four instantiations
    if constexpr (COUL == kCoulNone || COUL == pairterms::kCoulLong) {
      if (vdw == pairterms::kVdwBuck)
        return pair_special<T, A, EV, PA, COUL, pairterms::kVdwBuck, true>(
            special, PAIR_ARGS);
      if (vdw == pairterms::kVdwLj)
        return pair_special<T, A, EV, PA, COUL, pairterms::kVdwLj, true>(
            special, PAIR_ARGS);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vdw == pairterms::kVdwBuck)
    return pair_special<T, A, EV, PA, COUL, pairterms::kVdwBuck, false>(
        special, PAIR_ARGS);
  if (vdw == pairterms::kVdwLj)
    return pair_special<T, A, EV, PA, COUL, pairterms::kVdwLj, false>(
        special, PAIR_ARGS);
  // lj/charmm exists only with a Coulomb term (styles.py check_ported)
  if constexpr (COUL == kCoulNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (vdw == pairterms::kVdwCharmm)
      return pair_special<T, A, EV, PA, COUL, pairterms::kVdwCharmm, false>(
          special, PAIR_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename A, bool EV, bool PA>
int pair_variant(int coul, int vdw, int disp_long, int special,
                 PAIR_PARAMS) {
  switch (coul) {
    case 0:
      return pair_vdw<T, A, EV, PA, 0>(vdw, disp_long, special, PAIR_ARGS);
    case 1:
      return pair_vdw<T, A, EV, PA, 1>(vdw, disp_long, special, PAIR_ARGS);
    case 2:
      return pair_vdw<T, A, EV, PA, 2>(vdw, disp_long, special, PAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename A>
int pair_dispatch(int ev, int coul, int vdw, int disp_long, int special,
                  PAIR_PARAMS) {
  return ev ? pair_variant<T, A, true, false>(coul, vdw, disp_long, special,
                                              PAIR_ARGS)
            : pair_variant<T, A, false, false>(coul, vdw, disp_long, special,
                                               PAIR_ARGS);
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

// The dense build: dbl and the outputs as in nlist_build; boxL the three
// box lengths in the positions' type, on the card.
extern "C" int nlist_dense(int dbl, const void* x, const void* y,
                           const void* z, const void* boxL, int n,
                           double cutsq, int kmax, const void* sp_idx,
                           const void* sp_code, int nsp, void* idx, void* sb,
                           void* nnei, void* overflow, void* stream) {
  if (n <= 0 || kmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_dense<double>(x, y, z, boxL, n, cutsq, kmax, sp_idx,
                                    sp_code, nsp, idx, sb, nnei, overflow, s)
             : launch_dense<float>(x, y, z, boxL, n, cutsq, kmax, sp_idx,
                                   sp_code, nsp, idx, sb, nnei, overflow, s);
}

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double).
// fx/fy/fz acc (n); partial[nlist_partial_rows(n)][8] acc, always written.
// coul (0 none, 1 long, 2 cut) / vdw (0 buck, 1 lj/charmm, 2 lj/cut) /
// disp_long / special select the variant as in csrc/cellpair.cu: with
// disp_long buck/long or lj/long (coul 0 or 1), which read g2_g6_g8 = the
// host array (g6^2, g6^6, g6^8); with coul == 0 q may be null; special_fac
// = special_lj[4], special_coul[4].
extern "C" int nlist_pair(int prec, int ev, int coul, int vdw, int disp_long,
                          int special, const void* x, const void* y,
                          const void* z, const void* q, const void* typ,
                          const void* boxL, const void* coef, int ntypes,
                          int n, const void* idx, const void* sb,
                          const void* nnei, int kmax, double g_ewald,
                          double qqrd2e, double inner_sq, double denom_lj,
                          const double* g2_g6_g8, const void* special_fac,
                          void* fx, void* fy, void* fz, void* partial,
                          void* stream) {
  if (n <= 0 || kmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double zero3[3] = {0.0, 0.0, 0.0};
  const double* disp = g2_g6_g8 ? g2_g6_g8 : zero3;
  void* eatom = nullptr;
  void* vatom = nullptr;
  switch (prec) {
    case 0:
      return pair_dispatch<float, float>(ev, coul, vdw, disp_long, special,
                                         PAIR_ARGS);
    case 1:
      return pair_dispatch<float, double>(ev, coul, vdw, disp_long, special,
                                          PAIR_ARGS);
    case 2:
      return pair_dispatch<double, double>(ev, coul, vdw, disp_long, special,
                                           PAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9d, the per-atom pass: arguments as nlist_pair with prec 0 = (float,
// float) or 2 = (double, double) and no ev (the energies are always
// tallied); eatom (n) and vatom (n, 6) acc, row-major, written for every
// atom (no forces, no partials).
extern "C" int nlist_pair_peratom(
    int prec, int coul, int vdw, int disp_long, int special, const void* x,
    const void* y, const void* z, const void* q, const void* typ,
    const void* boxL, const void* coef, int ntypes, int n, const void* idx,
    const void* sb, const void* nnei, int kmax, double g_ewald,
    double qqrd2e, double inner_sq, double denom_lj, const double* g2_g6_g8,
    const void* special_fac, void* eatom, void* vatom, void* stream) {
  if (n <= 0 || kmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double zero3[3] = {0.0, 0.0, 0.0};
  const double* disp = g2_g6_g8 ? g2_g6_g8 : zero3;
  void* fx = nullptr;
  void* fy = nullptr;
  void* fz = nullptr;
  void* partial = nullptr;
  switch (prec) {
    case 0:
      return pair_variant<float, float, true, true>(coul, vdw, disp_long,
                                                    special, PAIR_ARGS);
    case 2:
      return pair_variant<double, double, true, true>(coul, vdw, disp_long,
                                                      special, PAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
