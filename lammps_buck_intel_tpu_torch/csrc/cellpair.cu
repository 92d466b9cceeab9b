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
// (blockDim = cap rounded up to a warp, at most kMaxThreads; a larger
// cell walks the stencil once per group of blockDim slots).  The block
// walks the FULL (3, 3, 2*reach_z+1) stencil of neighbour cells; for each
// it stages the j-cell in shared memory with the periodic shift added on
// load (shift = +-L exactly where the stencil wraps): (x, y, z, q) as one
// packed Pos4, and (aid, typ) as one int2 for the evaluate phase.  No
// Newton: each pair is evaluated from both sides, so forces
// need no atomics and are deterministic; energy and virial are halved by
// the caller.  Empty slots (aid >= n) and aid_i == aid_j are skipped, and
// with a mol plane (one int a slot, staged beside aid; -1 on empty slots)
// every pair of one molecule: a runtime test on a uniform pointer, so the
// exclusion doubles no template variant.
//
// Filter, then evaluate.  Each warp works a staged tile in chunks of
// kChunk candidates.  (1) Filter: every lane (one i slot) tests each j of
// the chunk with pairterms::dist_sq and clamp_rsq against the largest
// range of its type row (the larger of cut_ljsq and cut_coulsq over the
// row's type pairs) and, with a mol plane, the molecule ids; the hits form
// a 32-bit mask a lane.  An empty slot is staged at kFar, beyond every
// cutoff, and the atom's own slot is cleared from the own cell's mask, so
// the filter reads one Pos4 a candidate and no id.  (2) Compact: an
// exclusive warp scan of the masks' popcounts gives each lane its place,
// and the lane writes its hits, j ascending, as (j, lane) entries into
// the warp's queue in shared memory (owner-major).  (3) Evaluate: when
// more than kFlushAt entries wait, after kMaxBatches chunks, or at the end
// of the tile (the queue indexes the staged tile), the warp takes the
// queue 32 entries at a time, every lane busy: each lane reads its
// entry's owner from the staged owner table, makes the type pair's strict
// cut tests (which every entry passes where a row's type pairs share one
// cutoff, as on every deck here) and runs pairterms::pair_force, and
// writes the entry's fs over it (0 for an entry out of range).  (4) Each
// owner then sums fs * d of its own entries in queue order into its
// force.  A slot's forces so sum in stencil order, then j order, as a
// one-phase kernel would sum them; energy and virial are summed by the
// evaluating lane (a fixed order too).  The queue holds kFlushAt + 32 *
// kChunk entries, so a dense tile, where every lane hits every j, flushes
// after each chunk and stays correct.
// Energy and virial per block are reduced in a fixed shuffle tree into
// partial[cell][8] = (evdwl, ecoul, vxx, vyy, vzz, vxy, vxz, vyz) in acc;
// the caller sums the partials over cells in a second, deterministic pass.
// ecoul is a sum of large terms of both signs, so it stays in acc like
// evdwl.  The buck-only variant (COUL = kCoulNone) compiles to the kernel
// of the buck decks with no Coulomb work; VDW and SPECIAL are template
// constants too, so the buck and Coulomb kernels carry none of the
// lj/charmm or special-bond code, and coul/cut none of the erfc.
//
// Counters.  With a non-null counts (int64[3]; the wrapper passes one
// while the program's tracer is on) each block adds, once, the candidates
// its lanes tested (cap per stencil cell and active slot), the pairs in
// range (the entries that passed the strict cut tests), and the lane
// slots its evaluate rounds issued (32 a round).  The plain version
// (models/pair/cellpair.py) counts the first two from its own mask; the
// third is this kernel's alone.
//
// Special bonds.  The JAX package gathers each slot's partner ids per
// rebin and compares them with every candidate's id.  Here the partner
// table stays in atom order (packed idx * 4 + code, S per atom, -1 =
// none): a thread copies the S entries of its own atom into shared memory
// once a slot group, and the evaluating lane compares its owner's entries
// with the j atom's id.  The LJ term of a special pair is scaled where it
// is evaluated (skipped when the factor is 0), never computed whole and
// subtracted: a 1-2 pair at 1.09 A has an LJ term near 5e5 kcal/mol, and
// an f32 difference of such terms would leave errors of order 1e-2.  The
// match is symmetric (the table lists both directions), as the full
// stencil needs.
//
// What bounds it on the H100.  Issued instructions, not bytes.  At
// cristobalite_pppm.yaml (259,200 atoms, cut 10 + skin 1, reach_z 1, cap
// 128) an atom tests 27 * 128 = 3,456 candidates, of which about 268
// (7.8%) lie in range.  A one-phase kernel runs the ~70-instruction pair
// branch (an IEEE 1/rsq, a sqrt, two expf, the A&S erfc) whenever any lane
// of a warp has a pair in range, which the cell's geometry makes about
// half of all candidates, with one lane in ten doing work.  Here the
// filter costs ~12 instructions a candidate (the SASS of the f32 kernel),
// and the pair branch runs once a pair with 93% of the lanes busy; the
// owners' sums and the scan add a few instructions a hit.  On an H100
// 80GB HBM3 that took the force-only launch there from 2.40 to 1.50 ms,
// with the filter the larger part of what remains.  The tile staging
// keeps device-memory traffic at one read of each neighbour cell per
// block.  Newton with atomic reaction forces (half the stencil) and
// cluster-pair layouts are later work.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double).  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

#include "pair_terms.cuh"

namespace {

using pairterms::DispConst;
using pairterms::kCoulNone;
using pairterms::kNcoef;
using pairterms::kVdwBuck;
using pairterms::kVdwCharmm;
using pairterms::kVdwLj;
constexpr int kMaxThreads = 256;
// candidates a lane filters into one mask; entries waiting that make a
// warp evaluate; masks a warp holds before it evaluates.
constexpr int kChunk = 32;
constexpr int kFlushAt = 256;
constexpr int kMaxBatches = 4;
constexpr int kQueue = kFlushAt + 32 * kChunk;  // entries a warp
constexpr unsigned kFull = 0xffffffffu;
// where an empty slot is staged: its squared distance (~3e36) lies past
// every cutoff and inside the f32 range
constexpr double kFar = 1e18;

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// A staged slot: the shifted position and the charge, loaded at once.
template <typename T>
struct alignas(16) Pos4 {
  T x, y, z, q;
};

// A queue entry ((j << 5) | owner lane) lives in the slot that later
// holds its fs: the low 4 bytes of the T.
__device__ __forceinline__ void put_entry(float* q, int p, int e) {
  reinterpret_cast<int*>(q)[p] = e;
}
__device__ __forceinline__ void put_entry(double* q, int p, int e) {
  reinterpret_cast<int*>(q)[2 * p] = e;
}
__device__ __forceinline__ int get_entry(const float* q, int p) {
  return reinterpret_cast<const int*>(q)[p];
}
__device__ __forceinline__ int get_entry(const double* q, int p) {
  return reinterpret_cast<const int*>(q)[2 * p];
}

// COUL: pairterms::kCoulNone / kCoulLong / kCoulCut; VDW: kVdwBuck,
// kVdwCharmm or kVdwLj; DISP_LONG: the damped r^-6 term of lj/long or
// buck/long.
template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG>
__global__ void __launch_bounds__(kMaxThreads) cellpair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const int* __restrict__ aid,
    const int* __restrict__ mol, const T* __restrict__ coef, int ntypes,
    int n, int ncx, int ncy, int ncz, int cap, int reach_z, double Lx,
    double Ly, double Lz, T g_ewald, T qqrd2e, T inner_sq, T denom_lj,
    DispConst<T> dc, const int* __restrict__ special, int nspecial,
    const T* __restrict__ special_fac, A* __restrict__ fx,
    A* __restrict__ fy, A* __restrict__ fz, A* __restrict__ partial,
    unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x;
  const int capr = (cap + 31) & ~31;
  const int ncoef = ntypes * ntypes * kNcoef;
  // 16-byte rows first, then 8-byte, then 4-byte ones
  Pos4<T>* s_pos = reinterpret_cast<Pos4<T>*>(smem_raw);  // [capr]
  Pos4<T>* s_own = s_pos + capr;  // [nthr]: xi, yi, zi, qqrd2e qi
  int2* s_at = reinterpret_cast<int2*>(s_own + nthr);  // [capr]: aid, typ
  T* s_queue = reinterpret_cast<T*>(s_at + capr);  // [nthr / 32][kQueue]
  T* s_coef = s_queue + (nthr >> 5) * kQueue;
  T* s_rowmax = s_coef + ncoef;  // [ntypes]: the filter's cutoff a row
  T* s_fac = s_rowmax + ntypes;  // special_lj[4], special_coul[4]
  int* s_oti = reinterpret_cast<int*>(s_fac + (SPECIAL ? 8 : 0));  // [nthr]
  int* s_mol = s_oti + nthr;             // [capr] with a mol plane
  int* s_sp = s_mol + (mol ? capr : 0);  // [nspecial][nthr]: partners

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wbase = tid & ~31;
  T* const wq = s_queue + (tid >> 5) * kQueue;
  for (int k = tid; k < ncoef; k += nthr) s_coef[k] = coef[k];
  for (int ti = tid; ti < ntypes; ti += nthr) {
    T cmax = 0;
    for (int tj = 0; tj < ntypes; ++tj) {
      const T* cf = coef + (ti * ntypes + tj) * kNcoef;
      const T ct = (COUL != kCoulNone && cf[7] > cf[5]) ? cf[7] : cf[5];
      cmax = ct > cmax ? ct : cmax;
    }
    s_rowmax[ti] = cmax;
  }
  if (SPECIAL && tid < 8) s_fac[tid] = special_fac[tid];

  const int cz = c % ncz;
  const int cy = (c / ncz) % ncy;
  const int cx = c / (ncz * ncy);
  const int nz = 2 * reach_z + 1;
  const int S = 9 * nz;
  const int kself = 4 * nz + reach_z;  // the stencil's offset (0, 0, 0)
  A ev = 0, ec = 0, v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0;
  unsigned long long n_tested = 0, n_in = 0, n_lanes = 0;

  for (int i0 = 0; i0 < cap; i0 += nthr) {
    const int islot = i0 + tid;
    const bool has_i = islot < cap;
    const int si = c * cap + islot;
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
    if (!active) ti = 0;
    // qqrd2e * qi once per slot: the plain version's (qqrd2e * qi) * qj
    s_own[tid] = Pos4<T>{xi, yi, zi, qqrd2e * qi};
    s_oti[tid] = ti;
    if (SPECIAL) {
      for (int k = 0; k < nspecial; ++k)
        s_sp[k * nthr + tid] = active ? special[ai * nspecial + k] : -1;
    }
    if (active) n_tested += static_cast<unsigned long long>(S) * cap;
    A fxi = 0, fyi = 0, fzi = 0;

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
      for (int j = tid; j < capr; j += nthr) {
        // an empty slot, and the chunk's tail past cap, sit at kFar,
        // where no cutoff reaches, with type 0
        Pos4<T> pj{T(kFar), T(kFar), T(kFar), T(0)};
        int2 at = make_int2(n, 0);
        if (j < cap) {
          const int sj = cj * cap + j;
          at.x = aid[sj];
          if (at.x < n) {
            pj = Pos4<T>{x[sj] + shx, y[sj] + shy, z[sj] + shz,
                         COUL ? q[sj] : T(0)};
            at.y = typ[sj];
          }
          if (mol) s_mol[j] = mol[sj];
        } else if (mol) {
          s_mol[j] = -1;
        }
        s_pos[j] = pj;
        s_at[j] = at;
      }
      __syncthreads();

      const T cut_i = s_rowmax[ti];
      int count = 0, nb = 0, jfirst = 0;
      unsigned bm[kMaxBatches];
      int bs[kMaxBatches];
      for (int j0 = 0; j0 < cap; j0 += kChunk) {
        // (1) filter
        unsigned m = 0;
        if (active) {
#pragma unroll
          for (int b = 0; b < kChunk; ++b) {
            const Pos4<T> pj = s_pos[j0 + b];
            const T rsq = pairterms::clamp_rsq(
                pairterms::dist_sq(xi - pj.x, yi - pj.y, zi - pj.z));
            bool hit = rsq < cut_i;
            if (mol) hit &= s_mol[j0 + b] != mi;
            m |= static_cast<unsigned>(hit) << b;
          }
          // the atom itself: its own slot of the stencil's own cell
          if (k == kself && static_cast<unsigned>(islot - j0) < kChunk)
            m &= ~(1u << (islot - j0));
        }
        // (2) compact: owner-major, j ascending
        const int cnt = __popc(m);
        int incl = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += v;
        }
        const int start = count + incl - cnt;
        {
          unsigned mm = m;
          int p = start;
          while (mm) {
            const int b = __ffs(mm) - 1;
            mm &= mm - 1;
            put_entry(wq, p++, ((j0 + b) << 5) | lane);
          }
        }
        if (nb == 0) jfirst = j0;
#pragma unroll
        for (int b = 0; b < kMaxBatches; ++b) {
          if (b == nb) {
            bm[b] = m;
            bs[b] = start;
          }
        }
        ++nb;
        count += __shfl_sync(kFull, incl, 31);
        if (count <= kFlushAt && nb < kMaxBatches && j0 + kChunk < cap)
          continue;
        __syncwarp();
        // (3) evaluate, 32 entries a round
        for (int p = lane; p < count; p += 32) {
          const int e = get_entry(wq, p);
          const int o = wbase + (e & 31);
          const int j = e >> 5;
          const Pos4<T> own = s_own[o];
          const Pos4<T> pj = s_pos[j];
          const int2 at = s_at[j];
          const T dx = own.x - pj.x;
          const T dy = own.y - pj.y;
          const T dz = own.z - pj.z;
          const T rsq =
              pairterms::clamp_rsq(pairterms::dist_sq(dx, dy, dz));
          const T* cf = s_coef + (s_oti[o] * ntypes + at.y) * kNcoef;
          // the strict cut tests of the type pair: every entry passes
          // them where the row's type pairs share one cutoff
          bool in_lj, in_coul;
          const bool in =
              pairterms::cut_tests<T, COUL>(rsq, cf, in_lj, in_coul);
          T fs = 0;
          if (in) {
            T f_lj = 1, f_coul = 1;
            if (SPECIAL) {
              int code = 0;
              for (int t = 0; t < nspecial; ++t) {
                const int sp = s_sp[t * nthr + o];
                if ((sp >> 2) == at.x) code = sp & 3;  // -1 matches none
              }
              f_lj = s_fac[code];
              f_coul = s_fac[4 + code];
            }
            const T qj = pj.q;
            T evdwl, ecoul;
            fs = pairterms::pair_force<T, EV, COUL, VDW, SPECIAL, DISP_LONG>(
                rsq, in_lj, in_coul, cf, own.q, &qj, f_lj, f_coul, g_ewald,
                inner_sq, denom_lj, dc, evdwl, ecoul);
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
            ++n_in;
          }
          wq[p] = fs;
        }
        if (lane == 0) n_lanes += (count + 31) & ~31;
        __syncwarp();
        // (4) each owner sums its entries in queue order
#pragma unroll
        for (int b = 0; b < kMaxBatches; ++b) {
          if (b >= nb) break;
          unsigned mm = bm[b];
          int p = bs[b];
          const int jb = jfirst + b * kChunk;
          while (mm) {
            const int bit = __ffs(mm) - 1;
            mm &= mm - 1;
            const Pos4<T> pj = s_pos[jb + bit];
            const T fs = wq[p++];
            const T dx = xi - pj.x;
            const T dy = yi - pj.y;
            const T dz = zi - pj.z;
            fxi += static_cast<A>(fs * dx);
            fyi += static_cast<A>(fs * dy);
            fzi += static_cast<A>(fs * dz);
          }
        }
        __syncwarp();
        count = 0;
        nb = 0;
      }
    }
    if (has_i) {
      fx[si] = fxi;
      fy[si] = fyi;
      fz[si] = fzi;
    }
    __syncthreads();  // the owner table is consumed
  }
  const int warp = tid >> 5, nwarps = nthr >> 5;
  if (EV) {
    __shared__ A red[kMaxThreads / 32][8];
    A vals[8] = {ev, ec, v0, v1, v2, v3, v4, v5};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const A s = warp_sum(vals[k]);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const A s = warp_sum(lane < nwarps ? red[lane][k] : A(0));
        if (lane == 0) partial[c * 8 + k] = s;
      }
    }
  }
  if (counts) {  // uniform: every thread takes the same branch
    __shared__ unsigned long long cred[kMaxThreads / 32][3];
    const unsigned long long vals[3] = {n_tested, n_in, n_lanes};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned long long s = warp_sum(vals[k]);
      if (lane == 0) cred[warp][k] = s;
    }
    __syncthreads();
    if (tid < 3) {
      unsigned long long s = 0;
      for (int w = 0; w < nwarps; ++w) s += cred[w][tid];
      atomicAdd(counts + tid, s);
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
           void* partial, void* counts, cudaStream_t stream) {
  const int threads = std::min((cap + 31) / 32 * 32, kMaxThreads);
  const int capr = (cap + 31) / 32 * 32;
  const size_t smem =
      sizeof(Pos4<T>) * (capr + threads) + sizeof(int2) * capr +
      sizeof(T) * (threads / 32 * kQueue + ntypes * (ntypes * kNcoef + 1) +
                   (SPECIAL ? 8 : 0)) +
      sizeof(int) * (threads + (mol ? capr : 0) +
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
      static_cast<A*>(fy), static_cast<A*>(fz), static_cast<A*>(partial),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

#define CELLPAIR_PARAMS                                                      \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *aid, const void *mol, const void *coef,   \
      int ntypes, int n, int ncx, int ncy, int ncz, int cap, int reach_z,    \
      double Lx, double Ly, double Lz, double g_ewald, double qqrd2e,        \
      double inner_sq, double denom_lj, const double *disp,                  \
      const void *special, int nspecial, const void *special_fac, void *fx,  \
      void *fy, void *fz, void *partial, void *counts, cudaStream_t s
#define CELLPAIR_ARGS                                                       \
  x, y, z, q, typ, aid, mol, coef, ntypes, n, ncx, ncy, ncz, cap, reach_z, \
      Lx, Ly, Lz, g_ewald, qqrd2e, inner_sq, denom_lj, disp, special,      \
      nspecial, special_fac, fx, fy, fz, partial, counts, s

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
// special_coul[4].  counts: null, or the device's int64[3] (candidates
// tested, pairs in range, evaluate lane slots) each block adds into.
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
                               void* fz, void* partial, void* counts,
                               void* stream) {
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
