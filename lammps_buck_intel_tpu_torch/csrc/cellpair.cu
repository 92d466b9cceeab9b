// Cell-pair Buckingham, lj/cut, lj/long or lj/charmm (+ Ewald real-space
// or cut Coulomb, + special bonds, + same-molecule exclusion) forces over
// the sorted cell-slot layout (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/models/pair/cellpair.py
//   compute_cell_tiles_newton (:291, the same half stencil and reaction
//   forces) with styles.py pair_terms (:300),
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
// cell walks the stencil once per group of blockDim slots, and skips a
// later group that holds no atom).  The block walks the Newton half
// stencil of models/pair/cellpair.py half_offsets(reach_z): the own cell
// first, then the K - 1 lexicographically positive offsets (K = 9 reach_z
// + 5: 14 tiles, or 23 at reach_z 2, where the full stencil has 27 or 45).
// make_grid keeps at least 2 |offset| + 1 cells an axis, so each pair of
// cells, with its periodic shift, is one tile of one block, and each pair
// of atoms is decided and evaluated once: from the walking cell's slot i,
// with d = x_i - (x_j + shift), in the own cell only for slot j > slot i.
// For each tile the block stages the j-cell in shared memory with the
// periodic shift added on load (shift = +-L exactly where the stencil
// wraps): (x, y, z, q) as one packed Pos4, and (aid, typ) as one int2 for
// the evaluate phase.  Empty slots (aid >= n) are staged at kFar, and with
// a mol plane (one int a slot, staged beside aid; -1 on empty slots)
// every pair of one molecule is skipped: a runtime test on a uniform
// pointer, so the exclusion doubles no template variant.
//
// Filter, then evaluate.  Each warp works a staged tile in chunks of
// kChunk candidates.  (1) Filter: every lane (one i slot) tests each j of
// the chunk with pairterms::dist_sq and clamp_rsq against the largest
// range of its type row (the larger of cut_ljsq and cut_coulsq over the
// row's type pairs) and, with a mol plane, the molecule ids; the hits form
// a 32-bit mask a lane (in the own cell the bits of j <= i are cleared,
// and a warp starts at the chunk of its own first slot).  (2) Compact: an
// exclusive warp scan of the masks' popcounts gives each lane its place,
// and the lane writes its hits, j ascending, as (j, lane) entries into the
// warp's queue in shared memory (owner-major); its (mask, place) go beside
// the queue.  (3) Evaluate: when more than kFlushAt entries wait, after
// kMaxBatches chunks, or at the end of a block of kSuper candidates (the
// queue indexes the staged tile), the warp takes the queue 32 entries at
// a time, every lane busy: each lane reads its entry's owner from the
// staged owner table, makes the type pair's strict cut tests (which every
// entry passes where a row's type pairs share one cutoff, as on every deck
// here) and runs pairterms::pair_force, and writes the entry's fs over it
// (0 for an entry out of range).  (4) Each owner sums +fs * d of its own
// entries in queue order into its force.  (5) A warp-wide bit transpose
// of the chunk's masks (five shuffle stages) gives lane b the owners that
// hit candidate j0 + b, and the lane sums -fs * d over them in lane order
// (an owner's entry sits at its place plus the popcount of its mask below
// b) into the warp's row of column sums in shared memory.  Owner and
// column lane round the same product fs * d, so each pair's two terms
// cancel exactly.  Energy and virial are summed by the evaluating lane,
// once a pair.  The queue holds kFlushAt + 32 * kChunk entries, so a dense
// tile, where every lane hits every j, flushes after each chunk and stays
// correct.
//
// Reactions, with no float atomics.  After each kSuper candidates of a
// tile (a barrier; the tile's last ones wait for the barrier before the
// next tile), thread j sums the warps' rows for slot j in warp order.  The
// own cell's sums go into the owners' forces: those of the thread's own
// slot group into its registers, those of a later group into the force
// plane, which that group's owners add at their end.  The sums of tile k
// >= 1 go to the reaction plane react[k - 1] at the j-cell's slots:
// exactly one block writes each (cell, k), and a later slot group of that
// block adds to what the first wrote.  A second launch,
// cellpair_kernel_reactions, adds react[0..K-2] in k order to every slot's
// own force.  Every sum runs in a fixed order, so two launches on one
// state give the same bits.  Energy and virial per block are reduced in a
// fixed shuffle tree into partial[cell][8] = (evdwl, ecoul, vxx, vyy, vzz,
// vxy, vxz, vyz) in acc; the caller sums the partials over cells in a
// second, deterministic pass.  ecoul is a sum of large terms of both
// signs, so it stays in acc like evdwl.  The buck-only variant (COUL =
// kCoulNone) compiles to the kernel of the buck decks with no Coulomb
// work; VDW and SPECIAL are template constants too, so the buck and
// Coulomb kernels carry none of the lj/charmm or special-bond code, and
// coul/cut none of the erfc.
//
// Counters.  With a non-null counts (int64[3]; the wrapper passes one
// while the program's tracer is on) each block adds, once, the candidates
// its lanes tested (cap per tile of the half stencil and active slot), the
// pairs in range (the entries that passed the strict cut tests, each pair
// once), and the lane slots its evaluate rounds issued (32 a round).  The
// plain version (models/pair/cellpair.py) counts the first two from its
// own mask; the third is this kernel's alone.
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
// table lists both directions, so the owner's row finds the pair from
// whichever side the half stencil decides it.
//
// What bounds it on the H100.  Latency, through the warps an SM holds:
// clock64 probes put a warp's time ~40% in the tile barriers and staging,
// the rest in chains of dependent shared-memory loads, so the kernel's
// time follows the warp time over the resident warps.  At
// cristobalite_pppm.yaml (259,200 atoms, cut 10 + skin 1, reach_z 1, cap
// 128) an atom tests 14 * 128 = 1,792 candidates, of which about 134 lie
// in range (each pair once); the full stencil tested 27 * 128 from both
// sides, and the half stencil halves a warp's time.  What the reactions
// add is shared memory (rows, masks) and registers, which cost resident
// warps: so the rows hold kSuper candidates, not a whole tile, a flush
// takes at most two chunks, and __launch_bounds__(kMaxThreads, 3) bounds
// the registers to 80, which keeps six 128-thread blocks an SM at
// cristobalite and three 256-thread blocks at rhodo's cap 264 (with
// specials); the full-stencil kernel held eight and three.  The tile
// staging keeps device-memory traffic at one read of each neighbour cell
// per block; the reaction planes add (K - 1) * 3 acc values a slot,
// written once and read once.  Cluster-pair layouts are later work.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double).  Launches both kernels on the caller's stream,
// allocates nothing (the caller owns the reaction planes), returns
// cudaGetLastError().

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
constexpr int kFlushAt = 128;
constexpr int kMaxBatches = 2;
constexpr int kQueue = kFlushAt + 32 * kChunk;  // entries a warp
// candidates of a tile whose column sums the warps' rows hold at once
constexpr int kSuper = 128;
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

// Lane l holds row l of a 32 x 32 bit matrix (bit b: column b); returns
// column `lane` (bit o: row o's bit lane).  Each stage swaps bit j of the
// lane index with bit j of the bit index.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned lo = j == 16  ? 0x0000ffffu
                        : j == 8 ? 0x00ff00ffu
                        : j == 4 ? 0x0f0f0f0fu
                        : j == 2 ? 0x33333333u
                                 : 0x55555555u;
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~lo) | ((y & ~lo) >> j))
                   : ((x & lo) | ((y & lo) << j));
  }
  return x;
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

// Offset k of half_offsets(reach_z): the own cell, then the positive
// offsets in lexicographic order (0, 0, 1..r), (0, 1, -r..r), (1, -1..1,
// -r..r).
__device__ __forceinline__ void half_offset(int k, int reach_z, int& ox,
                                            int& oy, int& oz) {
  const int nz = 2 * reach_z + 1;
  ox = oy = oz = 0;
  if (k == 0) return;
  int t = k - 1;
  if (t < reach_z) {
    oz = t + 1;
    return;
  }
  t -= reach_z;
  if (t < nz) {
    oy = 1;
    oz = t - reach_z;
    return;
  }
  t -= nz;
  ox = 1;
  oy = t / nz - 1;
  oz = t % nz - reach_z;
}

// Shared memory of one block: the layout the kernel carves and the launch
// sizes.
template <typename T, typename A>
size_t smem_bytes(int cap, int nthr, int ntypes, bool has_mol, bool special,
                  int nspecial) {
  const size_t capr = (cap + 31) / 32 * 32, nwarps = nthr / 32;
  return sizeof(Pos4<T>) * (capr + nthr) +
         sizeof(A) * 3 * nwarps * std::min<size_t>(capr, kSuper) +
         sizeof(int2) * (capr + nwarps * kMaxBatches * 32) +
         sizeof(T) * (nwarps * kQueue + ntypes * (ntypes * kNcoef + 1) +
                      (special ? 8 : 0)) +
         sizeof(int) * (nthr + (has_mol ? capr : 0) +
                        (special ? nspecial * nthr : 0));
}

// COUL: pairterms::kCoulNone / kCoulLong / kCoulCut; VDW: kVdwBuck,
// kVdwCharmm or kVdwLj; DISP_LONG: the damped r^-6 term of lj/long or
// buck/long.
template <typename T, typename A, bool EV, int COUL, int VDW, bool SPECIAL,
          bool DISP_LONG>
__global__ void __launch_bounds__(kMaxThreads, 3) cellpair_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ typ, const int* __restrict__ aid,
    const int* __restrict__ mol, const T* __restrict__ coef, int ntypes,
    int n, int ncx, int ncy, int ncz, int cap, int reach_z, double Lx,
    double Ly, double Lz, T g_ewald, T qqrd2e, T inner_sq, T denom_lj,
    DispConst<T> dc, const int* __restrict__ special, int nspecial,
    const T* __restrict__ special_fac, A* __restrict__ fx,
    A* __restrict__ fy, A* __restrict__ fz, A* __restrict__ react,
    A* __restrict__ partial, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int capr = (cap + 31) & ~31;
  const int rcols = min(capr, kSuper);  // the columns of a row
  const int ncoef = ntypes * ntypes * kNcoef;
  // 16-byte rows first, then 8-byte, then A, T and 4-byte ones
  Pos4<T>* s_pos = reinterpret_cast<Pos4<T>*>(smem_raw);  // [capr]
  Pos4<T>* s_own = s_pos + capr;  // [nthr]: xi, yi, zi, qqrd2e qi
  int2* s_at = reinterpret_cast<int2*>(s_own + nthr);  // [capr]: aid, typ
  // [nwarps][kMaxBatches][32]: each lane's (mask, queue place) a batch
  int2* s_ms = s_at + capr;
  // [3][nwarps][rcols]: each warp's column sums of a tile's reactions,
  // kSuper candidates at a time
  A* s_row = reinterpret_cast<A*>(s_ms + nwarps * kMaxBatches * 32);
  T* s_queue = reinterpret_cast<T*>(s_row + 3 * nwarps * rcols);
  T* s_coef = s_queue + nwarps * kQueue;
  T* s_rowmax = s_coef + ncoef;  // [ntypes]: the filter's cutoff a row
  T* s_fac = s_rowmax + ntypes;  // special_lj[4], special_coul[4]
  int* s_oti = reinterpret_cast<int*>(s_fac + (SPECIAL ? 8 : 0));  // [nthr]
  int* s_mol = s_oti + nthr;             // [capr] with a mol plane
  int* s_sp = s_mol + (mol ? capr : 0);  // [nspecial][nthr]: partners

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, wbase = tid & ~31;
  T* const wq = s_queue + warp * kQueue;
  int2* const wms = s_ms + warp * (kMaxBatches * 32);
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
  const int K = 9 * reach_z + 5;
  const size_t ns = static_cast<size_t>(ncx) * ncy * ncz * cap;
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
    // a later group of empty slots has no pair: its forces are zero, and
    // the own cell's reactions reach only slots that hold an atom
    if (i0 > 0 && !__syncthreads_or(active)) {
      if (has_i) fx[si] = fy[si] = fz[si] = A(0);
      continue;
    }
    // qqrd2e * qi once per slot: the plain version's (qqrd2e * qi) * qj
    s_own[tid] = Pos4<T>{xi, yi, zi, qqrd2e * qi};
    s_oti[tid] = ti;
    if (SPECIAL) {
      for (int k = 0; k < nspecial; ++k)
        s_sp[k * nthr + tid] = active ? special[ai * nspecial + k] : -1;
    }
    if (active) n_tested += static_cast<unsigned long long>(K) * cap;
    A fxi = 0, fyi = 0, fzi = 0;

    // Thread j mod nthr sums the warps' rows for slot j of tile kk's
    // candidates c0 .. c0 + kSuper - 1, in warp order.
    auto reduce = [&](int kk, int cjj, int c0) {
      for (int j = tid; j < cap; j += nthr) {
        if (j < c0 || j >= c0 + kSuper) continue;
        A sx = 0, sy = 0, sz = 0;
        for (int w = 0; w < nwarps; ++w) {
          sx += s_row[w * rcols + j - c0];
          sy += s_row[(nwarps + w) * rcols + j - c0];
          sz += s_row[(2 * nwarps + w) * rcols + j - c0];
        }
        if (kk == 0) {  // the own cell: only slots j > i >= i0
          if (j >= i0 + nthr) {
            // a later group's slot: its force plane holds the sum of
            // the groups before it until that group adds its own
            A* f = fx + static_cast<size_t>(c) * cap + j;
            A* g = fy + static_cast<size_t>(c) * cap + j;
            A* h = fz + static_cast<size_t>(c) * cap + j;
            if (i0 > 0) {
              sx += *f;
              sy += *g;
              sz += *h;
            }
            *f = sx;
            *g = sy;
            *h = sz;
          } else if (j >= i0) {  // j = i0 + tid: this thread's slot
            fxi += sx;
            fyi += sy;
            fzi += sz;
          }
        } else {
          A* r = react + static_cast<size_t>(kk - 1) * 3 * ns +
                 static_cast<size_t>(cjj) * cap + j;
          if (i0 > 0) {  // this block's earlier slot group wrote it
            sx += r[0];
            sy += r[ns];
            sz += r[2 * ns];
          }
          r[0] = sx;
          r[ns] = sy;
          r[2 * ns] = sz;
        }
      }
    };
    // the column sums of a tile's last kSuper candidates wait in s_row
    // until the barrier before the next tile (k == K: the last tile's only)
    int k_prev = -1, cj_prev = 0, c_prev = 0;
    for (int k = 0; k <= K; ++k) {
      __syncthreads();  // the previous tile is consumed
      if (k_prev >= 0) reduce(k_prev, cj_prev, c_prev);
      if (k == K) break;
      int ox, oy, oz;
      half_offset(k, reach_z, ox, oy, oz);
      int tx = cx + ox, ty = cy + oy, tz = cz + oz;
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
      // in the own cell only j > i: the chunks below the warp's first
      // slot hold no pair, and their column sums are zero
      const int jstart = k == 0 ? i0 + wbase : 0;
      for (int c0 = 0; c0 < cap; c0 += kSuper) {
        if (c0 > 0) {
          __syncthreads();  // the rows of the previous kSuper are in
          reduce(k, cj, c0 - kSuper);
          __syncthreads();  // ... and read
        }
        const int jend = min(c0 + kSuper, cap);
        const int j1 = max(c0, jstart);
        for (int j = lane; j < min(j1 - c0, rcols); j += 32) {
          s_row[warp * rcols + j] = A(0);
          s_row[(nwarps + warp) * rcols + j] = A(0);
          s_row[(2 * nwarps + warp) * rcols + j] = A(0);
        }
        int count = 0, nb = 0, jfirst = 0;
        for (int j0 = j1; j0 < jend; j0 += kChunk) {
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
            if (k == 0) {  // the own cell: only j > i
              const int d = islot - j0;
              if (d >= 31)
                m = 0;
              else if (d >= 0)
                m &= ~((2u << d) - 1u);
            }
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
          wms[nb * 32 + lane] = make_int2(static_cast<int>(m), start);
          ++nb;
          count += __shfl_sync(kFull, incl, 31);
          if (count <= kFlushAt && nb < kMaxBatches && j0 + kChunk < jend)
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
          for (int b = 0; b < nb; ++b) {
            const int jb = jfirst + b * kChunk;
            const int2 mine = wms[b * 32 + lane];
            // (4) each owner sums its entries in queue order
            {
              unsigned mm = static_cast<unsigned>(mine.x);
              int p = mine.y;
              while (mm) {
                const int bit = __ffs(mm) - 1;
                mm &= mm - 1;
                const Pos4<T> pj = s_pos[jb + bit];
                const T fs = wq[p++];
                fxi += static_cast<A>(fs * (xi - pj.x));
                fyi += static_cast<A>(fs * (yi - pj.y));
                fzi += static_cast<A>(fs * (zi - pj.z));
              }
            }
            // (5) each lane b sums the reactions of candidate jb + b, its
            // owners (the transposed masks) in lane order
            unsigned tm = transpose32(static_cast<unsigned>(mine.x), lane);
            A rx = 0, ry = 0, rz = 0;
            if (tm) {
              const Pos4<T> pc = s_pos[jb + lane];
              const unsigned below = (1u << lane) - 1u;
              while (tm) {
                const int o = __ffs(tm) - 1;
                tm &= tm - 1;
                const int2 ms = wms[b * 32 + o];
                const T fs = wq[ms.y + __popc(static_cast<unsigned>(ms.x) &
                                              below)];
                const Pos4<T> own = s_own[wbase + o];
                rx -= static_cast<A>(fs * (own.x - pc.x));
                ry -= static_cast<A>(fs * (own.y - pc.y));
                rz -= static_cast<A>(fs * (own.z - pc.z));
              }
            }
            s_row[warp * rcols + jb - c0 + lane] = rx;
            s_row[(nwarps + warp) * rcols + jb - c0 + lane] = ry;
            s_row[(2 * nwarps + warp) * rcols + jb - c0 + lane] = rz;
          }
          __syncwarp();
          count = 0;
          nb = 0;
        }
        c_prev = c0;
      }
      k_prev = k;
      cj_prev = cj;
    }
    // the own cell's reactions on this group's slots are all in: its
    // own group's since the barrier before tile 1, the groups' before it
    // in the force plane
    if (has_i) {
      if (i0 > 0) {
        fxi += fx[si];
        fyi += fy[si];
        fzi += fz[si];
      }
      fx[si] = fxi;
      fy[si] = fyi;
      fz[si] = fzi;
    }
  }
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

// Each slot's own force plus its reactions from the K - 1 positive tiles,
// summed in tile order.
template <typename A>
__global__ void cellpair_kernel_reactions(A* __restrict__ fx,
                                          A* __restrict__ fy,
                                          A* __restrict__ fz,
                                          const A* __restrict__ react,
                                          size_t ns, int nplanes) {
  const size_t s = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (s >= ns) return;
  A ax = fx[s], ay = fy[s], az = fz[s];
  for (int k = 0; k < nplanes; ++k) {
    const A* r = react + static_cast<size_t>(k) * 3 * ns + s;
    ax += r[0];
    ay += r[ns];
    az += r[2 * ns];
  }
  fx[s] = ax;
  fy[s] = ay;
  fz[s] = az;
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
           void* react, void* partial, void* counts, cudaStream_t stream) {
  const int threads = std::min((cap + 31) / 32 * 32, kMaxThreads);
  const size_t smem = smem_bytes<T, A>(cap, threads, ntypes, mol != nullptr,
                                       SPECIAL, nspecial);
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
      static_cast<A*>(fy), static_cast<A*>(fz), static_cast<A*>(react),
      static_cast<A*>(partial), static_cast<unsigned long long*>(counts));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ns = static_cast<size_t>(ncx) * ncy * ncz * cap;
  const int rthreads = 256;
  cellpair_kernel_reactions<A>
      <<<static_cast<unsigned>((ns + rthreads - 1) / rthreads), rthreads, 0,
         stream>>>(static_cast<A*>(fx), static_cast<A*>(fy),
                   static_cast<A*>(fz), static_cast<const A*>(react), ns,
                   9 * reach_z + 4);
  return static_cast<int>(cudaGetLastError());
}

#define CELLPAIR_PARAMS                                                      \
  const void *x, const void *y, const void *z, const void *q,                \
      const void *typ, const void *aid, const void *mol, const void *coef,   \
      int ntypes, int n, int ncx, int ncy, int ncz, int cap, int reach_z,    \
      double Lx, double Ly, double Lz, double g_ewald, double qqrd2e,        \
      double inner_sq, double denom_lj, const double *disp,                  \
      const void *special, int nspecial, const void *special_fac, void *fx,  \
      void *fy, void *fz, void *react, void *partial, void *counts,          \
      cudaStream_t s
#define CELLPAIR_ARGS                                                       \
  x, y, z, q, typ, aid, mol, coef, ntypes, n, ncx, ncy, ncz, cap, reach_z, \
      Lx, Ly, Lz, g_ewald, qqrd2e, inner_sq, denom_lj, disp, special,      \
      nspecial, special_fac, fx, fy, fz, react, partial, counts, s

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
// react: acc-typed scratch of (9 reach_z + 4) * 3 * ncell * cap values,
// the reaction planes, overwritten by every call.
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
                               void* fz, void* react, void* partial,
                               void* counts, void* stream) {
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
