// Cell-slot rebin: wrap, cell ids, mover compaction and placement, and
// the full counting sort (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/neighbor/cell_slots.py
//   rebin_incremental (:314) with wrap_state (:182), _slot_cid (:265) and
//   bin_to_slots (:225) as its fallback; also rebin (:289), the full sort
//   used at set-up and after a capacity grow.
//
// Design.  The incremental rebin is six launches on one stream, and the
// choice between the incremental path and the full fallback is made on
// the device: every kernel after the first reads the mover count and
// returns at once on the path not taken, so the host never waits.
//   1. mark   (one thread per slot): wrap x/y/z in place and update the
//      image flags, compute the cell id, and append each mover's slot
//      index to the B-slot buffer through an atomic counter.
//   2. gather (one thread per buffer entry): copy the mover's 15 planes
//      into the buffer and vacate its slot (aid = n, q = 0).
//   3. free   (one block per cell): a ballot scan over the cell's slots
//      lists its free slots in order and resets the arrival counter.
//   4. place  (one thread per buffer entry): atomicAdd on the target
//      cell's arrival counter gives the mover's rank; rank < free count
//      takes that free slot, anything else sets the sticky overflow flag.
//   5. stash  (fallback, one thread per slot): copy every slot to scratch
//      and clear the state to empty slots.
//   6. scatter (fallback): counting sort of the scratch back into the
//      state by atomic arrival rank; rank >= cap sets overflow.
// The full rebin is fill + scatter (with the wrap) from any number of
// entries into a fresh slot state.  Arrival order decides the slot inside
// a cell, so slot order is not deterministic; the engine and the tests
// compare in atom order only.
//
// What bounds it on the H100: memory traffic and launch latency.  The
// mark pass reads and writes the six position/image planes of every slot
// once; movers (a few % of slots per rebin) move 15 planes twice.  At
// 192k atoms that is a few MB per rebin, microseconds at 3.35 TB/s, so
// the six launches themselves are most of its time.
//
// Compiled with --fmad=false and without --use_fast_math: the division,
// floor and multiply of the wrap and the cell index round exactly like
// the plain torch version, so wrapped positions, images and cells agree
// bit for bit.  Templated on the slot-plane type (float or double).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kNf = 10;  // x y z vx vy vz fx fy fz q
constexpr int kNi = 5;   // ix iy iz typ aid
constexpr int kQ = 9;
constexpr int kAid = 4;
constexpr int kThreads = 256;
constexpr int kFreeThreads = 128;

template <typename T>
struct Planes {
  T* f[kNf];
  int* i[kNi];
};

template <typename T>
struct Geo {
  int n, ncx, ncy, ncz, cap, ncell, ns, B;
  T lo[3], L[3], scale[3];  // scale = nc / L, rounded once to T
};

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }

template <typename T>
__device__ __forceinline__ void wrap_axis(T& p, int& im, T lo, T L) {
  const T s = dev_floor((p - lo) / L);
  p = p - s * L;
  im = im + static_cast<int>(s);
}

template <typename T>
__device__ __forceinline__ int cell_axis(T p, T lo, T scale, int nc) {
  int c = static_cast<int>(dev_floor((p - lo) * scale));
  return c < 0 ? 0 : (c > nc - 1 ? nc - 1 : c);
}

template <typename T>
__device__ __forceinline__ int cell_of(const Geo<T>& g, T x, T y, T z) {
  return (cell_axis(x, g.lo[0], g.scale[0], g.ncx) * g.ncy +
          cell_axis(y, g.lo[1], g.scale[1], g.ncy)) *
             g.ncz +
         cell_axis(z, g.lo[2], g.scale[2], g.ncz);
}

template <typename T>
__device__ __forceinline__ void copy_entry(const Planes<T>& src, int s,
                                           const Planes<T>& dst, int d) {
#pragma unroll
  for (int k = 0; k < kNf; ++k) dst.f[k][d] = src.f[k][s];
#pragma unroll
  for (int k = 0; k < kNi; ++k) dst.i[k][d] = src.i[k][s];
}

template <typename T>
__device__ __forceinline__ void clear_entry(const Planes<T>& p, int s,
                                            int n) {
#pragma unroll
  for (int k = 0; k < kNf; ++k) p.f[k][s] = T(0);
#pragma unroll
  for (int k = 0; k < kNi; ++k) p.i[k][s] = 0;
  p.i[kAid][s] = n;
}

// 1. wrap + cell id + mover compaction.  cnt[0] counts every mover.
template <typename T>
__global__ void mark_kernel(Planes<T> P, Geo<T> g, int* cnt, int* cid,
                            int* buf_src) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= g.ns) return;
  T x = P.f[0][s], y = P.f[1][s], z = P.f[2][s];
  int ix = P.i[0][s], iy = P.i[1][s], iz = P.i[2][s];
  wrap_axis(x, ix, g.lo[0], g.L[0]);
  wrap_axis(y, iy, g.lo[1], g.L[1]);
  wrap_axis(z, iz, g.lo[2], g.L[2]);
  P.f[0][s] = x;
  P.f[1][s] = y;
  P.f[2][s] = z;
  P.i[0][s] = ix;
  P.i[1][s] = iy;
  P.i[2][s] = iz;
  const bool valid = P.i[kAid][s] < g.n;
  const int c = valid ? cell_of(g, x, y, z) : g.ncell;
  cid[s] = c;
  if (valid && c != s / g.cap) {
    const int m = atomicAdd(cnt, 1);
    if (m < g.B) buf_src[m] = s;
  }
}

// 2. mover payload -> buffer, then vacate the slot.
template <typename T>
__global__ void gather_kernel(Planes<T> P, Planes<T> buf, Geo<T> g,
                              const int* cnt, const int* cid,
                              const int* buf_src, int* buf_tgt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nm = *cnt;
  if (nm > g.B || t >= nm) return;
  const int s = buf_src[t];
  copy_entry(P, s, buf, t);
  buf_tgt[t] = cid[s];
  P.i[kAid][s] = g.n;
  P.f[kQ][s] = T(0);
}

// 3. per-cell free-slot table (free slots in slot order) + arrival reset.
__global__ void free_kernel(const int* aid, int n, int cap, int B,
                            const int* cnt, int* free_count, int* free_pos,
                            int* arrival) {
  if (*cnt > B) return;
  __shared__ int warp_tot[kFreeThreads / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int j0 = 0; j0 < cap; j0 += kFreeThreads) {
    const int j = j0 + tid;
    const bool f = j < cap && aid[c * cap + j] >= n;
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(b);
    __syncthreads();
    int off = base;
    for (int w = 0; w < warp; ++w) off += warp_tot[w];
    if (f) free_pos[c * cap + off + __popc(b & ((1u << lane) - 1u))] = j;
    for (int w = 0; w < kFreeThreads / 32; ++w) base += warp_tot[w];
    __syncthreads();
  }
  if (tid == 0) {
    free_count[c] = base;
    arrival[c] = 0;
  }
}

// 4. place each mover into the next free slot of its cell.
template <typename T>
__global__ void place_kernel(Planes<T> P, Planes<T> buf, Geo<T> g,
                             const int* cnt, const int* buf_tgt,
                             int* arrival, const int* free_count,
                             const int* free_pos, bool* overflow) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nm = *cnt;
  if (nm > g.B || t >= nm) return;
  const int c = buf_tgt[t];
  const int r = atomicAdd(&arrival[c], 1);
  if (r >= free_count[c]) {
    *overflow = true;
    return;
  }
  copy_entry(buf, t, P, c * g.cap + free_pos[c * g.cap + r]);
}

// 5. fallback: state -> scratch, state cleared to empty slots.
template <typename T>
__global__ void stash_kernel(Planes<T> P, Planes<T> scr, Geo<T> g,
                             const int* cnt, const int* cid, int* scr_cid,
                             int* arrival) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (*cnt <= g.B || s >= g.ns) return;
  copy_entry(P, s, scr, s);
  scr_cid[s] = cid[s];
  clear_entry(P, s, g.n);
  if (s < g.ncell) arrival[s] = 0;
}

// Full rebin, first pass: fresh empty slot state + arrival reset.
template <typename T>
__global__ void fill_kernel(Planes<T> out, Geo<T> g, int* arrival) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < g.ns) clear_entry(out, s, g.n);
  if (s < g.ncell) arrival[s] = 0;
}

// 6. / full rebin: counting sort of m entries into out by arrival rank.
// cid_in == nullptr: wrap each entry and compute its cell here.
// gate != nullptr: run only on the fallback path (mover count > B).
template <typename T>
__global__ void scatter_kernel(Planes<T> in, Planes<T> out, int m, Geo<T> g,
                               const int* gate, const int* cid_in,
                               int* arrival, bool* overflow) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m || (gate != nullptr && *gate <= g.B)) return;
  const int a = in.i[kAid][s];
  if (a >= g.n) return;
  T x = in.f[0][s], y = in.f[1][s], z = in.f[2][s];
  int ix = in.i[0][s], iy = in.i[1][s], iz = in.i[2][s];
  int c;
  if (cid_in != nullptr) {
    c = cid_in[s];
  } else {
    wrap_axis(x, ix, g.lo[0], g.L[0]);
    wrap_axis(y, iy, g.lo[1], g.L[1]);
    wrap_axis(z, iz, g.lo[2], g.L[2]);
    c = cell_of(g, x, y, z);
  }
  const int r = atomicAdd(&arrival[c], 1);
  if (r >= g.cap) {
    *overflow = true;
    return;
  }
  const int d = c * g.cap + r;
  copy_entry(in, s, out, d);
  out.f[0][d] = x;
  out.f[1][d] = y;
  out.f[2][d] = z;
  out.i[0][d] = ix;
  out.i[1][d] = iy;
  out.i[2][d] = iz;
}

template <typename T>
Planes<T> planes(void* const* f, void* const* i) {
  Planes<T> p;
  for (int k = 0; k < kNf; ++k) p.f[k] = static_cast<T*>(f[k]);
  for (int k = 0; k < kNi; ++k) p.i[k] = static_cast<int*>(i[k]);
  return p;
}

template <typename T>
Geo<T> geo(int n, int ncx, int ncy, int ncz, int cap, int B,
           const double* lo, const double* L) {
  Geo<T> g;
  g.n = n;
  g.ncx = ncx;
  g.ncy = ncy;
  g.ncz = ncz;
  g.cap = cap;
  g.ncell = ncx * ncy * ncz;
  g.ns = g.ncell * cap;
  g.B = B;
  const int nc[3] = {ncx, ncy, ncz};
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = static_cast<T>(lo[a]);
    g.L[a] = static_cast<T>(L[a]);
    g.scale[a] = static_cast<T>(nc[a] / L[a]);
  }
  return g;
}

inline int blocks(int m) { return m > 0 ? (m + kThreads - 1) / kThreads : 1; }

// work: int32 scratch [cnt(4) | cid(ns) | buf_src(B) | buf_tgt(B) |
//   arrival(ncell) | free_count(ncell) | free_pos(ns) | scr_cid(ns)]
template <typename T>
int incremental(void* const* sf, void* const* si, void* const* bf,
                void* const* bi, void* const* cf, void* const* ci, int n,
                int ncx, int ncy, int ncz, int cap, int B, const double* lo,
                const double* L, int* work, bool* overflow,
                cudaStream_t stream) {
  const Geo<T> g = geo<T>(n, ncx, ncy, ncz, cap, B, lo, L);
  const Planes<T> P = planes<T>(sf, si), buf = planes<T>(bf, bi),
                  scr = planes<T>(cf, ci);
  int* cnt = work;
  int* cid = cnt + 4;
  int* buf_src = cid + g.ns;
  int* buf_tgt = buf_src + B;
  int* arrival = buf_tgt + B;
  int* free_count = arrival + g.ncell;
  int* free_pos = free_count + g.ncell;
  int* scr_cid = free_pos + g.ns;
  cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  mark_kernel<T><<<blocks(g.ns), kThreads, 0, stream>>>(P, g, cnt, cid,
                                                        buf_src);
  gather_kernel<T><<<blocks(B), kThreads, 0, stream>>>(P, buf, g, cnt, cid,
                                                       buf_src, buf_tgt);
  free_kernel<<<g.ncell, kFreeThreads, 0, stream>>>(
      P.i[kAid], n, cap, B, cnt, free_count, free_pos, arrival);
  place_kernel<T><<<blocks(B), kThreads, 0, stream>>>(
      P, buf, g, cnt, buf_tgt, arrival, free_count, free_pos, overflow);
  stash_kernel<T><<<blocks(g.ns), kThreads, 0, stream>>>(P, scr, g, cnt, cid,
                                                         scr_cid, arrival);
  scatter_kernel<T><<<blocks(g.ns), kThreads, 0, stream>>>(
      scr, P, g.ns, g, cnt, scr_cid, arrival, overflow);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int full(void* const* inf, void* const* ini, int m, void* const* outf,
         void* const* outi, int n, int ncx, int ncy, int ncz, int cap,
         const double* lo, const double* L, int* arrival, bool* overflow,
         cudaStream_t stream) {
  const Geo<T> g = geo<T>(n, ncx, ncy, ncz, cap, 0, lo, L);
  const Planes<T> in = planes<T>(inf, ini), out = planes<T>(outf, outi);
  const int nfill = g.ns > g.ncell ? g.ns : g.ncell;
  fill_kernel<T><<<blocks(nfill), kThreads, 0, stream>>>(out, g, arrival);
  scatter_kernel<T><<<blocks(m), kThreads, 0, stream>>>(
      in, out, m, g, nullptr, nullptr, arrival, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_double: slot planes are double (else float).  Plane order: floats
// x y z vx vy vz fx fy fz q; ints ix iy iz typ aid.  lo, L: (3,) doubles.
// The state (sf, si) is updated in place; bf/bi are B-entry buffer
// planes, cf/ci ns-entry fallback scratch planes.
extern "C" int rebin_incremental(int is_double, void* const* sf,
                                 void* const* si, void* const* bf,
                                 void* const* bi, void* const* cf,
                                 void* const* ci, int n, int ncx, int ncy,
                                 int ncz, int cap, int B, const double* lo,
                                 const double* L, int* work, bool* overflow,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? incremental<double>(sf, si, bf, bi, cf, ci, n, ncx, ncy,
                                         ncz, cap, B, lo, L, work, overflow, s)
                   : incremental<float>(sf, si, bf, bi, cf, ci, n, ncx, ncy,
                                        ncz, cap, B, lo, L, work, overflow, s);
}

// Full rebin of m entries (in) into a fresh ncell*cap slot state (out).
// arrival: int32 scratch of ncell entries.
extern "C" int rebin_full(int is_double, void* const* inf, void* const* ini,
                          int m, void* const* outf, void* const* outi, int n,
                          int ncx, int ncy, int ncz, int cap,
                          const double* lo, const double* L, int* arrival,
                          bool* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? full<double>(inf, ini, m, outf, outi, n, ncx, ncy, ncz,
                                  cap, lo, L, arrival, overflow, s)
                   : full<float>(inf, ini, m, outf, outi, n, ncx, ncy, ncz,
                                 cap, lo, L, arrival, overflow, s);
}
