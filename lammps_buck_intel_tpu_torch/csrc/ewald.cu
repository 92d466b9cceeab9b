// Ewald reciprocal-space sum on a static box (sm_90a): K11a ewald_sk,
// K11b ewald_force and the per-atom energy and virial K11pa
// ewald_peratom.
//
// Replaces: lammps_buck_intel_tpu/models/kspace/ewald.py
//   _ewald_compute (:185): phase = x @ kv^T, c = cos(phase), s =
//   sin(phase), S(k) = (sum_i q_i c_ik, sum_i q_i s_ik) in acc;
//   sk_force_energy_virial (:135): E = qqrd2e sum_k ug_k |S(k)|^2 (plus the
//   host's self and background terms), the 6-virial sum_k uk vfac_ab(k)
//   with uk = ug_k |S(k)|^2 qqrd2e and vfac = 1 - pref k_a k_b (diagonal)
//   or -pref k_a k_b, pref = 2 (1/k^2 + 1/(4 g^2)); forces f_i = qqrd2e
//   q_i sum_k 2 ug_k (s_ik Re_k - c_ik Im_k) k;
//   ewald_compute_peratom (:261): share_ik = c_ik Re_k + s_ik Im_k (Re, Im
//   rounded to flt), eatom_i = qqrd2e (q_i sum_k ug_k share_ik - g/sqrt(pi)
//   q_i^2 - pi/(2 g^2 V) q_i qsum), vatom_i,c = qqrd2e q_i sum_k ug_k
//   vfac_c(k) share_ik.
//
// Design.  The JAX package keeps (N, K) phase, cos and sin arrays and
// contracts them on the matrix unit; at 11,520 atoms and 31,248 k vectors
// one such f32 array is 1.44 GB.  Here nothing of size N * K is stored:
//   K11a (ewald_sk): one thread per k vector, the atoms streamed through
//     shared memory in tiles of (x, y, z, q); Re and Im stay in registers.
//     The atoms are split into nsplit ranges (gridDim.y) so that a small K
//     still fills the card; each range writes its partial sums, and a
//     second kernel adds the ranges in a fixed order, writes S(k) and the
//     force weights wre = 2 ug Re, wim = 2 ug Im in flt, and reduces the
//     energy and virial terms per block in a fixed shuffle tree into
//     sums[block][7] = (sum ug |S|^2, six virial sums); the caller adds the
//     block rows.  Deterministic: no atomics.
//   K11b (ewald_force): one thread per atom, the k vectors streamed through
//     shared memory in tiles of (kx, ky, kz, wre, wim), sin and cos of the
//     phase recomputed rather than stored.  At 11,520 atoms 128-thread
//     blocks give only 90 blocks for 132 SMs, so the k vectors are split
//     into nsplit ranges (gridDim.y, chosen by the wrapper for about four
//     blocks an SM); a second kernel adds the ranges in a fixed order and
//     scales by qqrd2e q_i.
//   K11pa (ewald_peratom): K11b's shape.  One thread per atom, the k
//     vectors staged in tiles of (kx, ky, kz, Re, Im and the seven weights
//     ug, ug vfac_c), seven acc sums a thread, the k vectors split into
//     nsplit ranges; a finish kernel adds the ranges in a fixed order and
//     applies q_i, the self and background terms and qqrd2e.  S(k) comes
//     from K11a.
//   K11 traced (ewald_traced): under fix npt (models/kspace/ewald.py
//     _ewald_compute_traced, :200-260) the m triples stay fixed at set-up
//     and the tables follow the box on the card: one thread per k vector
//     builds k = 2 pi m / L, |k|^2, ug = (2 pi / V) exp(-k^2 / 4 g^2) / k^2
//     and the six virial factors from boxL, in the JAX package's order of
//     operations, into the rows K11a and K11b read (kx, ky, kz, ug in flt;
//     ug and vfac in acc); K11a and K11b then run unchanged.  Bytes bound:
//     3 K flt in, 4 K flt and 7 K acc out, a few microseconds.
// Phase precision: |k . x| reaches 2 pi kmax ~ 160 rad, so the phase is
// reduced by the accurate sincosf / sincos (no --use_fast_math, no
// __sincosf, whose error grows with the argument).
//
// What bounds it on the H100.  Operations: every (atom, k) pair costs the
// phase (3 multiplies, 2 adds), a sine and a cosine with their argument
// reduction (tens of instructions, the bulk of the time), and 4 (K11a) or
// 9 (K11b) accumulate operations; bytes are O(N + K).  Faster forms (the
// phase product on tensor cores, the recurrence e^{i(m+1)k1.x} =
// e^{imk1.x} e^{ik1.x} per axis to drop most transcendentals) are later
// work; these are the simple correct kernels.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double).  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAtomTile = 256;  // K11a: atoms staged per tile
constexpr int kKTile = 128;     // K11b: k vectors staged per tile

__device__ __forceinline__ void dev_sincos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void dev_sincos(double a, double* s, double* c) {
  sincos(a, s, c);
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// part_re / part_im[split][K]: the sums over atoms [split * chunk, ...).
template <typename T, typename A>
__global__ void sk_partial_kernel(const T* __restrict__ x,
                                  const T* __restrict__ y,
                                  const T* __restrict__ z,
                                  const T* __restrict__ q, int n,
                                  const T* __restrict__ kx,
                                  const T* __restrict__ ky,
                                  const T* __restrict__ kz, int K, int chunk,
                                  A* __restrict__ part_re,
                                  A* __restrict__ part_im) {
  __shared__ T sx[kAtomTile], sy[kAtomTile], sz[kAtomTile], sq[kAtomTile];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int a0 = blockIdx.y * chunk;
  const int a1 = min(n, a0 + chunk);
  T kxk = 0, kyk = 0, kzk = 0;
  if (k < K) {
    kxk = kx[k];
    kyk = ky[k];
    kzk = kz[k];
  }
  A re = 0, im = 0;
  for (int t0 = a0; t0 < a1; t0 += kAtomTile) {
    const int m = min(kAtomTile, a1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      sx[j] = x[t0 + j];
      sy[j] = y[t0 + j];
      sz[j] = z[t0 + j];
      sq[j] = q[t0 + j];
    }
    __syncthreads();
    if (k < K) {
      for (int j = 0; j < m; ++j) {
        const T ph = sx[j] * kxk + sy[j] * kyk + sz[j] * kzk;
        T s, c;
        dev_sincos(ph, &s, &c);
        re += static_cast<A>(sq[j] * c);
        im += static_cast<A>(sq[j] * s);
      }
    }
  }
  if (k < K) {
    part_re[static_cast<size_t>(blockIdx.y) * K + k] = re;
    part_im[static_cast<size_t>(blockIdx.y) * K + k] = im;
  }
}

// S(k) from the partials (splits added in order), the force weights, and
// the energy / virial terms reduced per block into sums[block][7].
template <typename T, typename A>
__global__ void sk_finish_kernel(const A* __restrict__ part_re,
                                 const A* __restrict__ part_im, int nsplit,
                                 int K, const T* __restrict__ ug,
                                 const A* __restrict__ ug_acc,
                                 const A* __restrict__ vfac, A qqrd2e,
                                 A* __restrict__ s_re, A* __restrict__ s_im,
                                 T* __restrict__ wre, T* __restrict__ wim,
                                 A* __restrict__ sums) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[7] = {0, 0, 0, 0, 0, 0, 0};
  if (k < K) {
    A re = 0, im = 0;
    for (int p = 0; p < nsplit; ++p) {
      re += part_re[static_cast<size_t>(p) * K + k];
      im += part_im[static_cast<size_t>(p) * K + k];
    }
    s_re[k] = re;
    s_im[k] = im;
    const T w = T(2) * ug[k];
    wre[k] = w * static_cast<T>(re);
    wim[k] = w * static_cast<T>(im);
    const A e = ug_acc[k] * (re * re + im * im);
    const A uk = e * qqrd2e;
    vals[0] = e;
#pragma unroll
    for (int c = 0; c < 6; ++c) vals[1 + c] = uk * vfac[c * K + k];
  }
  __shared__ A red[kThreads / 32][7];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    const A s = warp_sum(vals[c]);
    if (lane == 0) red[warp][c] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const A s = warp_sum(lane < kThreads / 32 ? red[lane][c] : A(0));
      if (lane == 0) sums[blockIdx.x * 7 + c] = s;
    }
  }
}

// part[split][3][n]: each atom's force sum over k vectors [split * chunk,
// ...), before the factor qqrd2e q_i.
template <typename T, typename A>
__global__ void force_partial_kernel(const T* __restrict__ x,
                                     const T* __restrict__ y,
                                     const T* __restrict__ z, int n,
                                     const T* __restrict__ kx,
                                     const T* __restrict__ ky,
                                     const T* __restrict__ kz,
                                     const T* __restrict__ wre,
                                     const T* __restrict__ wim, int K,
                                     int chunk, A* __restrict__ part) {
  __shared__ T skx[kKTile], sky[kKTile], skz[kKTile], sa[kKTile],
      sb[kKTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(K, k0 + chunk);
  T xi = 0, yi = 0, zi = 0;
  if (i < n) {
    xi = x[i];
    yi = y[i];
    zi = z[i];
  }
  A fx = 0, fy = 0, fz = 0;
  for (int t0 = k0; t0 < k1; t0 += kKTile) {
    const int m = min(kKTile, k1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      skx[j] = kx[t0 + j];
      sky[j] = ky[t0 + j];
      skz[j] = kz[t0 + j];
      sa[j] = wre[t0 + j];
      sb[j] = wim[t0 + j];
    }
    __syncthreads();
    if (i < n) {
      for (int j = 0; j < m; ++j) {
        const T ph = xi * skx[j] + yi * sky[j] + zi * skz[j];
        T s, c;
        dev_sincos(ph, &s, &c);
        const T coef = s * sa[j] - c * sb[j];
        fx += static_cast<A>(coef * skx[j]);
        fy += static_cast<A>(coef * sky[j]);
        fz += static_cast<A>(coef * skz[j]);
      }
    }
  }
  if (i < n) {
    const size_t base = static_cast<size_t>(blockIdx.y) * 3 * n + i;
    part[base] = fx;
    part[base + n] = fy;
    part[base + 2 * static_cast<size_t>(n)] = fz;
  }
}

template <typename T, typename A>
__global__ void force_finish_kernel(const A* __restrict__ part, int nsplit,
                                    int n, const T* __restrict__ q, T qqrd2e,
                                    A* __restrict__ fx, A* __restrict__ fy,
                                    A* __restrict__ fz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  A sx = 0, sy = 0, sz = 0;
  for (int p = 0; p < nsplit; ++p) {
    const size_t base = static_cast<size_t>(p) * 3 * n + i;
    sx += part[base];
    sy += part[base + n];
    sz += part[base + 2 * static_cast<size_t>(n)];
  }
  const A s = static_cast<A>(qqrd2e * q[i]);
  fx[i] = s * sx;
  fy[i] = s * sy;
  fz[i] = s * sz;
}

// part[split][7][n]: each atom's seven sums over k vectors [split * chunk,
// ...): sum_k w_m(k) (c_ik Re_k + s_ik Im_k), w = (ug, ug vfac_c).
template <typename T, typename A>
__global__ void peratom_partial_kernel(const T* __restrict__ x,
                                       const T* __restrict__ y,
                                       const T* __restrict__ z, int n,
                                       const T* __restrict__ kx,
                                       const T* __restrict__ ky,
                                       const T* __restrict__ kz,
                                       const T* __restrict__ re,
                                       const T* __restrict__ im,
                                       const T* __restrict__ w, int K,
                                       int chunk, A* __restrict__ part) {
  __shared__ T skx[kKTile], sky[kKTile], skz[kKTile], sre[kKTile],
      sim[kKTile], sw[7][kKTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(K, k0 + chunk);
  T xi = 0, yi = 0, zi = 0;
  if (i < n) {
    xi = x[i];
    yi = y[i];
    zi = z[i];
  }
  A acc[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int t0 = k0; t0 < k1; t0 += kKTile) {
    const int m = min(kKTile, k1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      skx[j] = kx[t0 + j];
      sky[j] = ky[t0 + j];
      skz[j] = kz[t0 + j];
      sre[j] = re[t0 + j];
      sim[j] = im[t0 + j];
#pragma unroll
      for (int v = 0; v < 7; ++v)
        sw[v][j] = w[static_cast<size_t>(v) * K + t0 + j];
    }
    __syncthreads();
    if (i < n) {
      for (int j = 0; j < m; ++j) {
        const T ph = xi * skx[j] + yi * sky[j] + zi * skz[j];
        T s, c;
        dev_sincos(ph, &s, &c);
        const T share = c * sre[j] + s * sim[j];
#pragma unroll
        for (int v = 0; v < 7; ++v)
          acc[v] += static_cast<A>(share * sw[v][j]);
      }
    }
  }
  if (i < n) {
    const size_t base = static_cast<size_t>(blockIdx.y) * 7 * n + i;
#pragma unroll
    for (int v = 0; v < 7; ++v)
      part[base + static_cast<size_t>(v) * n] = acc[v];
  }
}

template <typename T, typename A>
__global__ void peratom_finish_kernel(const A* __restrict__ part,
                                      int nsplit, int n,
                                      const T* __restrict__ q, A qqrd2e,
                                      A self_c, A bg_c, A qsum,
                                      A* __restrict__ eatom,
                                      A* __restrict__ vatom) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  A s[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int p = 0; p < nsplit; ++p) {
    const size_t base = static_cast<size_t>(p) * 7 * n + i;
#pragma unroll
    for (int v = 0; v < 7; ++v)
      s[v] += part[base + static_cast<size_t>(v) * n];
  }
  const A qi = static_cast<A>(q[i]);
  eatom[i] = (qi * s[0] - (self_c * qi * qi + bg_c * qi * qsum)) * qqrd2e;
  A* vi = vatom + static_cast<size_t>(i) * 6;
#pragma unroll
  for (int v = 0; v < 6; ++v) vi[v] = (qi * s[v + 1]) * qqrd2e;
}

inline int blocks_for(int m) { return (m + kThreads - 1) / kThreads; }

template <typename T, typename A>
int launch_sk(const void* x, const void* y, const void* z, const void* q,
              int n, const void* kx, const void* ky, const void* kz,
              const void* ug, const void* ug_acc, const void* vfac, int K,
              int nsplit, double qqrd2e, void* part, void* s, void* w,
              void* sums, cudaStream_t st) {
  A* part_re = static_cast<A*>(part);
  A* part_im = part_re + static_cast<size_t>(nsplit) * K;
  const int chunk = (n + nsplit - 1) / nsplit;
  sk_partial_kernel<T, A><<<dim3(blocks_for(K), nsplit), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(q), n,
      static_cast<const T*>(kx), static_cast<const T*>(ky),
      static_cast<const T*>(kz), K, chunk, part_re, part_im);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  A* s_re = static_cast<A*>(s);
  T* wre = static_cast<T*>(w);
  sk_finish_kernel<T, A><<<blocks_for(K), kThreads, 0, st>>>(
      part_re, part_im, nsplit, K, static_cast<const T*>(ug),
      static_cast<const A*>(ug_acc), static_cast<const A*>(vfac),
      static_cast<A>(qqrd2e), s_re, s_re + K, wre, wre + K,
      static_cast<A*>(sums));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_force(const void* x, const void* y, const void* z, const void* q,
                 int n, const void* kx, const void* ky, const void* kz,
                 const void* wre, const void* wim, int K, int nsplit,
                 double qqrd2e, void* part, void* fx, void* fy, void* fz,
                 cudaStream_t st) {
  const int chunk = (K + nsplit - 1) / nsplit;
  force_partial_kernel<T, A>
      <<<dim3(blocks_for(n), nsplit), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(z), n, static_cast<const T*>(kx),
          static_cast<const T*>(ky), static_cast<const T*>(kz),
          static_cast<const T*>(wre), static_cast<const T*>(wim), K, chunk,
          static_cast<A*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  force_finish_kernel<T, A><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const A*>(part), nsplit, n, static_cast<const T*>(q),
      static_cast<T>(qqrd2e), static_cast<A*>(fx), static_cast<A*>(fy),
      static_cast<A*>(fz));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_peratom(const void* x, const void* y, const void* z,
                   const void* q, int n, const void* kx, const void* ky,
                   const void* kz, const void* re, const void* im,
                   const void* w, int K, int nsplit, double qqrd2e,
                   double self_c, double bg_c, double qsum, void* part,
                   void* eatom, void* vatom, cudaStream_t st) {
  const int chunk = (K + nsplit - 1) / nsplit;
  peratom_partial_kernel<T, A>
      <<<dim3(blocks_for(n), nsplit), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(z), n, static_cast<const T*>(kx),
          static_cast<const T*>(ky), static_cast<const T*>(kz),
          static_cast<const T*>(re), static_cast<const T*>(im),
          static_cast<const T*>(w), K, chunk, static_cast<A*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peratom_finish_kernel<T, A><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const A*>(part), nsplit, n, static_cast<const T*>(q),
      static_cast<A>(qqrd2e), static_cast<A>(self_c), static_cast<A>(bg_c),
      static_cast<A>(qsum), static_cast<A*>(eatom), static_cast<A*>(vatom));
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float dev_exp(float a) { return expf(a); }
__device__ __forceinline__ double dev_exp(double a) { return exp(a); }

// K11 traced: the tables of the box boxL (3 lengths on the card).  m: (3,
// K) flt rows of the integer triples; kv: (3, K) flt rows out; ug: (K,)
// flt; ug_acc: (K,) acc; vfac: (6, K) acc.
template <typename T, typename A>
__global__ void traced_tables_kernel(const T* __restrict__ m, int K,
                                     const T* __restrict__ boxL, T four_g2,
                                     T quarter_g2inv, T* __restrict__ kv,
                                     T* __restrict__ ug,
                                     A* __restrict__ ug_acc,
                                     A* __restrict__ vfac) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const T two_pi = static_cast<T>(6.283185307179586476925286766559);
  const T lx = boxL[0], ly = boxL[1], lz = boxL[2];
  const T kx = (two_pi * m[k]) / lx;
  const T ky = (two_pi * m[K + k]) / ly;
  const T kz = (two_pi * m[2 * K + k]) / lz;
  const T ksq = kx * kx + ky * ky + kz * kz;
  const T vol = lx * ly * lz;
  const T u = two_pi / vol * dev_exp(-ksq / four_g2) / ksq;
  const T pref = T(2) * (T(1) / ksq + quarter_g2inv);
  kv[k] = kx;
  kv[K + k] = ky;
  kv[2 * K + k] = kz;
  ug[k] = u;
  ug_acc[k] = static_cast<A>(u);
  vfac[k] = static_cast<A>(T(1) - pref * kx * kx);
  vfac[K + k] = static_cast<A>(T(1) - pref * ky * ky);
  vfac[2 * K + k] = static_cast<A>(T(1) - pref * kz * kz);
  vfac[3 * K + k] = static_cast<A>(-pref * kx * ky);
  vfac[4 * K + k] = static_cast<A>(-pref * kx * kz);
  vfac[5 * K + k] = static_cast<A>(-pref * ky * kz);
}

}  // namespace

// K11 traced.  prec as in ewald_sk; m: (3, K) flt rows of the m triples;
// boxL: 3 flt lengths on the card; g2: g_ewald^2.  Outputs kv (3, K) flt,
// ug (K) flt, ug_acc (K) acc, vfac (6, K) acc.
extern "C" int ewald_traced(int prec, const void* m, int K, const void* boxL,
                            double g2, void* kv, void* ug, void* ug_acc,
                            void* vfac, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || g2 <= 0.0) return static_cast<int>(cudaErrorInvalidValue);
#define TRACED(T, A)                                                         \
  traced_tables_kernel<T, A><<<blocks_for(K), kThreads, 0, st>>>(            \
      static_cast<const T*>(m), K, static_cast<const T*>(boxL),              \
      static_cast<T>(4.0 * g2), static_cast<T>(0.25 / g2),                   \
      static_cast<T*>(kv), static_cast<T*>(ug), static_cast<A*>(ug_acc),     \
      static_cast<A*>(vfac))
  switch (prec) {
    case 0: TRACED(float, float); break;
    case 1: TRACED(float, double); break;
    case 2: TRACED(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRACED
  return static_cast<int>(cudaGetLastError());
}

// Rows of ewald_sk's sums (one per block of k vectors).
extern "C" int ewald_sum_rows(int K) { return blocks_for(K); }

// K11a.  prec: 0 = (float, float), 1 = (float, double), 2 = (double,
// double).  x, y, z, q: (n,) flt; kx, ky, kz, ug: (K,) flt; ug_acc: (K,)
// acc; vfac: (6, K) acc.  Scratch part: (2, nsplit, K) acc.  Outputs s:
// (2, K) acc (Re, Im), w: (2, K) flt (2 ug Re, 2 ug Im), sums:
// (ewald_sum_rows(K), 7) acc.
extern "C" int ewald_sk(int prec, const void* x, const void* y,
                        const void* z, const void* q, int n, const void* kx,
                        const void* ky, const void* kz, const void* ug,
                        const void* ug_acc, const void* vfac, int K,
                        int nsplit, double qqrd2e, void* part, void* s,
                        void* w, void* sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || K <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (prec) {
    case 0:
      return launch_sk<float, float>(x, y, z, q, n, kx, ky, kz, ug, ug_acc,
                                     vfac, K, nsplit, qqrd2e, part, s, w,
                                     sums, st);
    case 1:
      return launch_sk<float, double>(x, y, z, q, n, kx, ky, kz, ug, ug_acc,
                                      vfac, K, nsplit, qqrd2e, part, s, w,
                                      sums, st);
    case 2:
      return launch_sk<double, double>(x, y, z, q, n, kx, ky, kz, ug,
                                       ug_acc, vfac, K, nsplit, qqrd2e,
                                       part, s, w, sums, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K11b.  wre, wim: (K,) flt from ewald_sk.  Scratch part: (nsplit, 3, n)
// acc.  Outputs fx, fy, fz: (n,) acc.
extern "C" int ewald_force(int prec, const void* x, const void* y,
                           const void* z, const void* q, int n,
                           const void* kx, const void* ky, const void* kz,
                           const void* wre, const void* wim, int K,
                           int nsplit, double qqrd2e, void* part, void* fx,
                           void* fy, void* fz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || K <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (prec) {
    case 0:
      return launch_force<float, float>(x, y, z, q, n, kx, ky, kz, wre, wim,
                                        K, nsplit, qqrd2e, part, fx, fy, fz,
                                        st);
    case 1:
      return launch_force<float, double>(x, y, z, q, n, kx, ky, kz, wre, wim,
                                         K, nsplit, qqrd2e, part, fx, fy, fz,
                                         st);
    case 2:
      return launch_force<double, double>(x, y, z, q, n, kx, ky, kz, wre,
                                          wim, K, nsplit, qqrd2e, part, fx,
                                          fy, fz, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K11pa.  re, im: (K,) flt, S(k) from ewald_sk rounded to flt; w: (7, K)
// flt, ug and the six ug vfac_c.  Scratch part: (nsplit, 7, n) acc.
// Outputs eatom (n) and vatom (n, 6) acc; self_c = g / sqrt(pi), bg_c =
// pi / (2 g^2 V).
extern "C" int ewald_peratom(int prec, const void* x, const void* y,
                             const void* z, const void* q, int n,
                             const void* kx, const void* ky, const void* kz,
                             const void* re, const void* im, const void* w,
                             int K, int nsplit, double qqrd2e, double self_c,
                             double bg_c, double qsum, void* part,
                             void* eatom, void* vatom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || K <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define PERATOM_ARGS                                                       \
  x, y, z, q, n, kx, ky, kz, re, im, w, K, nsplit, qqrd2e, self_c, bg_c,   \
      qsum, part, eatom, vatom, st
  switch (prec) {
    case 0: return launch_peratom<float, float>(PERATOM_ARGS);
    case 1: return launch_peratom<float, double>(PERATOM_ARGS);
    case 2: return launch_peratom<double, double>(PERATOM_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PERATOM_ARGS
}
