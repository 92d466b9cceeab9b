// The variable-cell (fix npt) kernels over atom-order planes (sm_90a): the
// traced influence function (traced_greens) and the barostat's per-atom
// passes (npt_ke3, npt_vscale_kick, npt_drift_dilate).
//
// Replaces:
//   traced_greens    <- lammps_buck_intel_tpu/models/kspace/pppm_npt.py
//                       TracedPPPM.tables (:202), the Hockney-Eastwood ik
//                       influence function rebuilt from the traced box once
//                       per neighbor block;
//   npt_ke3          <- integrate/npt.py _press_current (:442), per-axis
//                       sum m v_a^2;
//   npt_vscale_kick  <- npt.py _press_vscale (:553) and the half kick
//                       (:575-578, :612, :619);
//   npt_drift_dilate <- npt.py _one_step's drift and dilation about the
//                       fixed centre (:579-594).
// XLA lowered these for the TPU as broadcast elementwise code (the alias
// sum as 125 fused passes over the mesh).
//
// The box lives on the card and changes every step, so every kernel reads
// it (or what derives from it) from device memory: boxL (3) flt, the
// velocity factors vfac (3) and the dilation s (3) = exp(dt omega_dot),
// both computed by the caller as 0-d/(3,) tensor operations on the card,
// so no value comes to the host inside a block.
//
// traced_greens.  One thread per point (l, j, k) of the FULL (nx, ny, nz)
// mesh (the JAX package's shape; the spectral kernel reads the rfft half).
// k_a = m_a (2 pi / L_a) from the box; the alias sum over S^3 (S = 2
// nalias + 1 = 5: 125 terms) of u2x u2y u2z g(k_m) (k . k_m), g(k) = 4 pi /
// k^2 exp(-k^2 / 4 g_ewald^2) (0 at k = 0), over k^2 den^2, in acc, in the
// JAX loop order.  The box-independent statics (folded and alias-shifted
// harmonics ms, squared spline transforms u2, the (nx, ny, nz) squared
// denominator) are uploaded once.  Bound: operations, ~125 x 25 per point
// with an exp each (at a 144^2 x 96 mesh ~6.2e9 operations: ~0.1 ms f32).
//
// npt_ke3, npt_vscale_kick, npt_drift_dilate.  One thread per atom; bytes
// bound (a few planes read and written: ~1-3 MB at 248,832 atoms f32).
// npt_ke3 reduces (m v_a) v_a per axis in acc through a fixed shuffle tree
// into partial[block][3]; the caller sums the partials.  npt_vscale_kick:
// v_a <- v_a vfac_a (+ (dtf / m) f_a when f is given).  npt_drift_dilate:
// x_a <- c_a + ((x_a + dt v_a) - c_a) s_a.  Each product and sum rounds
// separately, in the JAX order (the library is built with --fmad=false),
// so the kernels equal their plain torch versions.
//
// Precision: flt T (float or double) for the planes, acc A for the sums
// and the influence function.  Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ---- K16a: the influence function from the traced box ----
template <typename T, typename A>
__global__ void traced_greens_kernel(const A* __restrict__ msx,
                                     const A* __restrict__ msy,
                                     const A* __restrict__ msz,
                                     const A* __restrict__ u2x,
                                     const A* __restrict__ u2y,
                                     const A* __restrict__ u2z,
                                     const A* __restrict__ den_sq,
                                     const T* __restrict__ boxL, int nx,
                                     int ny, int nz, int S, int mid, A g2,
                                     A* __restrict__ G) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nx * ny * nz) return;
  const int k = p % nz;
  const int j = (p / nz) % ny;
  const int l = p / (nz * ny);
  const A cx = static_cast<A>(2.0 * kPi) / static_cast<A>(boxL[0]);
  const A cy = static_cast<A>(2.0 * kPi) / static_cast<A>(boxL[1]);
  const A cz = static_cast<A>(2.0 * kPi) / static_cast<A>(boxL[2]);
  // unshifted folded harmonics: alias shift 0 is row `mid` of ms
  const A kx = msx[mid * nx + l] * cx;
  const A ky = msy[mid * ny + j] * cy;
  const A kz = msz[mid * nz + k] * cz;
  const A ksq = kx * kx + ky * ky + kz * kz;
  A num = 0;
  for (int sx = 0; sx < S; ++sx) {
    const A ux = u2x[sx * nx + l];
    const A kmx = msx[sx * nx + l] * cx;
    for (int sy = 0; sy < S; ++sy) {
      const A uy = u2y[sy * ny + j];
      const A kmy = msy[sy * ny + j] * cy;
      for (int sz = 0; sz < S; ++sz) {
        const A uz = u2z[sz * nz + k];
        const A kmz = msz[sz * nz + k] * cz;
        const A kmsq = kmx * kmx + kmy * kmy + kmz * kmz;
        const A safe = kmsq == A(0) ? A(1) : kmsq;
        const A g = kmsq == A(0)
                        ? A(0)
                        : (static_cast<A>(4.0 * kPi) / safe) *
                              dev_exp((A(-0.25) * safe) / g2);
        const A kdot = kx * kmx + ky * kmy + kz * kmz;
        num = num + ((ux * uy) * uz) * g * kdot;
      }
    }
  }
  const A ksq_safe = ksq == A(0) ? A(1) : ksq;
  const A v = num / (ksq_safe * den_sq[p]);
  G[p] = p == 0 ? A(0) : v;
}

// ---- K16c: per-axis kinetic sums ----
template <typename T, typename A>
__global__ void npt_ke3_kernel(const T* __restrict__ vx,
                               const T* __restrict__ vy,
                               const T* __restrict__ vz,
                               const int* __restrict__ typ,
                               const T* __restrict__ mass_t, int n,
                               A* __restrict__ partial) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[3] = {0, 0, 0};
  if (i < n) {
    const T m = mass_t[typ[i]];
    const T a = vx[i], b = vy[i], c = vz[i];
    vals[0] = static_cast<A>((m * a) * a);
    vals[1] = static_cast<A>((m * b) * b);
    vals[2] = static_cast<A>((m * c) * c);
  }
  __shared__ A red[kThreads / 32][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const A s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const A s = warp_sum(lane < kThreads / 32 ? red[lane][k] : A(0));
      if (lane == 0) partial[blockIdx.x * 3 + k] = s;
    }
  }
}

// ---- K16c: barostat velocity scale, then the half kick ----
template <typename T>
__global__ void npt_vscale_kick_kernel(T* vx, T* vy, T* vz,
                                       const T* __restrict__ fx,
                                       const T* __restrict__ fy,
                                       const T* __restrict__ fz,
                                       const int* __restrict__ typ,
                                       const T* __restrict__ minv_t,
                                       const T* __restrict__ vfac, T dtf,
                                       int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T a = vx[i] * vfac[0], b = vy[i] * vfac[1], c = vz[i] * vfac[2];
  if (fx) {
    const T dtfm = dtf * minv_t[typ[i]];
    a = a + dtfm * fx[i];
    b = b + dtfm * fy[i];
    c = c + dtfm * fz[i];
  }
  vx[i] = a;
  vy[i] = b;
  vz[i] = c;
}

// ---- K16c: drift and dilation about the centre ----
template <typename T>
__global__ void npt_drift_dilate_kernel(T* x, T* y, T* z,
                                        const T* __restrict__ vx,
                                        const T* __restrict__ vy,
                                        const T* __restrict__ vz,
                                        const T* __restrict__ s, T cx, T cy,
                                        T cz, T dtv, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  x[i] = cx + ((x[i] + dtv * vx[i]) - cx) * s[0];
  y[i] = cy + ((y[i] + dtv * vy[i]) - cy) * s[1];
  z[i] = cz + ((z[i] + dtv * vz[i]) - cz) * s[2];
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int npt_partial_rows(int n) { return blocks_for(n); }

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double) for
// (flt of boxL, acc of the tables and G).  ms* and u2* are (S, n_axis)
// acc, den_sq (nx, ny, nz) acc, G (nx, ny, nz) acc written; mid = nalias.
extern "C" int traced_greens(int prec, const void* msx, const void* msy,
                             const void* msz, const void* u2x,
                             const void* u2y, const void* u2z,
                             const void* den_sq, const void* boxL, int nx,
                             int ny, int nz, int S, int mid, double g2,
                             void* G, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || S <= 0 || mid < 0 || mid >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(nx * ny * nz);
#define GREENS(T, A)                                                         \
  traced_greens_kernel<T, A><<<blocks, kThreads, 0, s>>>(                    \
      static_cast<const A*>(msx), static_cast<const A*>(msy),                \
      static_cast<const A*>(msz), static_cast<const A*>(u2x),                \
      static_cast<const A*>(u2y), static_cast<const A*>(u2z),                \
      static_cast<const A*>(den_sq), static_cast<const T*>(boxL), nx, ny,    \
      nz, S, mid, static_cast<A>(g2), static_cast<A*>(G))
  switch (prec) {
    case 0: GREENS(float, float); break;
    case 1: GREENS(float, double); break;
    case 2: GREENS(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GREENS
  return static_cast<int>(cudaGetLastError());
}

// prec as above for (flt, acc); partial[npt_partial_rows(n)][3] acc.
extern "C" int npt_ke3(int prec, const void* vx, const void* vy,
                       const void* vz, const void* typ, const void* mass_t,
                       int n, void* partial, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KE3(T, A)                                                            \
  npt_ke3_kernel<T, A><<<blocks_for(n), kThreads, 0, s>>>(                   \
      static_cast<const T*>(vx), static_cast<const T*>(vy),                  \
      static_cast<const T*>(vz), static_cast<const int*>(typ),               \
      static_cast<const T*>(mass_t), n, static_cast<A*>(partial))
  switch (prec) {
    case 0: KE3(float, float); break;
    case 1: KE3(float, double); break;
    case 2: KE3(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KE3
  return static_cast<int>(cudaGetLastError());
}

// dbl: 0 float, 1 double planes.  fx, fy, fz all null: the scale alone.
extern "C" int npt_vscale_kick(int dbl, void* vx, void* vy, void* vz,
                               const void* fx, const void* fy,
                               const void* fz, const void* typ,
                               const void* minv_t, const void* vfac,
                               double dtf, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VSK(T)                                                               \
  npt_vscale_kick_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(              \
      static_cast<T*>(vx), static_cast<T*>(vy), static_cast<T*>(vz),         \
      static_cast<const T*>(fx), static_cast<const T*>(fy),                  \
      static_cast<const T*>(fz), static_cast<const int*>(typ),               \
      static_cast<const T*>(minv_t), static_cast<const T*>(vfac),            \
      static_cast<T>(dtf), n)
  if (dbl)
    VSK(double);
  else
    VSK(float);
#undef VSK
  return static_cast<int>(cudaGetLastError());
}

// dbl: 0 float, 1 double planes; s (3) flt; (cx, cy, cz) the box centre.
extern "C" int npt_drift_dilate(int dbl, void* x, void* y, void* z,
                                const void* vx, const void* vy,
                                const void* vz, const void* s, double cx,
                                double cy, double cz, double dtv, int n,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DD(T)                                                                \
  npt_drift_dilate_kernel<T><<<blocks_for(n), kThreads, 0, st>>>(            \
      static_cast<T*>(x), static_cast<T*>(y), static_cast<T*>(z),            \
      static_cast<const T*>(vx), static_cast<const T*>(vy),                  \
      static_cast<const T*>(vz), static_cast<const T*>(s),                   \
      static_cast<T>(cx), static_cast<T>(cy), static_cast<T>(cz),            \
      static_cast<T>(dtv), n)
  if (dbl)
    DD(double);
  else
    DD(float);
#undef DD
  return static_cast<int>(cudaGetLastError());
}
