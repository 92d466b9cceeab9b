// PPPM on the global periodic mesh: charge deposit, half-spectrum solve
// and ik field gather over the cell-slot planes (sm_90a).
//
// Replaces (lammps_buck_intel_tpu/models/kspace/pppm_cells.py, ik mode):
//   pppm_deposit  <- deposit_rho_zblock (:580) with _axis_weights (:121)
//                    and pppm.py mspline_horner (:133);
//   pppm_spectral <- CellPPPM._spectral (:801) with _half_weights (:731)
//                    and the ik spectra of CellPPPM._ik_forces (:1139);
//   pppm_gather   <- gather_zblock (:633) in mode "ik" and the q * qqrd2e
//                    scaling of CellPPPM._ik_forces (:1155).
// and, on the variable-cell (fix npt) path, the ik branch of
// models/kspace/pppm_npt.py TracedPPPM.compute_traced (:277; deposit
// :294-306, spectra :317-343, gather :372-387): there the planes are in
// atom order (aid = identity), the box is read from the card (boxL) and
// the caller rebuilds G and k from it.
// The JAX package moves charge through per-cell spline patches and one-hot
// matrix products, TPU matrix-unit forms without scatters.  A GPU has
// atomics in L2, so the port takes the generic global-mesh form: each slot
// puts its order^3 B-spline weights straight onto the periodic mesh.
//
// Weights.  u = (x - lo) * (1/h) per axis; base = rint(u) for odd order
// (floor for even); mesh point base + o (o in stencil_offsets(order)) gets
// M_p(u - (base + o) + p/2), evaluated by piecewise Horner from the (p, p)
// piece table the host passes (staged in shared memory).  Every index is
// wrapped periodically, so positions up to skin/2 outside the box between
// rebins need no margin.  The gather recomputes the weights instead of
// reading the deposit's: 3 * p Horner evaluations are ~250 flops a slot,
// while storing and reloading 3 * p weights and 3 bases would move ~100
// bytes a slot twice through device memory.
//
// What bounds them on the H100.
//   deposit: one thread per slot, p^3 atomicAdds (343 at order 7) into the
//     flt mesh; at the 259,200-atom silica deck 8.9e7 atomics onto a
//     905,520-point mesh (3.6 MB in f32) that stays in the 50 MB L2.  The
//     floor by bytes and flops is a few microseconds; atomic throughput
//     (neighbouring slots of a cell hit overlapping points) bounds it.
//     Privatised per-block sub-meshes in shared memory are later work.
//   spectral: one grid-stride pass over the (nx, ny, nz/2+1) half
//     spectrum: reads rho_hat and G, writes three complex spectra; bytes
//     bound.  With e/v it also reduces elong and the 6 virial sums per
//     block into partial[block][7] (summed by the caller, deterministic).
//   gather: one thread per slot, 3 * p^3 reads of the flt E meshes (11 MB,
//     L2 resident), sums in acc; bound by L2 read bandwidth.
// Precision: deposit in flt (the JAX mesh dtype); spectral in acc; gather
// flt weights and field, acc sums.  -O3 without --use_fast_math.  Kernels
// launch on the caller's stream, allocate nothing, return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 7;
constexpr int kThreads = 256;

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }
__device__ __forceinline__ float dev_rint(float v) { return rintf(v); }
__device__ __forceinline__ double dev_rint(double v) { return rint(v); }

// mesh indices and weights of one position on one axis (first p entries)
template <typename T>
__device__ __forceinline__ void axis_weights(T pos, T lo, T invh, int n,
                                             int p, const T* coef, int* idx,
                                             T* w) {
  const T u = (pos - lo) * invh;
  const T base = (p & 1) ? dev_rint(u) : dev_floor(u);
  const int b = static_cast<int>(base);
  const int o0 = (p & 1) ? -(p - 1) / 2 : -(p / 2 - 1);
  const T half = static_cast<T>(0.5 * p);
#pragma unroll
  for (int s = 0; s < kMaxOrder; ++s) {
    if (s < p) {
      const int o = o0 + s;
      const T arg = (u - (base + static_cast<T>(o))) + half;
      T jf = dev_floor(arg);
      jf = jf < T(0) ? T(0) : (jf > static_cast<T>(p - 1)
                                   ? static_cast<T>(p - 1) : jf);
      const T t = arg - jf;
      const T* c = coef + static_cast<int>(jf) * p;
      T acc = c[p - 1];
      for (int d = p - 2; d >= 0; --d) acc = acc * t + c[d];
      w[s] = (arg >= T(0) && arg < static_cast<T>(p)) ? acc : T(0);
      idx[s] = (((b + o) % n) + n) % n;
    }
  }
}

struct MeshGeom {
  int nx, ny, nz, p;
};

template <typename T>
__device__ __forceinline__ void stage_coef(const T* coef, int p, T* s_coef) {
  for (int k = threadIdx.x; k < p * p; k += blockDim.x) s_coef[k] = coef[k];
  __syncthreads();
}

// The mesh geometry of a box read from the card (the variable-cell path):
// on entry lo* hold the box centre; lo = centre - L / 2, 1/h = n / L per
// axis, in the JAX package's TracedPPPM._weights order.
template <typename T>
__device__ __forceinline__ void traced_geometry(const T* boxL, MeshGeom g,
                                                T& lox, T& loy, T& loz,
                                                T& ihx, T& ihy, T& ihz) {
  lox = lox - T(0.5) * boxL[0];
  loy = loy - T(0.5) * boxL[1];
  loz = loz - T(0.5) * boxL[2];
  ihx = static_cast<T>(g.nx) / boxL[0];
  ihy = static_cast<T>(g.ny) / boxL[1];
  ihz = static_cast<T>(g.nz) / boxL[2];
}

template <typename T>
__global__ void pppm_deposit_kernel(const T* __restrict__ x,
    const T* __restrict__ y, const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ aid, int ns, int n, T lox, T loy, T loz, T ihx,
    T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const T* __restrict__ boxL,
    T* __restrict__ mesh) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  stage_coef(coef, g.p, s_coef);
  if (boxL) traced_geometry(boxL, g, lox, loy, loz, ihx, ihy, ihz);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns || aid[s] >= n) return;
  int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
  axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
  axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
  const T qs = q[s];
#pragma unroll
  for (int a = 0; a < kMaxOrder; ++a) {
    if (a >= g.p) continue;
#pragma unroll
    for (int b = 0; b < kMaxOrder; ++b) {
      if (b >= g.p) continue;
      const T wxy = wx[a] * wy[b];
      const int row = (ix[a] * g.ny + iy[b]) * g.nz;
#pragma unroll
      for (int c = 0; c < kMaxOrder; ++c) {
        if (c < g.p) atomicAdd(mesh + row + iz[c], (wxy * wz[c]) * qs);
      }
    }
  }
}

template <typename T, typename A>
__global__ void pppm_gather_kernel(const T* __restrict__ x,
    const T* __restrict__ y, const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ aid, int ns, int n, T lox, T loy, T loz, T ihx,
    T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const T* __restrict__ boxL,
    const T* __restrict__ e, T qqrd2e, A* __restrict__ fx, A* __restrict__ fy,
    A* __restrict__ fz) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  stage_coef(coef, g.p, s_coef);
  if (boxL) traced_geometry(boxL, g, lox, loy, loz, ihx, ihy, ihz);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  if (aid[s] >= n) {
    fx[s] = A(0);
    fy[s] = A(0);
    fz[s] = A(0);
    return;
  }
  int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
  axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
  axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
  const int ng = g.nx * g.ny * g.nz;
  A ex = 0, ey = 0, ez = 0;
#pragma unroll
  for (int a = 0; a < kMaxOrder; ++a) {
    if (a >= g.p) continue;
#pragma unroll
    for (int b = 0; b < kMaxOrder; ++b) {
      if (b >= g.p) continue;
      const T wxy = wx[a] * wy[b];
      const int row = (ix[a] * g.ny + iy[b]) * g.nz;
#pragma unroll
      for (int c = 0; c < kMaxOrder; ++c) {
        if (c >= g.p) continue;
        const T w = wxy * wz[c];
        const int m = row + iz[c];
        ex += static_cast<A>(w * e[m]);
        ey += static_cast<A>(w * e[ng + m]);
        ez += static_cast<A>(w * e[2 * ng + m]);
      }
    }
  }
  const A qf = static_cast<A>(qqrd2e * q[s]);
  fx[s] = ex * qf;
  fy[s] = ey * qf;
  fz[s] = ez * qf;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// rhat, ehat: interleaved complex (re, im); ehat holds the three spectra
// -i k_a G rhat back to back.  EV also writes partial[block][7] = (sum ek,
// the six sums ek * (delta_ab - pref k_a k_b)), ek = G |rhat|^2 wz.
// nyq: the full-spectrum conventions of the JAX package's TracedPPPM at
// the Nyquist planes of even nx, ny.  (1) The x and y spectra take k = 0
// on their own axis's Nyquist plane, where -i k G rhat is anti-Hermitian:
// the real part of a full inverse FFT drops it, the c2r of a half spectrum
// would not.  (2) An off-diagonal virial sum over an interior kz plane
// (weight 2: the point and its mirror -k) takes weight 0 where exactly one
// of its two axes sits on its Nyquist index: that index is its own
// mirror, so k_a k_b changes sign between the point and its mirror and
// the full sum cancels the pair.
template <typename A, bool EV>
__global__ void pppm_spectral_kernel(const A* __restrict__ rhat,
    const A* __restrict__ G, const A* __restrict__ kx,
    const A* __restrict__ ky, const A* __restrict__ kz,
    const A* __restrict__ wz, int nx, int ny, int nzh, A quarter_g2inv,
    int nyq, A* __restrict__ ehat, A* __restrict__ partial) {
  const int npts = nx * ny * nzh;
  A s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < npts;
       i += gridDim.x * blockDim.x) {
    const int k = i % nzh;
    const int j = (i / nzh) % ny;
    const int l = i / (nzh * ny);
    const A re = rhat[2 * i], im = rhat[2 * i + 1];
    const A gv = G[i];
    const A pr = gv * re, pi = gv * im;
    const A kxv = kx[l], kyv = ky[j], kzv = kz[k];
    const bool qx = nyq && 2 * l == nx, qy = nyq && 2 * j == ny;
    const A kxe = qx ? A(0) : kxv;
    const A kye = qy ? A(0) : kyv;
    ehat[2 * i] = kxe * pi;
    ehat[2 * i + 1] = -(kxe * pr);
    ehat[2 * (npts + i)] = kye * pi;
    ehat[2 * (npts + i) + 1] = -(kye * pr);
    ehat[2 * (2 * npts + i)] = kzv * pi;
    ehat[2 * (2 * npts + i) + 1] = -(kzv * pr);
    if (EV) {
      const A ek = gv * (re * re + im * im) * wz[k];
      const A ksq = kxv * kxv + kyv * kyv + kzv * kzv;
      const A ksafe = ksq == A(0) ? A(1) : ksq;
      const A pref = A(2) * (A(1) / ksafe + quarter_g2inv);
      const bool inner = wz[k] != A(1);  // an interior kz plane
      s0 += ek;
      s1 += ek * (A(1) - pref * kxv * kxv);
      s2 += ek * (A(1) - pref * kyv * kyv);
      s3 += ek * (A(1) - pref * kzv * kzv);
      if (!(inner && qx != qy)) s4 += ek * (-pref * kxv * kyv);
      if (!(inner && qx)) s5 += ek * (-pref * kxv * kzv);
      if (!(inner && qy)) s6 += ek * (-pref * kyv * kzv);
    }
  }
  if (EV) {
    __shared__ A red[kThreads / 32][7];
    A vals[7] = {s0, s1, s2, s3, s4, s5, s6};
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int v = 0; v < 7; ++v) {
      const A t = warp_sum(vals[v]);
      if (lane == 0) red[warp][v] = t;
    }
    __syncthreads();
    if (warp == 0) {
      const int nwarps = blockDim.x >> 5;
#pragma unroll
      for (int v = 0; v < 7; ++v) {
        const A t = warp_sum(lane < nwarps ? red[lane][v] : A(0));
        if (lane == 0) partial[blockIdx.x * 7 + v] = t;
      }
    }
  }
}

inline int slot_blocks(int ns) { return (ns + kThreads - 1) / kThreads; }

template <typename T>
int launch_deposit(const void* x, const void* y, const void* z,
                   const void* q, const void* aid, int ns, int n,
                   const double* lo, const double* ih, MeshGeom g,
                   const void* coef, const void* boxL, void* mesh,
                   cudaStream_t st) {
  if (ns <= 0) return 0;
  pppm_deposit_kernel<T><<<slot_blocks(ns), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(q),
      static_cast<const int*>(aid), ns, n, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g,
      static_cast<const T*>(coef), static_cast<const T*>(boxL),
      static_cast<T*>(mesh));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_gather(const void* x, const void* y, const void* z, const void* q,
                  const void* aid, int ns, int n, const double* lo,
                  const double* ih, MeshGeom g, const void* coef,
                  const void* boxL, const void* e, double qqrd2e, void* fx,
                  void* fy, void* fz, cudaStream_t st) {
  if (ns <= 0) return 0;
  pppm_gather_kernel<T, A><<<slot_blocks(ns), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(q),
      static_cast<const int*>(aid), ns, n, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g,
      static_cast<const T*>(coef), static_cast<const T*>(boxL),
      static_cast<const T*>(e), static_cast<T>(qqrd2e), static_cast<A*>(fx), static_cast<A*>(fy),
      static_cast<A*>(fz));
  return static_cast<int>(cudaGetLastError());
}

template <typename A, bool EV>
int launch_spectral(const void* rhat, const void* G, const void* kx,
                    const void* ky, const void* kz, const void* wz, int nx,
                    int ny, int nzh, double quarter_g2inv, int nyq,
                    void* ehat, void* partial, int nblocks, cudaStream_t st) {
  pppm_spectral_kernel<A, EV><<<nblocks, kThreads, 0, st>>>(
      static_cast<const A*>(rhat), static_cast<const A*>(G),
      static_cast<const A*>(kx), static_cast<const A*>(ky),
      static_cast<const A*>(kz), static_cast<const A*>(wz), nx, ny, nzh,
      static_cast<A>(quarter_g2inv), nyq, static_cast<A*>(ehat),
      static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

bool geom_ok(MeshGeom g) {
  return g.p >= 2 && g.p <= kMaxOrder && g.nx > 0 && g.ny > 0 && g.nz > 0;
}

}  // namespace

// Threads per block of every PPPM kernel (the spectral partials have one
// row per block).
extern "C" int pppm_threads() { return kThreads; }

// prec: 0 = float, 1 = double (the slot-plane / mesh type).  mesh must be
// zeroed by the caller; lo and invh are the box origin and 1/h per axis,
// or, with boxL (3 lengths of the slot type on the card) not null, lo is
// the box centre and invh is not read.
extern "C" int pppm_deposit(int prec, const void* x, const void* y,
                            const void* z, const void* q, const void* aid,
                            int ns, int n, double lox, double loy,
                            double loz, double ihx, double ihy, double ihz,
                            int nx, int ny, int nz, int order,
                            const void* coef, const void* boxL, void* mesh,
                            void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case 0:
      return launch_deposit<float>(x, y, z, q, aid, ns, n, lo, ih, g, coef,
                                   boxL, mesh, s);
    case 1:
      return launch_deposit<double>(x, y, z, q, aid, ns, n, lo, ih, g, coef,
                                    boxL, mesh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// prec: 0 = float, 1 = double (the acc type).  ev != 0 writes
// partial[nblocks][7]; nyq as in pppm_spectral_kernel.
extern "C" int pppm_spectral(int prec, int ev, const void* rhat,
                             const void* G, const void* kx, const void* ky,
                             const void* kz, const void* wz, int nx, int ny,
                             int nzh, double quarter_g2inv, int nyq,
                             void* ehat, void* partial, int nblocks,
                             void* stream) {
  if (nblocks <= 0 || nx <= 0 || ny <= 0 || nzh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPECTRAL_ARGS \
  rhat, G, kx, ky, kz, wz, nx, ny, nzh, quarter_g2inv, nyq, ehat, \
      partial, nblocks, s
  switch (prec * 2 + (ev ? 1 : 0)) {
    case 0: return launch_spectral<float, false>(SPECTRAL_ARGS);
    case 1: return launch_spectral<float, true>(SPECTRAL_ARGS);
    case 2: return launch_spectral<double, false>(SPECTRAL_ARGS);
    case 3: return launch_spectral<double, true>(SPECTRAL_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPECTRAL_ARGS
}

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double) for
// (flt, acc).  e holds the three flt E meshes back to back; fx/fy/fz are
// acc-typed (ns,), zero on empty slots.  lo, invh and boxL as in
// pppm_deposit.
extern "C" int pppm_gather(int prec, const void* x, const void* y,
                           const void* z, const void* q, const void* aid,
                           int ns, int n, double lox, double loy, double loz,
                           double ihx, double ihy, double ihz, int nx, int ny,
                           int nz, int order, const void* coef,
                           const void* boxL, const void* e, double qqrd2e,
                           void* fx, void* fy, void* fz, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATHER_ARGS \
  x, y, z, q, aid, ns, n, lo, ih, g, coef, boxL, e, qqrd2e, fx, fy, fz, s
  switch (prec) {
    case 0: return launch_gather<float, float>(GATHER_ARGS);
    case 1: return launch_gather<float, double>(GATHER_ARGS);
    case 2: return launch_gather<double, double>(GATHER_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATHER_ARGS
}
