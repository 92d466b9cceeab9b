// Velocity-Verlet updates, the kinetic sums and the Nose-Hoover chain half
// step over the slot planes (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/integrate/cellpair_verlet.py one_step
//   (:475: half kick, drift, force sum and cast, half kick) and
//   _thermo_device (:661: sum(m v^2) and max |v|^2), and
//   lammps_buck_intel_tpu/integrate/nvt.py nhc_half (:51), which XLA fused
//   into a few loops over the planes.
//
// Kernels.
//   verlet_kick_drift  v += dtfm f; x += dtv v, with dtfm = dtf / mass[type]
//                      read per slot from the per-type table; empty slots
//                      (aid >= n) are left alone.
//   verlet_kick        f = (flt)(fa + fb), the acc-typed force planes of the
//                      pair kernel (with the bonded forces added) and of
//                      k-space (fb may be null), stored for the next step's
//                      first kick; v += dtfm f; optionally the kinetic
//                      partials of the kicked velocities.
//   verlet_ke          kinetic partials alone: per block sum(m v^2) in acc
//                      and max(v^2), partial[block][2].
//   nhc_scale          one chain half step and the velocity scale.  Every
//                      block sums the kinetic partials in the same fixed
//                      order, so all get the same 2 KE; thread 0 of each
//                      block integrates the M-link chain in registers (the
//                      order of operations of nhc_half) and shares the
//                      scale factor; the block scales its slots; block 0
//                      writes the new chain to a second buffer, so no block
//                      reads what another writes.
//
// The kinetic kernels run a fixed number of blocks at most (kMaxBlocks)
// with a grid-stride loop, so nhc_scale never sums more than kMaxBlocks
// partials per block.  The library is compiled with --fmad=false: each
// update is a multiply and an add rounded separately, as in the JAX
// package and in the plain torch version, so positions and velocities
// agree with it to the last bit and only the reductions differ in order.
//
// What bounds it on the H100.  Bytes: kick_drift reads 9 planes and writes
// 6, kick reads 3-6 acc planes and 3 velocity planes and writes 6, all of
// nslots elements, a few microseconds each at 3.35 TB/s; launch latency
// decides at small sizes, which is why a step is 2 launches (NVE) or 5
// (NVT) instead of dozens of elementwise ones.
//
// Precision: templated on (flt, acc) = (float, float), (float, double),
// (double, double); the chain is integrated in flt like the plain version.
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxChain = 16;

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename A>
__device__ __forceinline__ A warp_max(A v) {
  for (int off = 16; off > 0; off >>= 1) {
    const A o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Sum and max over the block in a fixed tree; valid in thread 0.
template <typename A>
__device__ void block_sum_max(A& sum, A& mx) {
  __shared__ A red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sum = warp_sum(sum);
  mx = warp_max(mx);
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    sum = warp_sum(lane < kThreads / 32 ? red[0][lane] : A(0));
    mx = warp_max(lane < kThreads / 32 ? red[1][lane] : A(0));
  }
}

template <typename T>
__global__ void kick_drift_kernel(T* __restrict__ x, T* __restrict__ y,
                                  T* __restrict__ z, T* __restrict__ vx,
                                  T* __restrict__ vy, T* __restrict__ vz,
                                  const T* __restrict__ fx,
                                  const T* __restrict__ fy,
                                  const T* __restrict__ fz,
                                  const int* __restrict__ typ,
                                  const int* __restrict__ aid,
                                  const T* __restrict__ minv, int n, int ns,
                                  T dtf, T dtv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ns || aid[i] >= n) return;
  const T dtfm = dtf * minv[typ[i]];
  const T ux = vx[i] + dtfm * fx[i];
  const T uy = vy[i] + dtfm * fy[i];
  const T uz = vz[i] + dtfm * fz[i];
  vx[i] = ux;
  vy[i] = uy;
  vz[i] = uz;
  x[i] += dtv * ux;
  y[i] += dtv * uy;
  z[i] += dtv * uz;
}

// KICK: store the summed force and kick; KE: write the kinetic partials.
template <typename T, typename A, bool KICK, bool KE>
__global__ void kick_ke_kernel(T* __restrict__ vx, T* __restrict__ vy,
                               T* __restrict__ vz, T* __restrict__ fx,
                               T* __restrict__ fy, T* __restrict__ fz,
                               const A* __restrict__ fax,
                               const A* __restrict__ fay,
                               const A* __restrict__ faz,
                               const A* __restrict__ fbx,
                               const A* __restrict__ fby,
                               const A* __restrict__ fbz,
                               const int* __restrict__ typ,
                               const int* __restrict__ aid,
                               const T* __restrict__ minv,
                               const T* __restrict__ mass, int n, int ns,
                               T dtf, A* __restrict__ partial) {
  A sum = 0, mx = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ns;
       i += gridDim.x * blockDim.x) {
    const bool active = aid[i] < n;
    T ux = vx[i], uy = vy[i], uz = vz[i];
    if (KICK) {
      A ax = fax[i], ay = fay[i], az = faz[i];
      if (fbx) {
        ax += fbx[i];
        ay += fby[i];
        az += fbz[i];
      }
      const T gx = static_cast<T>(ax), gy = static_cast<T>(ay),
              gz = static_cast<T>(az);
      fx[i] = gx;
      fy[i] = gy;
      fz[i] = gz;
      if (active) {
        const T dtfm = dtf * minv[typ[i]];
        ux += dtfm * gx;
        uy += dtfm * gy;
        uz += dtfm * gz;
        vx[i] = ux;
        vy[i] = uy;
        vz[i] = uz;
      }
    }
    if (KE && active) {
      const T v2 = ux * ux + uy * uy + uz * uz;
      sum += static_cast<A>(mass[typ[i]] * v2);
      const A v2a = static_cast<A>(v2);
      mx = v2a > mx ? v2a : mx;
    }
  }
  if (KE) {
    block_sum_max(sum, mx);
    if (threadIdx.x == 0) {
      partial[2 * blockIdx.x] = sum;
      partial[2 * blockIdx.x + 1] = mx;
    }
  }
}

// Chain constants of one half step, in the chain's own type.
template <typename T>
struct ChainParams {
  int m;
  T dt2, dt4, dt8, kt, dof_kt, q1, qk, mvv2e;
};

// nhc_half of integrate/nvt.py on (eta, eta_dot) in registers; returns the
// velocity scale factor.
template <typename T>
__device__ T chain_half(const ChainParams<T>& p, T ke2, T* eta, T* ed) {
  const int m = p.m;
  T g[kMaxChain];
  g[0] = (ke2 - p.dof_kt) / p.q1;
  for (int k = 1; k < m; ++k) {
    const T qprev = k == 1 ? p.q1 : p.qk;
    g[k] = (qprev * ed[k - 1] * ed[k - 1] - p.kt) / p.qk;
  }
  // backward sweep: eta_dot from the tail to the head
  ed[m - 1] = ed[m - 1] + g[m - 1] * p.dt4;
  for (int k = m - 2; k >= 0; --k) {
    const T e = dev_exp(-p.dt8 * ed[k + 1]);
    ed[k] = (ed[k] * e + g[k] * p.dt4) * e;
  }
  const T scale = dev_exp(-p.dt2 * ed[0]);
  ke2 = ke2 * scale * scale;
  for (int k = 0; k < m; ++k) eta[k] = eta[k] + p.dt2 * ed[k];
  // forward sweep with the scaled kinetic energy
  {
    const T g0 = (ke2 - p.dof_kt) / p.q1;
    const T e = m > 1 ? dev_exp(-p.dt8 * ed[1]) : T(1);
    ed[0] = (ed[0] * e + g0 * p.dt4) * e;
  }
  for (int k = 1; k < m; ++k) {
    const T qprev = k == 1 ? p.q1 : p.qk;
    const T gk = (qprev * ed[k - 1] * ed[k - 1] - p.kt) / p.qk;
    if (k < m - 1) {
      const T e = dev_exp(-p.dt8 * ed[k + 1]);
      ed[k] = (ed[k] * e + gk * p.dt4) * e;
    } else {
      ed[k] = ed[k] + gk * p.dt4;
    }
  }
  return scale;
}

// chain_in / chain_out: (2, m) = eta, eta_dot.
template <typename T, typename A>
__global__ void nhc_scale_kernel(T* __restrict__ vx, T* __restrict__ vy,
                                 T* __restrict__ vz, int ns,
                                 const A* __restrict__ partial, int nparts,
                                 const T* __restrict__ chain_in,
                                 T* __restrict__ chain_out,
                                 ChainParams<T> p) {
  __shared__ T s_scale;
  A sum = 0, unused = 0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x)
    sum += partial[2 * k];
  block_sum_max(sum, unused);
  if (threadIdx.x == 0) {
    T eta[kMaxChain], ed[kMaxChain];
    for (int k = 0; k < p.m; ++k) {
      eta[k] = chain_in[k];
      ed[k] = chain_in[p.m + k];
    }
    const T ke2 = static_cast<T>(sum) * p.mvv2e;
    s_scale = chain_half(p, ke2, eta, ed);
    if (blockIdx.x == 0) {
      for (int k = 0; k < p.m; ++k) {
        chain_out[k] = eta[k];
        chain_out[p.m + k] = ed[k];
      }
    }
  }
  __syncthreads();
  const T scale = s_scale;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ns) {
    vx[i] *= scale;
    vy[i] *= scale;
    vz[i] *= scale;
  }
}

inline int blocks_for(int ns) { return (ns + kThreads - 1) / kThreads; }
inline int capped_blocks(int ns) {
  const int b = blocks_for(ns);
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename T>
int launch_kick_drift(void* x, void* y, void* z, void* vx, void* vy, void* vz,
                      const void* fx, const void* fy, const void* fz,
                      const void* typ, const void* aid, const void* minv,
                      int n, int ns, double dtf, double dtv, cudaStream_t s) {
  kick_drift_kernel<T><<<blocks_for(ns), kThreads, 0, s>>>(
      static_cast<T*>(x), static_cast<T*>(y), static_cast<T*>(z),
      static_cast<T*>(vx), static_cast<T*>(vy), static_cast<T*>(vz),
      static_cast<const T*>(fx), static_cast<const T*>(fy),
      static_cast<const T*>(fz), static_cast<const int*>(typ),
      static_cast<const int*>(aid), static_cast<const T*>(minv), n, ns,
      static_cast<T>(dtf), static_cast<T>(dtv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, bool KICK, bool KE>
int launch_kick_ke(void* vx, void* vy, void* vz, void* fx, void* fy, void* fz,
                   const void* const* fa, const void* const* fb,
                   const void* typ, const void* aid, const void* minv,
                   const void* mass, int n, int ns, double dtf, void* partial,
                   cudaStream_t s) {
  kick_ke_kernel<T, A, KICK, KE><<<capped_blocks(ns), kThreads, 0, s>>>(
      static_cast<T*>(vx), static_cast<T*>(vy), static_cast<T*>(vz),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz),
      static_cast<const A*>(fa[0]), static_cast<const A*>(fa[1]),
      static_cast<const A*>(fa[2]), static_cast<const A*>(fb[0]),
      static_cast<const A*>(fb[1]), static_cast<const A*>(fb[2]),
      static_cast<const int*>(typ), static_cast<const int*>(aid),
      static_cast<const T*>(minv), static_cast<const T*>(mass), n, ns,
      static_cast<T>(dtf), static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_nhc(void* vx, void* vy, void* vz, int ns, const void* partial,
               int nparts, const void* chain_in, void* chain_out, int m,
               double dt, double kt, double dof_kt, double q1, double qk,
               double mvv2e, cudaStream_t s) {
  if (m < 1 || m > kMaxChain || nparts > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainParams<T> p;
  p.m = m;
  p.dt2 = static_cast<T>(0.5 * dt);
  p.dt4 = static_cast<T>(0.25 * dt);
  p.dt8 = static_cast<T>(0.125 * dt);
  p.kt = static_cast<T>(kt);
  p.dof_kt = static_cast<T>(dof_kt);
  p.q1 = static_cast<T>(q1);
  p.qk = static_cast<T>(qk);
  p.mvv2e = static_cast<T>(mvv2e);
  nhc_scale_kernel<T, A><<<blocks_for(ns), kThreads, 0, s>>>(
      static_cast<T*>(vx), static_cast<T*>(vy), static_cast<T*>(vz), ns,
      static_cast<const A*>(partial), nparts,
      static_cast<const T*>(chain_in), static_cast<T*>(chain_out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of kinetic partial rows verlet_kick (with partial) and verlet_ke
// write for ns slots: partial is (rows, 2) acc-typed.
extern "C" int verlet_partial_rows(int ns) { return capped_blocks(ns); }

// flt64 != 0: the planes are double, else float.
extern "C" int verlet_kick_drift(int flt64, void* x, void* y, void* z,
                                 void* vx, void* vy, void* vz, const void* fx,
                                 const void* fy, const void* fz,
                                 const void* typ, const void* aid,
                                 const void* minv, int n, int ns, double dtf,
                                 double dtv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flt64 ? launch_kick_drift<double>(x, y, z, vx, vy, vz, fx, fy, fz,
                                           typ, aid, minv, n, ns, dtf, dtv, s)
               : launch_kick_drift<float>(x, y, z, vx, vy, vz, fx, fy, fz,
                                          typ, aid, minv, n, ns, dtf, dtv, s);
}

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double).
// fa: the three acc-typed force planes; fb: three more to add, or nulls.
// partial: null, or (verlet_partial_rows(ns), 2) acc-typed for the kinetic
// partials of the kicked velocities.
extern "C" int verlet_kick(int prec, void* vx, void* vy, void* vz, void* fx,
                           void* fy, void* fz, const void* fax,
                           const void* fay, const void* faz, const void* fbx,
                           const void* fby, const void* fbz, const void* typ,
                           const void* aid, const void* minv,
                           const void* mass, int n, int ns, double dtf,
                           void* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fa[3] = {fax, fay, faz};
  const void* fb[3] = {fbx, fby, fbz};
#define VERLET_KICK(T, A)                                                    \
  (partial ? launch_kick_ke<T, A, true, true>(vx, vy, vz, fx, fy, fz, fa,    \
                                              fb, typ, aid, minv, mass, n,   \
                                              ns, dtf, partial, s)           \
           : launch_kick_ke<T, A, true, false>(vx, vy, vz, fx, fy, fz, fa,   \
                                               fb, typ, aid, minv, mass, n,  \
                                               ns, dtf, partial, s))
  switch (prec) {
    case 0: return VERLET_KICK(float, float);
    case 1: return VERLET_KICK(float, double);
    case 2: return VERLET_KICK(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VERLET_KICK
}

extern "C" int verlet_ke(int prec, void* vx, void* vy, void* vz,
                         const void* typ, const void* aid, const void* mass,
                         int n, int ns, void* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* none[3] = {nullptr, nullptr, nullptr};
#define VERLET_KE(T, A)                                                      \
  launch_kick_ke<T, A, false, true>(vx, vy, vz, nullptr, nullptr, nullptr,   \
                                    none, none, typ, aid, nullptr, mass, n,  \
                                    ns, 0.0, partial, s)
  switch (prec) {
    case 0: return VERLET_KE(float, float);
    case 1: return VERLET_KE(float, double);
    case 2: return VERLET_KE(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VERLET_KE
}

// partial: (nparts, 2) kinetic partials; chain_in, chain_out: (2, m) flt,
// distinct buffers.  q1 = dof kt t_damp^2, qk = kt t_damp^2.
extern "C" int nhc_scale(int prec, void* vx, void* vy, void* vz, int ns,
                         const void* partial, int nparts,
                         const void* chain_in, void* chain_out, int m,
                         double dt, double kt, double dof_kt, double q1,
                         double qk, double mvv2e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case 0:
      return launch_nhc<float, float>(vx, vy, vz, ns, partial, nparts,
                                      chain_in, chain_out, m, dt, kt, dof_kt,
                                      q1, qk, mvv2e, s);
    case 1:
      return launch_nhc<float, double>(vx, vy, vz, ns, partial, nparts,
                                       chain_in, chain_out, m, dt, kt, dof_kt,
                                       q1, qk, mvv2e, s);
    case 2:
      return launch_nhc<double, double>(vx, vy, vz, ns, partial, nparts,
                                        chain_in, chain_out, m, dt, kt,
                                        dof_kt, q1, qk, mvv2e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
