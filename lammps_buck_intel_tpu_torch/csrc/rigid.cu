// Rigid bodies (fix rigid/small) on the cell-slot planes (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/integrate/rigid.py
//   rigid_force_torque (K15a) <- force_torque (:235), with the slot ->
//     atom force scatter of cellpair_verlet.py _block_rigid (:577-581);
//   rigid_update (K15b)       <- initial_integrate_rigid_ft (:266) with
//     richardson (:245) and atom_positions (:215), final_integrate_rigid_ft
//     (:277) with atom_velocities (:228), and the per-slot wrap offsets
//     of _block_rigid (:583-595);
//   rigid_virial (K15c)       <- constraint_virial (:333).
//
// Layout.  Bodies are a CSR of atoms (order: the atom ids sorted by body,
// start: B + 1 offsets).  A group of W lanes (W a power of two, at most
// 32: the smallest that holds the largest body, or the caller's) takes
// one body; a block of 128 threads takes 128 / W bodies.  Every lane of a
// group evaluates the body's update itself (the same arithmetic on the
// same inputs, so the same bits) and lane 0 stores it; lane k then takes
// atoms k, k + W, ... of the body.  Each atom reads and writes its slot
// through the (N + 1,) atom -> slot map inv, so no scatter between slot
// and atom order is needed.  Sums over a body's atoms run in a fixed
// order (each lane's atoms in turn, then a shuffle tree of width W): no
// atomics, so f64 runs repeat bit for bit.
//
// K15a: f = (flt)(fa[s] + fb[s]) (fb may be null; with f_out the flt force
// is stored into the slot force planes), F = sum f, T = sum d x f, in flt
// (the JAX body-state dtype).
// K15b modes: kModeOffsets: d = A(q) r_body, off[s] = x[s] - (X + d) (once
// a block, after the rebin); kModeInitial: V += dtf minv F, L += dtf T, X
// += dtv V, q by Richardson's midpoint rule (two iterations, normalised
// each time), then d and x[s] = (X + d) + off[s]; kModeFinal: V += dtf
// minv F, L += dtf T, and with planes given the slot velocities v[s] = V +
// omega x d, omega = A(q) I^-1 A(q)^T L.
// K15c: per body wb = I^-1 A^T L, wdot = I^-1 (ftm2v A^T T - wb x A^T L),
// alpha = A wdot, omega = A wb; per atom a = alpha x d + omega x (omega x
// d), f_c = (m / ftm2v) a - f, and the six sums d_a f_c,b in acc, reduced
// per block into partial[block][6] (the caller adds the rows in order).
//
// What bounds them on the H100: bytes, and at the hexane decks' sizes the
// launch itself.  K15a reads per atom its id, its slot, d and two acc
// force planes (~50 bytes in f32) and writes the flt force and per body F
// and T; K15b reads and writes ~70 bytes an atom and ~150 a body; at
// 192,000 atoms 11-16 MB, 3-5 us at 3.35 TB/s.  The quaternion algebra
// (~260 flops a body for Richardson) is small beside it.  Built with
// --fmad=false, so the updates round like the plain torch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kModeOffsets = 0, kModeInitial = 1, kModeFinal = 2;

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ V3<T> load3(const T* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

template <typename T>
__device__ __forceinline__ void store3(T* p, int i, V3<T> v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// A(q) v (inv = false) or A(q)^T v (inv = true): v + 2 (w (u x v) + u x (u
// x v)), u = +-(qx, qy, qz), the JAX quat_rotate / quat_rotate_inv.
template <typename T>
__device__ __forceinline__ V3<T> rotate(const T* q, V3<T> v, bool inv) {
  const T s = inv ? T(-1) : T(1);
  const V3<T> u{s * q[1], s * q[2], s * q[3]};
  const V3<T> uv = cross(u, v);
  const V3<T> uuv = cross(u, uv);
  return {v.x + T(2) * (q[0] * uv.x + uuv.x),
          v.y + T(2) * (q[0] * uv.y + uuv.y),
          v.z + T(2) * (q[0] * uv.z + uuv.z)};
}

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// q / |q| in place
template <typename T>
__device__ __forceinline__ void normalize(T* q) {
  const T n = dev_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

// qdot = 0.5 q (0, I^-1 A(q)^T L), the JAX richardson's qdot
template <typename T>
__device__ __forceinline__ void qdot(const T* q, V3<T> L, V3<T> iinv,
                                     T* out) {
  const V3<T> lb = rotate(q, L, true);
  const V3<T> w{iinv.x * lb.x, iinv.y * lb.y, iinv.z * lb.z};
  const V3<T> qv{q[1], q[2], q[3]};
  const V3<T> c = cross(qv, w);
  out[0] = T(0.5) * -((q[1] * w.x + q[2] * w.y) + q[3] * w.z);
  out[1] = T(0.5) * (q[0] * w.x + c.x);
  out[2] = T(0.5) * (q[0] * w.y + c.y);
  out[3] = T(0.5) * (q[0] * w.z + c.z);
}

// Richardson's midpoint quaternion drift at constant L (two iterations)
template <typename T>
__device__ __forceinline__ void richardson(T* q, V3<T> L, V3<T> iinv,
                                           T dt) {
  T qd[4], qh[4];
  const T half = T(0.5) * dt;
  qdot(q, L, iinv, qd);
  for (int k = 0; k < 4; ++k) qh[k] = q[k] + half * qd[k];
  normalize(qh);
  for (int it = 0; it < 2; ++it) {
    qdot(qh, L, iinv, qd);
    for (int k = 0; k < 4; ++k) qh[k] = q[k] + half * qd[k];
    normalize(qh);
  }
  qdot(qh, L, iinv, qd);
  for (int k = 0; k < 4; ++k) q[k] = q[k] + dt * qd[k];
  normalize(q);
}

template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, width);
  return v;
}

template <typename T, typename A>
__device__ __forceinline__ V3<T> atom_force(const A* fax, const A* fay,
                                            const A* faz, const A* fbx,
                                            const A* fby, const A* fbz,
                                            int s) {
  if (fbx)
    return {static_cast<T>(fax[s] + fbx[s]), static_cast<T>(fay[s] + fby[s]),
            static_cast<T>(faz[s] + fbz[s])};
  return {static_cast<T>(fax[s]), static_cast<T>(fay[s]),
          static_cast<T>(faz[s])};
}

// K15a
template <typename T, typename A>
__global__ void force_torque_kernel(
    const int* __restrict__ order, const int* __restrict__ start, int nbody,
    int width, const T* __restrict__ d, const int* __restrict__ inv,
    const A* __restrict__ fax, const A* __restrict__ fay,
    const A* __restrict__ faz, const A* __restrict__ fbx,
    const A* __restrict__ fby, const A* __restrict__ fbz, T* __restrict__ fox,
    T* __restrict__ foy, T* __restrict__ foz, T* __restrict__ F,
    T* __restrict__ Tq) {
  const int lane = threadIdx.x & (width - 1);
  const int b = blockIdx.x * (blockDim.x / width) + threadIdx.x / width;
  V3<T> f_sum{0, 0, 0}, t_sum{0, 0, 0};
  if (b < nbody) {
    for (int k = start[b] + lane; k < start[b + 1]; k += width) {
      const int i = order[k];
      const int s = inv[i];
      const V3<T> f = atom_force<T, A>(fax, fay, faz, fbx, fby, fbz, s);
      if (fox) {
        fox[s] = f.x;
        foy[s] = f.y;
        foz[s] = f.z;
      }
      const V3<T> t = cross(load3(d, i), f);
      f_sum = {f_sum.x + f.x, f_sum.y + f.y, f_sum.z + f.z};
      t_sum = {t_sum.x + t.x, t_sum.y + t.y, t_sum.z + t.z};
    }
  }
  // every lane of the warp takes part in the shuffles
  const V3<T> fs{group_sum(f_sum.x, width), group_sum(f_sum.y, width),
                 group_sum(f_sum.z, width)};
  const V3<T> ts{group_sum(t_sum.x, width), group_sum(t_sum.y, width),
                 group_sum(t_sum.z, width)};
  if (b < nbody && lane == 0) {
    store3(F, b, fs);
    store3(Tq, b, ts);
  }
}

// K15b
template <typename T>
__global__ void update_kernel(
    const int* __restrict__ order, const int* __restrict__ start, int nbody,
    int width, int mode, const T* __restrict__ r_body,
    const T* __restrict__ minv, const T* __restrict__ iinv, T* __restrict__ X,
    T* __restrict__ V, T* __restrict__ Q, T* __restrict__ L,
    const T* __restrict__ F, const T* __restrict__ Tq, T dtv, T dtf,
    T* __restrict__ d, const int* __restrict__ inv, T* __restrict__ px,
    T* __restrict__ py, T* __restrict__ pz, T* __restrict__ ox,
    T* __restrict__ oy, T* __restrict__ oz) {
  const int lane = threadIdx.x & (width - 1);
  const int b = blockIdx.x * (blockDim.x / width) + threadIdx.x / width;
  if (b >= nbody) return;
  V3<T> Xb = load3(X, b), Vb = load3(V, b), Lb = load3(L, b);
  T q[4] = {Q[4 * b], Q[4 * b + 1], Q[4 * b + 2], Q[4 * b + 3]};
  const V3<T> ib = load3(iinv, b);
  if (mode != kModeOffsets) {
    const V3<T> Fb = load3(F, b), Tb = load3(Tq, b);
    const T km = dtf * minv[b];
    Vb = {Vb.x + km * Fb.x, Vb.y + km * Fb.y, Vb.z + km * Fb.z};
    Lb = {Lb.x + dtf * Tb.x, Lb.y + dtf * Tb.y, Lb.z + dtf * Tb.z};
    if (mode == kModeInitial) {
      Xb = {Xb.x + dtv * Vb.x, Xb.y + dtv * Vb.y, Xb.z + dtv * Vb.z};
      richardson(q, Lb, ib, dtv);
    }
    if (lane == 0) {
      store3(V, b, Vb);
      store3(L, b, Lb);
      if (mode == kModeInitial) {
        store3(X, b, Xb);
        for (int k = 0; k < 4; ++k) Q[4 * b + k] = q[k];
      }
    }
  }
  if (mode == kModeFinal) {
    if (!px) return;
    const V3<T> lbody = rotate(q, Lb, true);
    const V3<T> om =
        rotate(q, V3<T>{ib.x * lbody.x, ib.y * lbody.y, ib.z * lbody.z},
               false);
    for (int k = start[b] + lane; k < start[b + 1]; k += width) {
      const int i = order[k];
      const int s = inv[i];
      const V3<T> w = cross(om, load3(d, i));
      px[s] = Vb.x + w.x;
      py[s] = Vb.y + w.y;
      pz[s] = Vb.z + w.z;
    }
    return;
  }
  for (int k = start[b] + lane; k < start[b + 1]; k += width) {
    const int i = order[k];
    const int s = inv[i];
    const V3<T> di = rotate(q, load3(r_body, i), false);
    store3(d, i, di);
    const T xa = Xb.x + di.x, ya = Xb.y + di.y, za = Xb.z + di.z;
    if (mode == kModeOffsets) {
      ox[s] = px[s] - xa;
      oy[s] = py[s] - ya;
      oz[s] = pz[s] - za;
    } else {
      px[s] = xa + ox[s];
      py[s] = ya + oy[s];
      pz[s] = za + oz[s];
    }
  }
}

// K15c
template <typename T, typename A>
__global__ void virial_kernel(
    const int* __restrict__ order, const int* __restrict__ start, int nbody,
    int width, const T* __restrict__ mass, const T* __restrict__ iinv,
    const T* __restrict__ Q, const T* __restrict__ L,
    const T* __restrict__ Tq, T ftm2v, const T* __restrict__ d,
    const int* __restrict__ inv, const A* __restrict__ fax,
    const A* __restrict__ fay, const A* __restrict__ faz,
    const A* __restrict__ fbx, const A* __restrict__ fby,
    const A* __restrict__ fbz, A* __restrict__ partial) {
  const int lane = threadIdx.x & (width - 1);
  const int b = blockIdx.x * (blockDim.x / width) + threadIdx.x / width;
  A v[6] = {0, 0, 0, 0, 0, 0};
  if (b < nbody) {
    const T q[4] = {Q[4 * b], Q[4 * b + 1], Q[4 * b + 2], Q[4 * b + 3]};
    const V3<T> ib = load3(iinv, b);
    const V3<T> lb = rotate(q, load3(L, b), true);
    const V3<T> wb{ib.x * lb.x, ib.y * lb.y, ib.z * lb.z};
    const V3<T> tb = rotate(q, load3(Tq, b), true);
    const V3<T> wl = cross(wb, lb);
    const V3<T> wdot{ib.x * (ftm2v * tb.x - wl.x),
                     ib.y * (ftm2v * tb.y - wl.y),
                     ib.z * (ftm2v * tb.z - wl.z)};
    const V3<T> alpha = rotate(q, wdot, false);
    const V3<T> om = rotate(q, wb, false);
    for (int k = start[b] + lane; k < start[b + 1]; k += width) {
      const int i = order[k];
      const V3<T> di = load3(d, i);
      const V3<T> f =
          atom_force<T, A>(fax, fay, faz, fbx, fby, fbz, inv[i]);
      const V3<T> c1 = cross(alpha, di);
      const V3<T> c2 = cross(om, cross(om, di));
      const T mf = mass[i] / ftm2v;
      const V3<T> fc{mf * (c1.x + c2.x) - f.x, mf * (c1.y + c2.y) - f.y,
                     mf * (c1.z + c2.z) - f.z};
      v[0] += static_cast<A>(di.x * fc.x);
      v[1] += static_cast<A>(di.y * fc.y);
      v[2] += static_cast<A>(di.z * fc.z);
      v[3] += static_cast<A>(di.x * fc.y);
      v[4] += static_cast<A>(di.x * fc.z);
      v[5] += static_cast<A>(di.y * fc.z);
    }
  }
  __shared__ A red[kThreads / 32][6];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < 6; ++c) {
    const A t = group_sum(v[c], 32);
    if (wl == 0) red[warp][c] = t;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    for (int c = 0; c < 6; ++c) {
      const A t = group_sum(wl < nwarps ? red[wl][c] : A(0), 32);
      if (wl == 0) partial[blockIdx.x * 6 + c] = t;
    }
  }
}

inline bool width_ok(int w) { return w >= 1 && w <= 32 && (w & (w - 1)) == 0; }

inline int body_blocks(int nbody, int width) {
  const int per = kThreads / width;
  return (nbody + per - 1) / per;
}

}  // namespace

extern "C" int rigid_threads() { return kThreads; }

// Rows of rigid_virial's partials.
extern "C" int rigid_blocks(int nbody, int width) {
  return width_ok(width) ? body_blocks(nbody, width) : -1;
}

// prec: 0 = (float, float), 1 = (float, double), 2 = (double, double) for
// (flt, acc).  d (N, 3), F and T (B, 3) flt; fa* acc slot planes, fb* acc
// slot planes or null; fo* flt slot planes or null.
extern "C" int rigid_force_torque(int prec, const void* order,
                                  const void* start, int nbody, int width,
                                  const void* d, const void* inv,
                                  const void* fax, const void* fay,
                                  const void* faz, const void* fbx,
                                  const void* fby, const void* fbz,
                                  void* fox, void* foy, void* foz, void* F,
                                  void* T, void* stream) {
  if (nbody <= 0 || !width_ok(width))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = body_blocks(nbody, width);
#define FT_LAUNCH(TT, AA)                                                    \
  force_torque_kernel<TT, AA><<<nb, kThreads, 0, s>>>(                       \
      static_cast<const int*>(order), static_cast<const int*>(start), nbody, \
      width, static_cast<const TT*>(d), static_cast<const int*>(inv),        \
      static_cast<const AA*>(fax), static_cast<const AA*>(fay),              \
      static_cast<const AA*>(faz), static_cast<const AA*>(fbx),              \
      static_cast<const AA*>(fby), static_cast<const AA*>(fbz),              \
      static_cast<TT*>(fox), static_cast<TT*>(foy), static_cast<TT*>(foz),   \
      static_cast<TT*>(F), static_cast<TT*>(T))
  switch (prec) {
    case 0: FT_LAUNCH(float, float); break;
    case 1: FT_LAUNCH(float, double); break;
    case 2: FT_LAUNCH(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// dbl: 0 float, 1 double (the flt type of every array).  X, V, L (B, 3)
// and Q (B, 4) updated in place; d (N, 3) written (read in kModeFinal);
// p* the slot position planes (offsets and initial modes) or velocity
// planes (final mode, null for none); o* the slot offset planes.
extern "C" int rigid_update(int dbl, const void* order, const void* start,
                            int nbody, int width, int mode,
                            const void* r_body, const void* minv,
                            const void* iinv, void* X, void* V, void* Q,
                            void* L, const void* F, const void* T,
                            double dtv, double dtf, void* d,
                            const void* inv, void* px, void* py, void* pz,
                            void* ox, void* oy, void* oz, void* stream) {
  if (nbody <= 0 || !width_ok(width) || mode < kModeOffsets ||
      mode > kModeFinal)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = body_blocks(nbody, width);
#define UP_LAUNCH(TT)                                                         \
  update_kernel<TT><<<nb, kThreads, 0, s>>>(                                  \
      static_cast<const int*>(order), static_cast<const int*>(start), nbody,  \
      width, mode, static_cast<const TT*>(r_body),                            \
      static_cast<const TT*>(minv), static_cast<const TT*>(iinv),             \
      static_cast<TT*>(X), static_cast<TT*>(V), static_cast<TT*>(Q),          \
      static_cast<TT*>(L), static_cast<const TT*>(F),                         \
      static_cast<const TT*>(T), static_cast<TT>(dtv), static_cast<TT>(dtf),  \
      static_cast<TT*>(d), static_cast<const int*>(inv), static_cast<TT*>(px), \
      static_cast<TT*>(py), static_cast<TT*>(pz), static_cast<TT*>(ox),       \
      static_cast<TT*>(oy), static_cast<TT*>(oz))
  if (dbl)
    UP_LAUNCH(double);
  else
    UP_LAUNCH(float);
#undef UP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// prec as in rigid_force_torque; partial[rigid_blocks(nbody, width)][6]
// acc.
extern "C" int rigid_virial(int prec, const void* order, const void* start,
                            int nbody, int width, const void* mass,
                            const void* iinv, const void* Q, const void* L,
                            const void* T, double ftm2v, const void* d,
                            const void* inv, const void* fax,
                            const void* fay, const void* faz,
                            const void* fbx, const void* fby,
                            const void* fbz, void* partial, void* stream) {
  if (nbody <= 0 || !width_ok(width))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = body_blocks(nbody, width);
#define VIR_LAUNCH(TT, AA)                                                   \
  virial_kernel<TT, AA><<<nb, kThreads, 0, s>>>(                             \
      static_cast<const int*>(order), static_cast<const int*>(start), nbody, \
      width, static_cast<const TT*>(mass), static_cast<const TT*>(iinv),     \
      static_cast<const TT*>(Q), static_cast<const TT*>(L),                  \
      static_cast<const TT*>(T), static_cast<TT>(ftm2v),                     \
      static_cast<const TT*>(d), static_cast<const int*>(inv),               \
      static_cast<const AA*>(fax), static_cast<const AA*>(fay),              \
      static_cast<const AA*>(faz), static_cast<const AA*>(fbx),              \
      static_cast<const AA*>(fby), static_cast<const AA*>(fbz),              \
      static_cast<AA*>(partial))
  switch (prec) {
    case 0: VIR_LAUNCH(float, float); break;
    case 1: VIR_LAUNCH(float, double); break;
    case 2: VIR_LAUNCH(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
