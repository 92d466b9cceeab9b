// SHAKE/RATTLE distance constraints over the slot planes (sm_90a): the
// reference bond vectors (shake_ref), the position solve (shake_positions),
// the velocity projection (rattle_velocities) and the constraint virial at
// thermo rows (shake_virial).
//
// Replaces: lammps_buck_intel_tpu/integrate/shake.py
//   shake_positions_clustered (:459) with _solve_small (:423),
//   rattle_velocities_clustered (:540), and shake_virial (:225) /
//   shake_virial_clustered (:578), which XLA lowered for the TPU as
//   lanes-last (C, M) tensor code; and the positions at the start of the
//   step that cellpair_verlet.py one_step (:503-531) hands SHAKE as x_old.
//
// Design.  One thread per cluster of constraints.  The cluster tables are
// lanes-last, M (the cluster index) minor, so neighbouring threads read
// neighbouring words: atoms (A, M) atom ids (-1 pad), pi/pj (C, M) local
// atom indices (-1 on a pad constraint), d2 (C, M), K (C, C, M) the
// constraint-space coupling, invm (A, M).  Atoms and constraints fill each
// cluster's leading entries, so a thread counts its own na and nc and
// never touches a pad: pads are not looked up in the slot-of-atom map
// `inv` (whose row N every empty slot writes) and never written.  A thread
// finds its atoms' slots through `inv` (as csrc/bonded.cu does, so no rebin
// gathers anything), holds the cluster's positions, bond vectors and its
// (C, C) system in registers (local memory for the widest template), and
// writes back only its own atoms: clusters are disjoint, so no atomics.
//   shake_ref          ro[3][C][M] = minimum image of x_i - x_j, written
//                      before the drift (the drift updates x in place).
//   shake_positions    exactly niter = min(iters, 4) Newton iterations in
//                      constraint space: F_c = |rn_c|^2 - d2_c, J_cd =
//                      2 (rn_c . ro_d) K_cd, J dlam = -F by unpivoted
//                      elimination with the pivot guard (|p| <= 1e-12 ->
//                      +-1e-12), lam += dlam, rn_c += sum_d K_cd dlam_d
//                      ro_d; then x_a += sum_c W_ca lam_c ro_c (W = -1/m_i
//                      at i, +1/m_j at j) and, unless v is null (the
//                      set-up settle), v += (x_fix - x_new) / dt.  rn, the
//                      corrected bond vectors, is stored for RATTLE.
//                      With vir (the fix npt step) it also reduces the
//                      constraint virial sum_c ro_c (x) (-lam_c vfac ro_c),
//                      vfac = 1 / (dt dtf) (JAX shake.py :525-529), which
//                      drives the barostat every step.
//   rattle_velocities  (r_c . r_d) K_cd mu_d = -r_c . dv_c solved once;
//                      v_a += sum_c W_ca mu_c r_c.  r is SHAKE's rn, or is
//                      computed from the positions when rn is null.
//   shake_virial       the instantaneous multipliers on the total force
//                      f = (flt)(fa + fb): ftm2v (r_c . r_d) K_cd lam_d =
//                      -(|dv_c|^2 + r_c . da_c), da = ftm2v/m f; the 6
//                      components of sum_c r_c (x) (-lam_c r_c) per block in
//                      a fixed shuffle tree into partial[block][6] (acc);
//                      the caller sums the partials in a second pass.
// The order of every operation is that of the JAX package and of the
// plain torch version (integrate/shake.py), and the library is compiled
// with --fmad=false, so the two round alike and only the order of a few
// sums can differ.
//
// What bounds it on the H100.  Bytes: per cluster of one C-H bond the
// tables (~32 bytes), two slot lookups, the atoms' positions and
// velocities read and written, the bond vectors (12 bytes each way), some
// 100-170 bytes per kernel, ~5 us at 124,416 clusters against 3.35 TB/s.
// The slot lookups scatter, so the reads are 32-byte sectors, not words;
// at the decks' 15,552 clusters a kernel is a few microseconds and launch
// latency decides.
//
// The box.  The cell engine passes host lengths; the variable-cell (fix
// npt) engine passes Ldev, the lengths on the card, which a kernel reads
// itself (the box changes every step and never comes to the host).
//
// Templates: T (flt) float or double, A (acc) for the virial, MAXC the
// widest cluster a thread holds (1: C-H bonds; 3: water, CH3; 12: up to
// twelve constraints on thirteen atoms).  Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dev_rint(float v) { return rintf(v); }
__device__ __forceinline__ double dev_rint(double v) { return rint(v); }
__device__ __forceinline__ float dev_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double dev_abs(double v) { return fabs(v); }

// The box of a launch: host lengths, or (dev not null) lengths read from
// the card by resolve(), the variable-cell path's box, whose reciprocal is
// then taken in T as the plain version takes it.
template <typename T>
struct Image {
  T L[3], Linv[3];
  const T* dev;
  __device__ __forceinline__ void resolve() {
    if (!dev) return;
    for (int a = 0; a < 3; ++a) {
      L[a] = dev[a];
      Linv[a] = T(1) / dev[a];
    }
  }
  __device__ __forceinline__ T operator()(T d, int ax) const {
    return d - dev_rint(d * Linv[ax]) * L[ax];
  }
};

template <typename T>
Image<T> make_image(double Lx, double Ly, double Lz, const void* Ldev) {
  Image<T> im;
  const double L[3] = {Lx, Ly, Lz};
  for (int a = 0; a < 3; ++a) {
    im.L[a] = static_cast<T>(L[a]);
    im.Linv[a] = static_cast<T>(1.0 / L[a]);  // f64 reciprocal, rounded once
  }
  im.dev = static_cast<const T*>(Ldev);
  return im;
}

// The cluster tables of one launch (lanes-last, M minor).
template <typename T>
struct Tables {
  int M, C, A;
  const int* atoms;  // (A, M)
  const int* pi;     // (C, M)
  const int* pj;     // (C, M)
  const T* d2;       // (C, M)
  const T* K;        // (C, C, M)
  const T* invm;     // (A, M)
  const int* inv;    // slot of atom
};

// v[i] for a runtime index i into a register array: an unrolled select,
// so the array stays in registers.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (k == i) r = v[k];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void add_at(T (&v)[N], int i, T d) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k == i) v[k] += d;
}

// A thread's cluster: its atom count, constraint count, local indices and
// the slots of its atoms.
template <typename T, int MAXC>
struct Cluster {
  static constexpr int MAXA = MAXC + 1;
  int na, nc;
  int li[MAXC], lj[MAXC];
  int slot[MAXA];

  __device__ __forceinline__ void load(const Tables<T>& t, int m) {
    na = 0;
    nc = 0;
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      slot[a] = 0;
      if (a < t.A) {
        const int id = t.atoms[a * t.M + m];
        if (id >= 0) {
          slot[a] = t.inv[id];
          na = a + 1;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      li[c] = 0;
      lj[c] = 0;
      if (c < t.C) {
        const int p = t.pi[c * t.M + m];
        if (p >= 0) {
          li[c] = p;
          lj[c] = t.pj[c * t.M + m];
          nc = c + 1;
        }
      }
    }
  }

  // p[3][a] = plane values of the cluster's atoms (0 on pads)
  __device__ __forceinline__ void gather(const T* px, const T* py,
                                         const T* pz, T (&p)[3][MAXA]) const {
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      const bool ok = a < na;
      p[0][a] = ok ? px[slot[a]] : T(0);
      p[1][a] = ok ? py[slot[a]] : T(0);
      p[2][a] = ok ? pz[slot[a]] : T(0);
    }
  }

  // r[ax][c] = p[ax][i_c] - p[ax][j_c], minimum-imaged with `im` if given
  __device__ __forceinline__ void diff(const T (&p)[3][MAXA],
                                       const Image<T>* im,
                                       T (&r)[3][MAXC]) const {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        T d = T(0);
        if (c < nc) {
          d = pick(p[ax], li[c]) - pick(p[ax], lj[c]);
          if (im) d = (*im)(d, ax);
        }
        r[ax][c] = d;
      }
  }

  // K[c][d] of this cluster (0 outside nc)
  __device__ __forceinline__ void coupling(const Tables<T>& t, int m,
                                           T (&K)[MAXC][MAXC]) const {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
      for (int d = 0; d < MAXC; ++d)
        K[c][d] = (c < nc && d < nc) ? t.K[(c * t.C + d) * t.M + m] : T(0);
  }

  // upd[ax][a] = sum_c W_ca coef_c r[ax][c], W = -1/m at i_c, +1/m at j_c
  __device__ __forceinline__ void update(const Tables<T>& t, int m,
                                         const T (&coef)[MAXC],
                                         const T (&r)[3][MAXC],
                                         T (&upd)[3][MAXA]) const {
    T im[MAXA];
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      im[a] = a < na ? t.invm[a * t.M + m] : T(0);
      upd[0][a] = upd[1][a] = upd[2][a] = T(0);
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        const T wi = -pick(im, li[c]), wj = pick(im, lj[c]);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const T s = coef[c] * r[ax][c];
          add_at(upd[ax], li[c], wi * s);
          add_at(upd[ax], lj[c], wj * s);
        }
      }
    }
  }
};

// J x = b for the leading nc x nc block: unrolled, unpivoted elimination
// with the pivot guard of the JAX package's _solve_small; J and b are
// overwritten, x is 0 beyond nc.
template <typename T, int MAXC>
__device__ __forceinline__ void solve_small(T (&J)[MAXC][MAXC], T (&b)[MAXC],
                                            int nc, T (&x)[MAXC]) {
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    if (k < nc) {
      T piv = J[k][k];
      piv = dev_abs(piv) > T(1e-12) ? piv
                                    : (piv < T(0) ? T(-1e-12) : T(1e-12));
      const T inv = T(1) / piv;
      J[k][k] = piv;
#pragma unroll
      for (int i = k + 1; i < MAXC; ++i) {
        if (i < nc) {
          const T f = J[i][k] * inv;
#pragma unroll
          for (int j = k + 1; j < MAXC; ++j)
            if (j < nc) J[i][j] = J[i][j] - f * J[k][j];
          b[i] = b[i] - f * b[k];
        }
      }
    }
  }
#pragma unroll
  for (int k = MAXC - 1; k >= 0; --k) {
    x[k] = T(0);
    if (k < nc) {
      T s = b[k];
#pragma unroll
      for (int j = k + 1; j < MAXC; ++j)
        if (j < nc) s = s - J[k][j] * x[j];
      x[k] = s / J[k][k];
    }
  }
}

template <typename T, int MAXC>
__device__ __forceinline__ T dot3(const T (&a)[3][MAXC], int c,
                                  const T (&b)[3][MAXC], int d) {
  return a[0][c] * b[0][d] + a[1][c] * b[1][d] + a[2][c] * b[2][d];
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// vals[6] of every thread of the block -> out[blockIdx.x][6], in a fixed
// shuffle tree (all threads of the block call it)
template <typename A>
__device__ __forceinline__ void block_sum6(const A (&vals)[6], A* out) {
  __shared__ A red[kThreads / 32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const A s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const A s = warp_sum(lane < kThreads / 32 ? red[lane][k] : A(0));
      if (lane == 0) out[blockIdx.x * 6 + k] = s;
    }
  }
}

// ---- K13d: reference bond vectors ----
template <typename T>
__global__ void shake_ref_kernel(Tables<T> t, Image<T> im,
                                 const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ z, T* __restrict__ ro) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= t.M) return;
  im.resolve();
  const T* p[3] = {x, y, z};
  for (int c = 0; c < t.C; ++c) {
    const int li = t.pi[c * t.M + m];
    if (li < 0) {
      for (int ax = 0; ax < 3; ++ax) ro[(ax * t.C + c) * t.M + m] = T(0);
      continue;
    }
    const int si = t.inv[t.atoms[li * t.M + m]];
    const int sj = t.inv[t.atoms[t.pj[c * t.M + m] * t.M + m]];
    for (int ax = 0; ax < 3; ++ax)
      ro[(ax * t.C + c) * t.M + m] = im(p[ax][si] - p[ax][sj], ax);
  }
}

// ---- K13a: positions ----
// With vir not null also the constraint virial of the step (fix npt):
// sum_c ro_c (x) (-lam_c vfac ro_c), 6 components per block in a fixed
// shuffle tree into vir[block][6] (T), summed by the caller.
template <typename T, int MAXC>
__global__ void shake_positions_kernel(Tables<T> t, Image<T> im, T* x, T* y,
                                       T* z, T* vx, T* vy, T* vz,
                                       const T* __restrict__ ro_in,
                                       T* __restrict__ rn_out, T dt,
                                       int niter, T vfac,
                                       T* __restrict__ vir) {
  using Cl = Cluster<T, MAXC>;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  im.resolve();
  T vals[6] = {0, 0, 0, 0, 0, 0};
  if (m < t.M) {
    Cl cl;
    cl.load(t, m);
    T xa[3][Cl::MAXA];
    cl.gather(x, y, z, xa);
    T rn[3][MAXC], ro[3][MAXC], K[MAXC][MAXC], d2[MAXC], lam[MAXC];
    cl.diff(xa, &im, rn);
    cl.coupling(t, m, K);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const bool ok = c < cl.nc;
      d2[c] = ok ? t.d2[c * t.M + m] : T(1);
      lam[c] = T(0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        ro[ax][c] = ok ? ro_in[(ax * t.C + c) * t.M + m] : T(0);
    }
    for (int it = 0; it < niter; ++it) {
      T J[MAXC][MAXC], b[MAXC], dlam[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        b[c] = -(dot3(rn, c, rn, c) - d2[c]);
#pragma unroll
        for (int d = 0; d < MAXC; ++d)
          J[c][d] = (T(2) * dot3(rn, c, ro, d)) * K[c][d];
      }
      solve_small(J, b, cl.nc, dlam);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        lam[c] += dlam[c];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          T s = T(0);
#pragma unroll
          for (int d = 0; d < MAXC; ++d) s += K[c][d] * (dlam[d] * ro[ax][d]);
          rn[ax][c] += s;
        }
      }
    }
    T dx[3][Cl::MAXA];
    cl.update(t, m, lam, ro, dx);
    T* px[3] = {x, y, z};
    T* pv[3] = {vx, vy, vz};
#pragma unroll
    for (int a = 0; a < Cl::MAXA; ++a) {
      if (a < cl.na) {
        const int s = cl.slot[a];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const T xf = xa[ax][a] + dx[ax][a];
          px[ax][s] = xf;
          if (vx) pv[ax][s] = pv[ax][s] + (xf - xa[ax][a]) / dt;
        }
      }
    }
    for (int c = 0; c < t.C; ++c)
      for (int ax = 0; ax < 3; ++ax) {
        T v = T(0);
#pragma unroll
        for (int k = 0; k < MAXC; ++k)
          if (k == c) v = rn[ax][k];
        rn_out[(ax * t.C + c) * t.M + m] = v;
      }
    if (vir) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < cl.nc) {
          const T wc = -lam[c] * vfac;
          const T w0 = wc * ro[0][c], w1 = wc * ro[1][c], w2 = wc * ro[2][c];
          vals[0] += ro[0][c] * w0;
          vals[1] += ro[1][c] * w1;
          vals[2] += ro[2][c] * w2;
          vals[3] += ro[0][c] * w1;
          vals[4] += ro[0][c] * w2;
          vals[5] += ro[1][c] * w2;
        }
      }
    }
  }
  if (vir) block_sum6(vals, vir);
}

// ---- K13b: RATTLE ----
template <typename T, int MAXC>
__global__ void rattle_kernel(Tables<T> t, Image<T> im,
                              const T* __restrict__ x,
                              const T* __restrict__ y,
                              const T* __restrict__ z, T* vx, T* vy, T* vz,
                              const T* __restrict__ r_in) {
  using Cl = Cluster<T, MAXC>;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= t.M) return;
  im.resolve();
  Cl cl;
  cl.load(t, m);
  T r[3][MAXC], dv[3][MAXC], K[MAXC][MAXC];
  if (r_in) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        r[ax][c] = c < cl.nc ? r_in[(ax * t.C + c) * t.M + m] : T(0);
  } else {
    T xa[3][Cl::MAXA];
    cl.gather(x, y, z, xa);
    cl.diff(xa, &im, r);
  }
  T va[3][Cl::MAXA];
  cl.gather(vx, vy, vz, va);
  cl.diff(va, nullptr, dv);
  cl.coupling(t, m, K);
  T J[MAXC][MAXC], b[MAXC], mu[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    b[c] = -dot3(r, c, dv, c);
#pragma unroll
    for (int d = 0; d < MAXC; ++d) J[c][d] = dot3(r, c, r, d) * K[c][d];
  }
  solve_small(J, b, cl.nc, mu);
  T upd[3][Cl::MAXA];
  cl.update(t, m, mu, r, upd);
  T* pv[3] = {vx, vy, vz};
#pragma unroll
  for (int a = 0; a < Cl::MAXA; ++a)
    if (a < cl.na)
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        pv[ax][cl.slot[a]] = va[ax][a] + upd[ax][a];
}

// ---- K13c: constraint virial ----
template <typename T, typename A, int MAXC>
__global__ void shake_virial_kernel(Tables<T> t, Image<T> im,
                                    const T* __restrict__ x,
                                    const T* __restrict__ y,
                                    const T* __restrict__ z,
                                    const T* __restrict__ vx,
                                    const T* __restrict__ vy,
                                    const T* __restrict__ vz,
                                    const A* __restrict__ fax,
                                    const A* __restrict__ fay,
                                    const A* __restrict__ faz,
                                    const A* __restrict__ fbx,
                                    const A* __restrict__ fby,
                                    const A* __restrict__ fbz, T ftm2v,
                                    A* __restrict__ partial) {
  using Cl = Cluster<T, MAXC>;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  A vals[6] = {0, 0, 0, 0, 0, 0};
  im.resolve();
  if (m < t.M) {
    Cl cl;
    cl.load(t, m);
    T xa[3][Cl::MAXA], va[3][Cl::MAXA], da[3][Cl::MAXA];
    cl.gather(x, y, z, xa);
    cl.gather(vx, vy, vz, va);
    const A* fa[3] = {fax, fay, faz};
    const A* fb[3] = {fbx, fby, fbz};
#pragma unroll
    for (int a = 0; a < Cl::MAXA; ++a) {
      const bool ok = a < cl.na;
      const T w = ok ? ftm2v * t.invm[a * t.M + m] : T(0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        A f = A(0);
        if (ok) {
          f = fa[ax][cl.slot[a]];
          if (fbx) f = f + fb[ax][cl.slot[a]];
        }
        da[ax][a] = w * static_cast<T>(f);
      }
    }
    T r[3][MAXC], dv[3][MAXC], dd[3][MAXC], K[MAXC][MAXC];
    cl.diff(xa, &im, r);
    cl.diff(va, nullptr, dv);
    cl.diff(da, nullptr, dd);
    cl.coupling(t, m, K);
    T J[MAXC][MAXC], b[MAXC], lam[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      T base = T(0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        base += dv[ax][c] * dv[ax][c] + r[ax][c] * dd[ax][c];
      b[c] = -base;
#pragma unroll
      for (int d = 0; d < MAXC; ++d)
        J[c][d] = (ftm2v * dot3(r, c, r, d)) * K[c][d];
    }
    solve_small(J, b, cl.nc, lam);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < cl.nc) {
        const T wc = -lam[c];
        const T w0 = wc * r[0][c], w1 = wc * r[1][c], w2 = wc * r[2][c];
        vals[0] += static_cast<A>(r[0][c] * w0);
        vals[1] += static_cast<A>(r[1][c] * w1);
        vals[2] += static_cast<A>(r[2][c] * w2);
        vals[3] += static_cast<A>(r[0][c] * w1);
        vals[4] += static_cast<A>(r[0][c] * w2);
        vals[5] += static_cast<A>(r[1][c] * w2);
      }
    }
  }
  block_sum6(vals, partial);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
Tables<T> make_tables(int M, int C, int A, const void* atoms, const void* pi,
                      const void* pj, const void* d2, const void* K,
                      const void* invm, const void* inv) {
  return {M,
          C,
          A,
          static_cast<const int*>(atoms),
          static_cast<const int*>(pi),
          static_cast<const int*>(pj),
          static_cast<const T*>(d2),
          static_cast<const T*>(K),
          static_cast<const T*>(invm),
          static_cast<const int*>(inv)};
}

// MAXC template of a table width C: 1, 3 or 12; 0 if none takes it
inline int maxc_for(int C) {
  return C <= 1 ? 1 : (C <= 3 ? 3 : (C <= 12 ? 12 : 0));
}

template <typename T>
int launch_ref(int M, int C, int A, const void* atoms, const void* pi,
               const void* pj, const void* inv, const void* x, const void* y,
               const void* z, double Lx, double Ly, double Lz,
               const void* Ldev, void* ro, cudaStream_t s) {
  const Tables<T> t = make_tables<T>(M, C, A, atoms, pi, pj, nullptr,
                                     nullptr, nullptr, inv);
  shake_ref_kernel<T><<<blocks_for(M), kThreads, 0, s>>>(
      t, make_image<T>(Lx, Ly, Lz, Ldev), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<const T*>(z), static_cast<T*>(ro));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_positions(int M, int C, int A, const void* atoms, const void* pi,
                     const void* pj, const void* d2, const void* K,
                     const void* invm, const void* inv, void* x, void* y,
                     void* z, void* vx, void* vy, void* vz, const void* ro,
                     void* rn, double Lx, double Ly, double Lz,
                     const void* Ldev, double dt, int niter, double vfac,
                     void* vir, cudaStream_t s) {
  const Tables<T> t = make_tables<T>(M, C, A, atoms, pi, pj, d2, K, invm, inv);
  const Image<T> im = make_image<T>(Lx, Ly, Lz, Ldev);
#define POSITIONS_ARGS                                                      \
  t, im, static_cast<T*>(x), static_cast<T*>(y), static_cast<T*>(z),        \
      static_cast<T*>(vx), static_cast<T*>(vy), static_cast<T*>(vz),        \
      static_cast<const T*>(ro), static_cast<T*>(rn), static_cast<T>(dt), niter, \
      static_cast<T>(vfac), static_cast<T*>(vir)
  switch (maxc_for(C)) {
    case 1:
      shake_positions_kernel<T, 1><<<blocks_for(M), kThreads, 0, s>>>(
          POSITIONS_ARGS);
      break;
    case 3:
      shake_positions_kernel<T, 3><<<blocks_for(M), kThreads, 0, s>>>(
          POSITIONS_ARGS);
      break;
    case 12:
      shake_positions_kernel<T, 12><<<blocks_for(M), kThreads, 0, s>>>(
          POSITIONS_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef POSITIONS_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rattle(int M, int C, int A, const void* atoms, const void* pi,
                  const void* pj, const void* K, const void* invm,
                  const void* inv, const void* x, const void* y, const void* z,
                  void* vx, void* vy, void* vz, const void* r, double Lx,
                  double Ly, double Lz, const void* Ldev, cudaStream_t s) {
  const Tables<T> t = make_tables<T>(M, C, A, atoms, pi, pj, nullptr, K, invm,
                                     inv);
  const Image<T> im = make_image<T>(Lx, Ly, Lz, Ldev);
#define RATTLE_ARGS                                                    \
  t, im, static_cast<const T*>(x), static_cast<const T*>(y),           \
      static_cast<const T*>(z), static_cast<T*>(vx), static_cast<T*>(vy), \
      static_cast<T*>(vz), static_cast<const T*>(r)
  switch (maxc_for(C)) {
    case 1:
      rattle_kernel<T, 1><<<blocks_for(M), kThreads, 0, s>>>(RATTLE_ARGS);
      break;
    case 3:
      rattle_kernel<T, 3><<<blocks_for(M), kThreads, 0, s>>>(RATTLE_ARGS);
      break;
    case 12:
      rattle_kernel<T, 12><<<blocks_for(M), kThreads, 0, s>>>(RATTLE_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RATTLE_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_virial(int M, int C, int A, const void* atoms, const void* pi,
                  const void* pj, const void* K, const void* invm,
                  const void* inv, const void* x, const void* y, const void* z,
                  const void* vx, const void* vy, const void* vz,
                  const void* fax, const void* fay, const void* faz,
                  const void* fbx, const void* fby, const void* fbz,
                  double Lx, double Ly, double Lz, double ftm2v, void* partial,
                  cudaStream_t s) {
  const Tables<T> t = make_tables<T>(M, C, A, atoms, pi, pj, nullptr, K, invm,
                                     inv);
  const Image<T> im = make_image<T>(Lx, Ly, Lz, nullptr);
#define VIRIAL_ARGS                                                           \
  t, im, static_cast<const T*>(x), static_cast<const T*>(y),                  \
      static_cast<const T*>(z), static_cast<const T*>(vx),                    \
      static_cast<const T*>(vy), static_cast<const T*>(vz),                   \
      static_cast<const Acc*>(fax), static_cast<const Acc*>(fay),             \
      static_cast<const Acc*>(faz), static_cast<const Acc*>(fbx),             \
      static_cast<const Acc*>(fby), static_cast<const Acc*>(fbz),             \
      static_cast<T>(ftm2v), static_cast<Acc*>(partial)
  switch (maxc_for(C)) {
    case 1:
      shake_virial_kernel<T, Acc, 1><<<blocks_for(M), kThreads, 0, s>>>(
          VIRIAL_ARGS);
      break;
    case 3:
      shake_virial_kernel<T, Acc, 3><<<blocks_for(M), kThreads, 0, s>>>(
          VIRIAL_ARGS);
      break;
    case 12:
      shake_virial_kernel<T, Acc, 12><<<blocks_for(M), kThreads, 0, s>>>(
          VIRIAL_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIRIAL_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common arguments: M clusters, C constraints and A atoms of the widest
// (the tables' leading dimensions; C <= 12, A <= C + 1), the lanes-last
// int32 tables atoms (A, M), pi and pj (C, M), flt tables d2 (C, M),
// K (C, C, M), invm (A, M), inv the int32 slot-of-atom map, flt slot
// planes, bond vectors ro / rn / r as (3, C, M) flt.  The box: the host
// lengths Lx, Ly, Lz, or, where an entry takes Ldev and it is not null,
// the 3 flt lengths on the card (the variable-cell path).  dbl selects double
// for flt; prec 0 = (float, float), 1 = (float, double), 2 = (double,
// double) for (flt, acc).

extern "C" int shake_partial_rows(int M) { return blocks_for(M); }

extern "C" int shake_ref(int dbl, int M, int C, int A, const void* atoms,
                         const void* pi, const void* pj, const void* inv,
                         const void* x, const void* y, const void* z,
                         double Lx, double Ly, double Lz, const void* Ldev,
                         void* ro, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_ref<double>(M, C, A, atoms, pi, pj, inv, x, y, z, Lx,
                                  Ly, Lz, Ldev, ro, s)
             : launch_ref<float>(M, C, A, atoms, pi, pj, inv, x, y, z, Lx, Ly,
                                 Lz, Ldev, ro, s);
}

// vx, vy, vz may all be null: positions only (the set-up settle).  vir
// null: no virial; else vir[shake_partial_rows(M)][6] (flt) of the
// constraint virial with the factor vfac.
extern "C" int shake_positions(int dbl, int M, int C, int A,
                               const void* atoms, const void* pi,
                               const void* pj, const void* d2, const void* K,
                               const void* invm, const void* inv, void* x,
                               void* y, void* z, void* vx, void* vy, void* vz,
                               const void* ro, void* rn, double Lx, double Ly,
                               double Lz, const void* Ldev, double dt,
                               int niter, double vfac, void* vir,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_positions<double>(M, C, A, atoms, pi, pj, d2, K, invm,
                                        inv, x, y, z, vx, vy, vz, ro, rn, Lx,
                                        Ly, Lz, Ldev, dt, niter, vfac, vir, s)
             : launch_positions<float>(M, C, A, atoms, pi, pj, d2, K, invm,
                                       inv, x, y, z, vx, vy, vz, ro, rn, Lx,
                                       Ly, Lz, Ldev, dt, niter, vfac, vir, s);
}

// r null: the bond vectors are computed from x, y, z.
extern "C" int rattle_velocities(int dbl, int M, int C, int A,
                                 const void* atoms, const void* pi,
                                 const void* pj, const void* K,
                                 const void* invm, const void* inv,
                                 const void* x, const void* y, const void* z,
                                 void* vx, void* vy, void* vz, const void* r,
                                 double Lx, double Ly, double Lz,
                                 const void* Ldev, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_rattle<double>(M, C, A, atoms, pi, pj, K, invm, inv, x,
                                     y, z, vx, vy, vz, r, Lx, Ly, Lz, Ldev, s)
             : launch_rattle<float>(M, C, A, atoms, pi, pj, K, invm, inv, x, y,
                                    z, vx, vy, vz, r, Lx, Ly, Lz, Ldev, s);
}

// fa*: acc force planes; fb* may be null.  partial[shake_partial_rows(M)][6].
extern "C" int shake_virial(int prec, int M, int C, int A, const void* atoms,
                            const void* pi, const void* pj, const void* K,
                            const void* invm, const void* inv, const void* x,
                            const void* y, const void* z, const void* vx,
                            const void* vy, const void* vz, const void* fax,
                            const void* fay, const void* faz, const void* fbx,
                            const void* fby, const void* fbz, double Lx,
                            double Ly, double Lz, double ftm2v, void* partial,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIRIAL_CALL(T, Acc)                                                  \
  launch_virial<T, Acc>(M, C, A, atoms, pi, pj, K, invm, inv, x, y, z, vx,  \
                        vy, vz, fax, fay, faz, fbx, fby, fbz, Lx, Ly, Lz,   \
                        ftm2v, partial, s)
  switch (prec) {
    case 0: return VIRIAL_CALL(float, float);
    case 1: return VIRIAL_CALL(float, double);
    case 2: return VIRIAL_CALL(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIRIAL_CALL
}
