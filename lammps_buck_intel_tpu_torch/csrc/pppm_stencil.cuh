// The order-p B-spline stencil of one position on the periodic mesh, shared
// by the PPPM kernels (csrc/pppm.cu: the charge deposit, the ik and ad
// gathers and the per-atom gather) and the multi-channel dispersion kernels
// (csrc/pppm_disp.cu), and the point-major mesh load of the two per-atom
// gathers.
//
// u = (x - lo) * (1/h) per axis; base = rint(u) for odd order (floor for
// even); mesh point base + o (o in stencil_offsets(order)) gets M_p(u -
// (base + o) + p/2), evaluated by piecewise Horner from the (p, p) piece
// table the host passes (staged in shared memory by stage_coef).  Every
// index is wrapped periodically ((i % n) + n) % n, so any finite position,
// in the box or not, lands on the mesh.  axis_weights gives a position's
// p weights and wrapped indices on one axis; stencil_base and
// stencil_weight give one of them, for kernels that spread a position's
// weights over a warp's lanes.

#pragma once

#include <cuda_runtime.h>

namespace pppm_stencil {

constexpr int kMaxOrder = 7;

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }
__device__ __forceinline__ float dev_rint(float v) { return rintf(v); }
__device__ __forceinline__ double dev_rint(double v) { return rint(v); }

// the stencil's base point of mesh coordinate u: rint for odd order, floor
// for even; its first offset o0 (base + o0 is the stencil's first point)
template <typename T>
__device__ __forceinline__ T stencil_base(T u, int p) {
  return (p & 1) ? dev_rint(u) : dev_floor(u);
}
__device__ __forceinline__ int stencil_first(int p) {
  return (p & 1) ? -(p - 1) / 2 : -(p / 2 - 1);
}

// the piece of M_p at mesh point base + o: its row j of the (p, p) piece
// tables, the coordinate t within the piece, and whether the argument
// u - (base + o) + p/2 lies on the support [0, p)
template <typename T>
struct Piece {
  int j;
  T t;
  bool in;
};

template <typename T>
__device__ __forceinline__ Piece<T> spline_piece(T u, T base, int o, int p) {
  const T arg = (u - (base + static_cast<T>(o))) + static_cast<T>(0.5 * p);
  T jf = dev_floor(arg);
  jf = jf < T(0) ? T(0) : (jf > static_cast<T>(p - 1)
                               ? static_cast<T>(p - 1) : jf);
  return {static_cast<int>(jf), arg - jf,
          arg >= T(0) && arg < static_cast<T>(p)};
}

// sum_d c[d] t^d, d = 0..deg
template <typename T>
__device__ __forceinline__ T horner(const T* c, int deg, T t) {
  T acc = c[deg];
  for (int d = deg - 1; d >= 0; --d) acc = acc * t + c[d];
  return acc;
}

// the weight M_p(u - (base + o) + p/2) of mesh point base + o
template <typename T>
__device__ __forceinline__ T stencil_weight(T u, T base, int o, int p,
                                            const T* coef) {
  const Piece<T> pc = spline_piece(u, base, o, p);
  const T w = horner(coef + pc.j * p, p - 1, pc.t);
  return pc.in ? w : T(0);
}

// mesh indices and weights of one position on one axis (first p entries);
// with D also the derivative weights dw = dM_p/du from the (p, p)
// derivative piece table dcoef (p - 1 coefficients a row), and u itself
template <bool D, typename T>
__device__ __forceinline__ void axis_weights_impl(T pos, T lo, T invh, int n,
                                                  int p, const T* coef,
                                                  const T* dcoef, int* idx,
                                                  T* w, T* dw, T* u_out) {
  const T u = (pos - lo) * invh;
  const T base = stencil_base(u, p);
  const int b = static_cast<int>(base);
  const int o0 = stencil_first(p);
  if (D) *u_out = u;
#pragma unroll
  for (int s = 0; s < kMaxOrder; ++s) {
    if (s < p) {
      const int o = o0 + s;
      const Piece<T> pc = spline_piece(u, base, o, p);
      const T acc = horner(coef + pc.j * p, p - 1, pc.t);
      w[s] = pc.in ? acc : T(0);
      if (D) {
        const T dacc = horner(dcoef + pc.j * p, p - 2, pc.t);
        dw[s] = pc.in ? dacc : T(0);
      }
      idx[s] = (((b + o) % n) + n) % n;
    }
  }
}

template <typename T>
__device__ __forceinline__ void axis_weights(T pos, T lo, T invh, int n,
                                             int p, const T* coef, int* idx,
                                             T* w) {
  axis_weights_impl<false>(pos, lo, invh, n, p, coef,
                           static_cast<const T*>(nullptr), idx, w,
                           static_cast<T*>(nullptr), static_cast<T*>(nullptr));
}

struct MeshGeom {
  int nx, ny, nz, p;
};

inline bool geom_ok(MeshGeom g) {
  return g.p >= 2 && g.p <= kMaxOrder && g.nx > 0 && g.ny > 0 && g.nz > 0;
}

// the eight acc values of one point of the point-major per-atom meshes
// (csrc/pppm.cu's and csrc/pppm_disp.cu's per-atom gathers), in aligned
// vector loads (one 32-byte sector in float, two in double)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = *reinterpret_cast<const double2*>(p + 2 * k);
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}

template <typename T>
__device__ __forceinline__ void stage_coef(const T* coef, int p, T* s_coef) {
  for (int k = threadIdx.x; k < p * p; k += blockDim.x) s_coef[k] = coef[k];
  __syncthreads();
}

}  // namespace pppm_stencil
