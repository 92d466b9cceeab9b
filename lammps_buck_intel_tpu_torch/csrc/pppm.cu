// PPPM on the global periodic mesh: charge deposit, half-spectrum solve
// and ik field gather over the cell-slot planes, and the per-atom energy
// and virial (sm_90a).
//
// Replaces (lammps_buck_intel_tpu/models/kspace/pppm_cells.py, ik mode):
//   pppm_deposit  <- deposit_rho_zblock (:580) with _axis_weights (:121)
//                    and pppm.py mspline_horner (:133); on the cell
//                    engine's slots pppm_deposit_cells (K5 by cell, the
//                    same weights and the same charge);
//   pppm_spectral <- CellPPPM._spectral (:801) with _half_weights (:731)
//                    and the ik spectra of CellPPPM._ik_forces (:1139);
//   pppm_gather   <- gather_zblock (:633) in mode "ik" and the q * qqrd2e
//                    scaling of CellPPPM._ik_forces (:1155).
// and, on the variable-cell (fix npt) path, the ik branch of
// models/kspace/pppm_npt.py TracedPPPM.compute_traced (:277; deposit
// :294-306, spectra :317-343, gather :372-387): there the planes are in
// atom order (aid = identity), the box is read from the card (boxL) and
// the caller rebuilds G and k from it.
// Per atom (K10pa), models/kspace/pppm.py compute_peratom (:650), after
// the deposit (pppm_deposit in atom order) and one rfftn:
//   pppm_peratom_spectral <- phi_hat = G rho_hat and the six virial meshes'
//                    spectra c_k phi_hat (:683-702);
//   pppm_peratom_gather   <- the interpolation of u and the six v_c at
//                    every atom with the self and background terms
//                    (:672-683, :700-702), after one batched irfftn.
// In slot order (K18 slots), pppm_cells.py CellPPPM.compute_peratom_slots
// (:1011): pppm_deposit on the slots, one rfftn, pppm_peratom_spectral,
// one batched irfftn, and pppm_peratom_gather over the slots with their
// aid plane (empty slots write 0).
// ad differentiation (K10 ad; pppm_intel.cpp:985-1054 poisson_ad, :678-804
// fieldforce_ad), after the same deposit and one rfftn:
//   pppm_spectral with ad != 0 <- the ad half of models/kspace/pppm.py
//                    _pppm_compute_ad (:717-757: phi_hat = G rho_hat, the
//                    energy and virial sums), pppm_cells.py CellPPPM._spectral (:949-957, the
//                    half spectrum) and pppm_npt.py TracedPPPM.compute_traced
//                    (:290-345): pppm_spectral_kernel with AD, one potential
//                    spectrum out in place of three field spectra;
//   pppm_gather_ad   <- pppm.py :760-791 with sf_correction (:503) and
//                    sf_axis_series (:491), pppm_cells.py gather_zblock
//                    (:633, mode "ad") with :959-995, pppm_npt.py :346-372:
//                    after one irfftn, f_a = -q qqrd2e sum (dw_a w w) u / h_a
//                    less the self force q^2 qqrd2e sum_j sf[a][j] sin(2 pi
//                    (j + 1) u_a), in atom order or over the slots (empty
//                    slots 0), with the box from the host or the card.
// kspace_modify slab (K10 slab; host LAMMPS slabcorr(), pppm_intel.cpp:305):
//   pppm_slab        <- pppm.py slab_correction (:342-365) and its traced
//                    form pppm_npt.py :388-404: M = sum q z and M2 = sum q
//                    z^2 in acc (slab_sums_kernel, block partials), then
//                    slab_apply_kernel adds fz_i = -(4 pi / V) qqrd2e q_i (M -
//                    Q z_i) and writes e_slab = (2 pi / V) (M^2 - Q M2 - Q^2
//                    zprd^2 / 12) qqrd2e, or with eatom each atom's share of
//                    it (the eatom tally of slabcorr(); the JAX package has
//                    no per-atom slab term).  A fused two-pass reduction of
//                    this kind would suit Triton; it is CUDA so that it
//                    shares the port's one build path (ops/build.py, ctypes,
//                    LAUNCHES).
// The JAX package moves charge through per-cell spline patches and one-hot
// matrix products, TPU matrix-unit forms without scatters.  A GPU has
// atomics in L2 and in shared memory.  pppm_deposit takes the generic
// global-mesh form: each slot or atom puts its order^3 B-spline weights
// straight onto the periodic mesh (atom order, and any slot layout).
// pppm_deposit_kernel_cells (K5 by cell, the cell engine's slots on a mesh
// aligned to its coarse cells) is closer to the JAX patches: a block sums
// one cell's charges into a brick of the mesh in shared memory and adds
// the brick to the mesh once.
//
// Weights (csrc/pppm_stencil.cuh, shared with csrc/pppm_disp.cu's
// multi-channel deposit and gather).  u = (x - lo) * (1/h) per axis; base
// = rint(u) for odd order (floor for even); mesh point base + o (o in
// stencil_offsets(order)) gets M_p(u - (base + o) + p/2), evaluated by
// piecewise Horner from the (p, p) piece table the host passes (staged in
// shared memory).  Every index is
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
//     floor by bytes and flops is a few microseconds; L2 atomic throughput
//     (neighbouring slots of a cell hit overlapping points) bounds it.
//   deposit by cell (replaces the deposit on the cell engine's slots): one
//     block of eight warps a coarse cell; the p^3 adds of a slot go to a
//     shared-memory brick of the cell's mesh points plus the stencil's
//     reach and the skin/2 drift (14^3 points, 11 KB in f32, at the silica
//     deck: order 7, 7 points a cell, drift 0.31 point), one warp a slot,
//     its (y, z) stencil pairs on the lanes, so no two lanes of an add hit
//     one point; then the brick's non-zero points go to the mesh as
//     atomicAdds of consecutive z points (at the silica deck at most 2,640
//     x 2,744 = 7.2e6 in place of 8.9e7).  Bound by the shared-memory
//     adds (p^3 a charged slot) and the flush's L2 atomics; the unique
//     bytes are the deposit's.  A slot that drifted out of its brick goes
//     to the mesh directly (the generic deposit's atomics), so it costs
//     time, never charge.  Bricks above 47 KB (f64 on fine meshes) keep
//     the generic deposit.
//   spectral: one grid-stride pass over the (nx, ny, nz/2+1) half
//     spectrum: reads rho_hat and G, writes three complex spectra; bytes
//     bound.  With e/v it also reduces elong and the 6 virial sums per
//     block into partial[block][7] (summed by the caller, deterministic).
//   gather: one thread per slot, 3 * p^3 reads of the flt E meshes (11 MB,
//     L2 resident), sums in acc; bound by L2 read bandwidth.
//   peratom_spectral: one grid-stride pass over the half spectrum: reads
//     rho_hat and G, writes seven complex spectra; bytes bound.
//   ad spectral: the spectral pass writing one complex spectrum in place
//     of three; bytes bound.
//   ad gather: one thread per atom or slot, p^3 reads of ONE flt potential
//     mesh (3.6 MB at 105x112x77, L2 resident) where ik reads three, 3p
//     weights and 3p derivative weights, three acc sums of p^3 terms; bound
//     by L2 reads and the weight arithmetic.
//   slab: two passes over the z plane and charges; bytes bound (a few
//     microseconds at 259,200 atoms; launch latency dominates).
//   peratom_gather: one thread per atom or slot, p^3 weights computed
//     once and p^3 point reads of the seven meshes interleaved
//     point-major (the wrapper's copy): one 32-byte sector a point in f32
//     where seven separate meshes would touch seven (29 MB in f32 at
//     105x112x77, in L2); bound by L2 read bandwidth.
// Precision: deposit in flt (the JAX mesh dtype); spectral in acc; gather
// flt weights and field, acc sums; the per-atom gather flt weights, acc
// meshes and sums.  -O3 without --use_fast_math.  Kernels
// launch on the caller's stream, allocate nothing, return
// cudaGetLastError().

#include <cuda_runtime.h>

#include "pppm_stencil.cuh"

namespace {

using namespace pppm_stencil;

constexpr int kThreads = 256;
// threads of a pppm_deposit_kernel_cells block: eight warps a coarse cell
constexpr int kCellThreads = 256;
// the largest brick: what a block may take without opting in to more
// shared memory (48 KB), less 1 KB for the kernel's static arrays
constexpr int kMaxBrickBytes = 47 * 1024;

// The mesh geometry of a box read from the card (the variable-cell path):
// on entry lo* hold the box centre and ih* the k-space box's factors f over
// the atoms' box (1, 1 and the slab factor); lo = centre - L / 2, 1/h = n /
// (L f) per axis, in the JAX package's TracedPPPM._weights order (a factor
// of 1 leaves L as it is).
template <typename T>
__device__ __forceinline__ void traced_geometry(const T* boxL, MeshGeom g,
                                                T& lox, T& loy, T& loz,
                                                T& ihx, T& ihy, T& ihz) {
  lox = lox - T(0.5) * boxL[0];
  loy = loy - T(0.5) * boxL[1];
  loz = loz - T(0.5) * boxL[2];
  ihx = static_cast<T>(g.nx) / (boxL[0] * ihx);
  ihy = static_cast<T>(g.ny) / (boxL[1] * ihy);
  ihz = static_cast<T>(g.nz) / (boxL[2] * ihz);
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
  // a zero charge adds nothing: skipping it spares the atomics of the
  // cell engine's empty slots (q = 0, all at the origin) when the generic
  // mesh runs on its slot positions (CombinedKSpace.compute_slot)
  const T qs = q[s];
  if (qs == T(0)) return;
  int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
  axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
  axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
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

// The brick of the cell-privatised deposit on each axis: coarse cells nc,
// mesh points a cell m, the brick's first point o less the cell's first
// point (c * m), and its points w.
struct CellBrick {
  int ncx, ncy, ncz;
  int mx, my, mz;
  int ox, oy, oz;
  int wx, wy, wz;
};

__device__ __forceinline__ int wrap_index(int i, int n) {
  return ((i % n) + n) % n;
}

// K5 by cell: block c spreads the charged slots of coarse cell c (slots
// c * cap .. c * cap + cap - 1) into its brick in shared memory, then adds
// the brick's non-zero points to the periodic mesh.  One warp a slot: lanes
// 0 .. 3p - 1 compute one weight each (axis lane / p, offset lane % p),
// shuffled to the lanes that own the stencil's (y, z) pairs lane and lane +
// 32 (p^2 <= 49), which step through x.  A slot whose stencil leaves the
// brick goes to the mesh directly, with wrapped indices.  counts: null,
// or int64[2] (charged slots spread, slots among them that spilled).
template <typename T>
__global__ void __launch_bounds__(kCellThreads) pppm_deposit_kernel_cells(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ aid, int cap, int n, T lox, T loy, T loz, T ihx,
    T ihy, T ihz, MeshGeom g, CellBrick cb, const T* __restrict__ coef,
    T* __restrict__ mesh, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* brick = reinterpret_cast<T*>(s_raw);
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  __shared__ unsigned int s_count[2];
  const int nb = cb.wx * cb.wy * cb.wz;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) brick[k] = T(0);
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  stage_coef(coef, g.p, s_coef);

  const int cell = blockIdx.x;
  const int cz = cell % cb.ncz, cy = (cell / cb.ncz) % cb.ncy,
            cx = cell / (cb.ncz * cb.ncy);
  // the brick's first point on each axis, unwrapped
  const int bx0 = cx * cb.mx + cb.ox, by0 = cy * cb.my + cb.oy,
            bz0 = cz * cb.mz + cb.oz;
  const int p = g.p, o0 = stencil_first(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this lane's (y, z) stencil pairs: k0 = lane, k1 = lane + 32
  const bool has0 = lane < p * p, has1 = lane + 32 < p * p;
  const int b0 = has0 ? lane / p : 0, c0 = has0 ? lane % p : 0;
  const int b1 = has1 ? (lane + 32) / p : 0, c1 = has1 ? (lane + 32) % p : 0;
  // this lane's weight: axis lane / p, stencil offset lane % p
  const int wax = lane < 3 * p ? lane / p : 3;
  const int wo = lane < 3 * p ? lane % p : 0;
  const T* plane = wax == 0 ? x : (wax == 1 ? y : z);
  const T lo = wax == 0 ? lox : (wax == 1 ? loy : loz);
  const T ih = wax == 0 ? ihx : (wax == 1 ? ihy : ihz);
  unsigned int n_dep = 0, n_spill = 0;

  for (int j = warp; j < cap; j += nwarps) {
    const int s = cell * cap + j;
    // the three loads issued together; the same slot for the whole warp,
    // so the tests are warp-uniform
    const int id = aid[s];
    const T qs = q[s];
    const T pos = wax < 3 ? plane[s] : T(0);
    if (id >= n || qs == T(0)) continue;
    T wl = T(0);
    int bl = 0;
    if (wax < 3) {
      const T u = (pos - lo) * ih;
      const T base = stencil_base(u, p);
      wl = stencil_weight(u, base, o0 + wo, p, s_coef);
      bl = static_cast<int>(base);
    }
    const int bxs = __shfl_sync(0xffffffffu, bl, 0);
    const int bys = __shfl_sync(0xffffffffu, bl, p);
    const int bzs = __shfl_sync(0xffffffffu, bl, 2 * p);
    const T wy0 = __shfl_sync(0xffffffffu, wl, p + b0);
    const T wz0 = __shfl_sync(0xffffffffu, wl, 2 * p + c0);
    const T wy1 = __shfl_sync(0xffffffffu, wl, p + b1);
    const T wz1 = __shfl_sync(0xffffffffu, wl, 2 * p + c1);
    // the stencil's first point in brick coordinates
    const int rx = bxs + o0 - bx0, ry = bys + o0 - by0, rz = bzs + o0 - bz0;
    const bool inside = rx >= 0 && rx + p <= cb.wx && ry >= 0 &&
                        ry + p <= cb.wy && rz >= 0 && rz + p <= cb.wz;
    ++n_dep;
    if (inside) {
      const int e0 = (ry + b0) * cb.wz + rz + c0;
      const int e1 = (ry + b1) * cb.wz + rz + c1;
      for (int a = 0; a < p; ++a) {
        const T wa = __shfl_sync(0xffffffffu, wl, a);
        T* slab = brick + (rx + a) * (cb.wy * cb.wz);
        if (has0) atomicAdd(slab + e0, ((wa * wy0) * wz0) * qs);
        if (has1) atomicAdd(slab + e1, ((wa * wy1) * wz1) * qs);
      }
    } else {
      ++n_spill;
      const int g0 = wrap_index(bys + o0 + b0, g.ny) * g.nz +
                     wrap_index(bzs + o0 + c0, g.nz);
      const int g1 = wrap_index(bys + o0 + b1, g.ny) * g.nz +
                     wrap_index(bzs + o0 + c1, g.nz);
      for (int a = 0; a < p; ++a) {
        const T wa = __shfl_sync(0xffffffffu, wl, a);
        T* slab = mesh + static_cast<size_t>(wrap_index(bxs + o0 + a, g.nx)) *
                             (g.ny * g.nz);
        if (has0) atomicAdd(slab + g0, ((wa * wy0) * wz0) * qs);
        if (has1) atomicAdd(slab + g1, ((wa * wy1) * wz1) * qs);
      }
    }
  }
  __syncthreads();

  // the brick onto the mesh: thread t takes point t of the brick's (y, z)
  // plane (consecutive threads on consecutive z points) through every x
  // plane
  const int yz_points = cb.wy * cb.wz;
  const int x_stride = g.ny * g.nz;
  for (int t = threadIdx.x; t < yz_points; t += blockDim.x) {
    const int b = t / cb.wz, c = t - b * cb.wz;
    const int yz =
        wrap_index(by0 + b, g.ny) * g.nz + wrap_index(bz0 + c, g.nz);
    int gx = wrap_index(bx0, g.nx);
    for (int a = 0; a < cb.wx; ++a) {
      const T v = brick[a * yz_points + t];
      if (v != T(0)) atomicAdd(mesh + gx * x_stride + yz, v);
      gx = gx + 1 == g.nx ? 0 : gx + 1;
    }
  }
  if (counts) {  // uniform: every thread takes the same branch
    if (lane == 0) {
      atomicAdd(s_count, n_dep);
      atomicAdd(s_count + 1, n_spill);
    }
    __syncthreads();
    if (threadIdx.x < 2 && s_count[threadIdx.x] != 0)
      atomicAdd(counts + threadIdx.x,
                static_cast<unsigned long long>(s_count[threadIdx.x]));
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

__device__ __forceinline__ float dev_sin(float v) { return sinf(v); }
__device__ __forceinline__ double dev_sin(double v) { return sin(v); }

// K10 ad gather.  dcoef: the (p, p) derivative piece table; u: the flt
// potential mesh (ngrid / V already applied); sf: (3, nterms) acc
// self-force series.  The series is periodic in u, so its sine takes the
// fractional part of u (exact in floating point) and keeps the argument
// under 2 pi nterms; the plain version keeps the JAX package's literal
// sin(2 pi j u), the two agreeing to the rounding of the argument.
template <typename T, typename A>
__global__ void pppm_gather_ad_kernel(const T* __restrict__ x,
    const T* __restrict__ y, const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ aid, int ns, int n, T lox, T loy, T loz, T ihx,
    T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const T* __restrict__ dcoef, const T* __restrict__ boxL,
    const T* __restrict__ u, T qqrd2e, const A* __restrict__ sf, int nterms,
    A* __restrict__ fx, A* __restrict__ fy, A* __restrict__ fz) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  __shared__ T s_dcoef[kMaxOrder * kMaxOrder];
  for (int k = threadIdx.x; k < g.p * g.p; k += blockDim.x) {
    s_coef[k] = coef[k];
    s_dcoef[k] = dcoef[k];
  }
  __syncthreads();
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
  T dx[kMaxOrder], dy[kMaxOrder], dz[kMaxOrder];
  T ua[3];
  axis_weights_impl<true>(x[s], lox, ihx, g.nx, g.p, s_coef, s_dcoef, ix,
                          wx, dx, ua);
  axis_weights_impl<true>(y[s], loy, ihy, g.ny, g.p, s_coef, s_dcoef, iy,
                          wy, dy, ua + 1);
  axis_weights_impl<true>(z[s], loz, ihz, g.nz, g.p, s_coef, s_dcoef, iz,
                          wz, dz, ua + 2);
  A ex = 0, ey = 0, ez = 0;
#pragma unroll
  for (int a = 0; a < kMaxOrder; ++a) {
    if (a >= g.p) continue;
#pragma unroll
    for (int b = 0; b < kMaxOrder; ++b) {
      if (b >= g.p) continue;
      const T dxy = dx[a] * wy[b], xdy = wx[a] * dy[b], xy = wx[a] * wy[b];
      const int row = (ix[a] * g.ny + iy[b]) * g.nz;
#pragma unroll
      for (int c = 0; c < kMaxOrder; ++c) {
        if (c >= g.p) continue;
        const T um = u[row + iz[c]];
        ex += static_cast<A>((dxy * wz[c]) * um);
        ey += static_cast<A>((xdy * wz[c]) * um);
        ez += static_cast<A>((xy * dz[c]) * um);
      }
    }
  }
  const T qs = q[s];
  const A qf = static_cast<A>(qqrd2e * qs);
  const A q2 = static_cast<A>(qqrd2e * qs * qs);
  const T ih[3] = {ihx, ihy, ihz};
  A e[3] = {ex, ey, ez};
  A f[3];
  const T two_pi = static_cast<T>(6.283185307179586476925286766559);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const T frac = ua[ax] - dev_floor(ua[ax]);
    A self = 0;
    for (int j = 0; j < nterms; ++j)
      self += sf[ax * nterms + j] *
              static_cast<A>(dev_sin((two_pi * static_cast<T>(j + 1)) * frac));
    f[ax] = -(e[ax] * static_cast<A>(ih[ax])) * qf - q2 * self;
  }
  fx[s] = f[0];
  fy[s] = f[1];
  fz[s] = f[2];
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
template <typename A, bool EV, bool AD = false>
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
    if (AD) {
      // K10 ad: the potential spectrum alone (no Nyquist rule needed:
      // G rho_hat is Hermitian, so c2r and the full inverse FFT agree)
      ehat[2 * i] = pr;
      ehat[2 * i + 1] = pi;
    } else {
      const A kxe = qx ? A(0) : kxv;
      const A kye = qy ? A(0) : kyv;
      ehat[2 * i] = kxe * pi;
      ehat[2 * i + 1] = -(kxe * pr);
      ehat[2 * (npts + i)] = kye * pi;
      ehat[2 * (npts + i) + 1] = -(kye * pr);
      ehat[2 * (2 * npts + i)] = kzv * pi;
      ehat[2 * (2 * npts + i) + 1] = -(kzv * pr);
    }
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

// K10pa spectral.  out holds seven interleaved complex spectra back to
// back: phi_hat = G rhat, then c_k phi_hat for c = 1 - pref k_a k_a (xx,
// yy, zz) and -pref k_a k_b (xy, xz, yz), pref = 2 (1/k^2 + 1/(4 g^2)).
// nyq: an off-diagonal c is 0 on an interior kz plane where exactly one of
// its two axes sits on its Nyquist index (the virial convention of
// pppm_spectral_kernel: the full spectrum cancels that point against its
// mirror), so the per-atom sums equal the full-spectrum virial.
template <typename A>
__global__ void pppm_peratom_spectral_kernel(const A* __restrict__ rhat,
    const A* __restrict__ G, const A* __restrict__ kx,
    const A* __restrict__ ky, const A* __restrict__ kz,
    const A* __restrict__ wz, int nx, int ny, int nzh, A quarter_g2inv,
    int nyq, A* __restrict__ out) {
  const int npts = nx * ny * nzh;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < npts;
       i += gridDim.x * blockDim.x) {
    const int k = i % nzh;
    const int j = (i / nzh) % ny;
    const int l = i / (nzh * ny);
    const A gv = G[i];
    const A pr = gv * rhat[2 * i], pi = gv * rhat[2 * i + 1];
    const A kxv = kx[l], kyv = ky[j], kzv = kz[k];
    const A ksq = kxv * kxv + kyv * kyv + kzv * kzv;
    const A ksafe = ksq == A(0) ? A(1) : ksq;
    const A pref = A(2) * (A(1) / ksafe + quarter_g2inv);
    A c[6] = {A(1) - pref * kxv * kxv, A(1) - pref * kyv * kyv,
              A(1) - pref * kzv * kzv, -pref * kxv * kyv,
              -pref * kxv * kzv, -pref * kyv * kzv};
    if (nyq && wz[k] != A(1)) {
      const bool qx = 2 * l == nx, qy = 2 * j == ny;
      if (qx != qy) c[3] = A(0);
      if (qx) c[4] = A(0);
      if (qy) c[5] = A(0);
    }
    out[2 * i] = pr;
    out[2 * i + 1] = pi;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const size_t o = 2 * (static_cast<size_t>(m + 1) * npts + i);
      out[o] = c[m] * pr;
      out[o + 1] = c[m] * pi;
    }
  }
}

// K10pa gather, one thread per entry: the seven acc meshes interpolated
// through one stencil, point-major (meshes[point][8] = u, v_xx .. v_yz and
// a pad, so a point is one aligned vector load), scaled by scale = ngrid /
// V; eatom = qqrd2e (q u / 2 - self_c q^2 - bg_c q qsum), vatom[i][c] =
// (qqrd2e / 2) q v_c.  Entries are atoms (aid null) or the cell engine's
// slots (K18 slots, CellPPPM.compute_peratom_slots): a slot whose aid is
// n_atoms or more is empty and gets exactly 0, its position unread.
template <typename T, typename A>
__global__ void pppm_peratom_gather_kernel(const T* __restrict__ x,
    const T* __restrict__ y, const T* __restrict__ z, const T* __restrict__ q,
    const int* __restrict__ aid, int n, int n_atoms, T lox, T loy, T loz,
    T ihx, T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const A* __restrict__ meshes, A scale, A qqrd2e, A self_c, A bg_c,
    A qsum, A* __restrict__ eatom, A* __restrict__ vatom) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  stage_coef(coef, g.p, s_coef);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (aid != nullptr && aid[i] >= n_atoms) {
    eatom[i] = A(0);
#pragma unroll
    for (int v = 0; v < 6; ++v) vatom[static_cast<size_t>(i) * 6 + v] = A(0);
    return;
  }
  int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  axis_weights(x[i], lox, ihx, g.nx, g.p, s_coef, ix, wx);
  axis_weights(y[i], loy, ihy, g.ny, g.p, s_coef, iy, wy);
  axis_weights(z[i], loz, ihz, g.nz, g.p, s_coef, iz, wz);
  A s[7] = {0, 0, 0, 0, 0, 0, 0};
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
        const A w = static_cast<A>(wxy * wz[c]);
        A m[8];
        load8(meshes + 8 * static_cast<size_t>(row + iz[c]), m);
#pragma unroll
        for (int v = 0; v < 7; ++v) s[v] += w * m[v];
      }
    }
  }
  const A qi = static_cast<A>(q[i]);
  eatom[i] = (A(0.5) * qi * (s[0] * scale) - self_c * qi * qi -
              bg_c * qi * qsum) * qqrd2e;
  const A h = A(0.5) * qqrd2e * qi;
  A* vi = vatom + static_cast<size_t>(i) * 6;
#pragma unroll
  for (int v = 0; v < 6; ++v) vi[v] = h * (s[v + 1] * scale);
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

template <typename T>
int launch_deposit_cells(const void* x, const void* y, const void* z,
                         const void* q, const void* aid, int cap, int n,
                         const double* lo, const double* ih, MeshGeom g,
                         CellBrick cb, const void* coef, void* mesh,
                         void* counts, cudaStream_t st) {
  const int ncell = cb.ncx * cb.ncy * cb.ncz;
  const size_t bytes = sizeof(T) * cb.wx * cb.wy * cb.wz;
  pppm_deposit_kernel_cells<T><<<ncell, kCellThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(q),
      static_cast<const int*>(aid), cap, n, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g, cb,
      static_cast<const T*>(coef), static_cast<T*>(mesh),
      static_cast<unsigned long long*>(counts));
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

template <typename A, bool EV, bool AD = false>
int launch_spectral(const void* rhat, const void* G, const void* kx,
                    const void* ky, const void* kz, const void* wz, int nx,
                    int ny, int nzh, double quarter_g2inv, int nyq,
                    void* ehat, void* partial, int nblocks, cudaStream_t st) {
  pppm_spectral_kernel<A, EV, AD><<<nblocks, kThreads, 0, st>>>(
      static_cast<const A*>(rhat), static_cast<const A*>(G),
      static_cast<const A*>(kx), static_cast<const A*>(ky),
      static_cast<const A*>(kz), static_cast<const A*>(wz), nx, ny, nzh,
      static_cast<A>(quarter_g2inv), nyq, static_cast<A*>(ehat),
      static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// K10 slab, pass 1: partial[block] = (sum q z, sum q z^2) in acc over a
// grid-stride range, reduced per block in a fixed shuffle tree.
template <typename T, typename A>
__global__ void slab_sums_kernel(const T* __restrict__ z,
                                 const T* __restrict__ q, int n,
                                 A* __restrict__ partial) {
  A m = 0, m2 = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const A qa = static_cast<A>(q[i]), za = static_cast<A>(z[i]);
    m += qa * za;
    m2 += (qa * za) * za;
  }
  __shared__ A red[kThreads / 32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_sum(m);
  m2 = warp_sum(m2);
  if (lane == 0) {
    red[warp][0] = m;
    red[warp][1] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    A a = warp_sum(lane < nwarps ? red[lane][0] : A(0));
    A b = warp_sum(lane < nwarps ? red[lane][1] : A(0));
    if (lane == 0) {
      partial[2 * blockIdx.x] = a;
      partial[2 * blockIdx.x + 1] = b;
    }
  }
}

// K10 slab, pass 2: every block adds the partials in order (the same M and
// M2 in every block), then fz[i] += ffact q_i (M - Q z_i) and / or
// eatom[i] += efact q_i (z_i M - (M2 + Q z_i^2) / 2 - Q zprd^2 / 12); block
// 0 writes e_slab.  boxL (the atoms' box on the card) gives the extended V
// and zprd with the slab factor, else the host's V and zprd.
template <typename T, typename A>
__global__ void slab_apply_kernel(const T* __restrict__ z,
                                  const T* __restrict__ q, int n,
                                  const A* __restrict__ partial, int nparts,
                                  A qsum, A qqrd2e, A vol, A zprd,
                                  const T* __restrict__ boxL, A slab,
                                  A* __restrict__ fz, A* __restrict__ eatom,
                                  A* __restrict__ e_out) {
  __shared__ A s_m, s_m2, s_v, s_zp;
  if (threadIdx.x == 0) {
    A m = 0, m2 = 0;
    for (int b = 0; b < nparts; ++b) {
      m += partial[2 * b];
      m2 += partial[2 * b + 1];
    }
    s_m = m;
    s_m2 = m2;
    if (boxL) {
      const A lz = static_cast<A>(boxL[2]) * slab;
      s_v = static_cast<A>(boxL[0]) * static_cast<A>(boxL[1]) * lz;
      s_zp = lz;
    } else {
      s_v = vol;
      s_zp = zprd;
    }
  }
  __syncthreads();
  const A m = s_m, m2 = s_m2, v = s_v, zp = s_zp;
  const A two_pi = static_cast<A>(6.283185307179586476925286766559);
  const A c12 = qsum * qsum * zp * zp / A(12);
  if (e_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    e_out[0] = (two_pi / v) * (m * m - qsum * m2 - c12) * qqrd2e;
  const A ffact = -(A(2) * two_pi / v) * qqrd2e;
  const A efact = qqrd2e * two_pi / v;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const A qa = static_cast<A>(q[i]), za = static_cast<A>(z[i]);
    if (fz != nullptr) fz[i] += ffact * qa * (m - qsum * za);
    if (eatom != nullptr)
      eatom[i] += efact * qa *
                  (za * m - A(0.5) * (m2 + qsum * za * za) - qsum * zp * zp /
                   A(12));
  }
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

// K5 by cell.  prec: 0 = float, 1 = double (the slot-plane / mesh type).
// The ns slots are grouped by coarse cell, cap = ns / (ncx ncy ncz) each
// (cells numbered (cx ncy + cy) ncz + cz); each mesh axis is a whole
// multiple of its cell count.  The brick of cell c starts at mesh point
// c * (n / nc) + o on each axis and spans w points; w_x w_y w_z points of
// the flt type may take at most pppm_brick_bytes() bytes.  mesh must be
// zeroed by the caller; lo and invh as in pppm_deposit (no box on the
// card); counts: null or int64[2] on the card (deposited, spilled).
extern "C" int pppm_brick_bytes() { return kMaxBrickBytes; }

extern "C" int pppm_deposit_cells(int prec, const void* x, const void* y,
                                  const void* z, const void* q,
                                  const void* aid, int ns, int n,
                                  double lox, double loy, double loz,
                                  double ihx, double ihy, double ihz, int nx,
                                  int ny, int nz, int order,
                                  const void* coef, int ncx, int ncy, int ncz,
                                  int ox, int oy, int oz, int wx, int wy,
                                  int wz, void* mesh, void* counts,
                                  void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || ncx <= 0 || ncy <= 0 || ncz <= 0 || nx % ncx ||
      ny % ncy || nz % ncz || wx < order || wy < order || wz < order)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ncell = static_cast<long long>(ncx) * ncy * ncz;
  if (ns <= 0 || ns % ncell) return static_cast<int>(cudaErrorInvalidValue);
  const size_t size = prec == 0 ? sizeof(float) : sizeof(double);
  if (size * wx * wy * wz > static_cast<size_t>(kMaxBrickBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const CellBrick cb{ncx, ncy, ncz, nx / ncx, ny / ncy, nz / ncz,
                     ox, oy, oz, wx, wy, wz};
  const int cap = static_cast<int>(ns / ncell);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case 0:
      return launch_deposit_cells<float>(x, y, z, q, aid, cap, n, lo, ih, g,
                                         cb, coef, mesh, counts, s);
    case 1:
      return launch_deposit_cells<double>(x, y, z, q, aid, cap, n, lo, ih, g,
                                          cb, coef, mesh, counts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// prec: 0 = float, 1 = double (the acc type).  ev != 0 writes
// partial[nblocks][7]; nyq as in pppm_spectral_kernel.  ad != 0 is K10 ad
// spectral: ehat holds one interleaved complex (nx, ny, nzh) potential
// spectrum in place of three field spectra; the same sums and nyq.
extern "C" int pppm_spectral(int prec, int ev, int ad, const void* rhat,
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
  switch (prec * 4 + (ad ? 2 : 0) + (ev ? 1 : 0)) {
    case 0: return launch_spectral<float, false>(SPECTRAL_ARGS);
    case 1: return launch_spectral<float, true>(SPECTRAL_ARGS);
    case 2: return launch_spectral<float, false, true>(SPECTRAL_ARGS);
    case 3: return launch_spectral<float, true, true>(SPECTRAL_ARGS);
    case 4: return launch_spectral<double, false>(SPECTRAL_ARGS);
    case 5: return launch_spectral<double, true>(SPECTRAL_ARGS);
    case 6: return launch_spectral<double, false, true>(SPECTRAL_ARGS);
    case 7: return launch_spectral<double, true, true>(SPECTRAL_ARGS);
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

// K10pa spectral.  prec: 0 = float, 1 = double (the acc type); rhat and G
// as in pppm_spectral; out: 7 interleaved complex (nx, ny, nzh) spectra.
extern "C" int pppm_peratom_spectral(int prec, const void* rhat,
                                     const void* G, const void* kx,
                                     const void* ky, const void* kz,
                                     const void* wz, int nx, int ny, int nzh,
                                     double quarter_g2inv, int nyq, void* out,
                                     int nblocks, void* stream) {
  if (nblocks <= 0 || nx <= 0 || ny <= 0 || nzh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PERATOM_SPECTRAL(A)                                                  \
  pppm_peratom_spectral_kernel<A><<<nblocks, kThreads, 0, s>>>(              \
      static_cast<const A*>(rhat), static_cast<const A*>(G),                 \
      static_cast<const A*>(kx), static_cast<const A*>(ky),                  \
      static_cast<const A*>(kz), static_cast<const A*>(wz), nx, ny, nzh,     \
      static_cast<A>(quarter_g2inv), nyq, static_cast<A*>(out))
  switch (prec) {
    case 0: PERATOM_SPECTRAL(float); break;
    case 1: PERATOM_SPECTRAL(double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PERATOM_SPECTRAL
  return static_cast<int>(cudaGetLastError());
}

// K10pa gather (and K18 slots with aid).  prec: 0 = (float, float), 1 =
// (float, double), 2 = (double, double) for (flt, acc).  x, y, z, q: (n,)
// flt entries, atoms (aid null) or slots (aid (n) int32, empty where aid
// >= n_atoms); lo, invh: the mesh origin and 1/h; meshes: (nx * ny * nz,
// 8) acc, each point's u, v_xx .. v_yz and a pad, 16-byte aligned; eatom
// (n) and vatom (n, 6) acc.
extern "C" int pppm_peratom_gather(int prec, const void* x, const void* y,
                                   const void* z, const void* q,
                                   const void* aid, int n, int n_atoms,
                                   double lox, double loy, double loz,
                                   double ihx, double ihy, double ihz,
                                   int nx, int ny, int nz, int order,
                                   const void* coef, const void* meshes,
                                   double scale, double qqrd2e,
                                   double self_c, double bg_c, double qsum,
                                   void* eatom, void* vatom, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PERATOM_GATHER(T, A)                                                 \
  pppm_peratom_gather_kernel<T, A><<<slot_blocks(n), kThreads, 0, s>>>(      \
      static_cast<const T*>(x), static_cast<const T*>(y),                    \
      static_cast<const T*>(z), static_cast<const T*>(q),                    \
      static_cast<const int*>(aid), n, n_atoms, static_cast<T>(lox),         \
      static_cast<T>(loy), static_cast<T>(loz),                              \
      static_cast<T>(ihx), static_cast<T>(ihy), static_cast<T>(ihz), g,      \
      static_cast<const T*>(coef), static_cast<const A*>(meshes),            \
      static_cast<A>(scale), static_cast<A>(qqrd2e),                         \
      static_cast<A>(self_c), static_cast<A>(bg_c), static_cast<A>(qsum),    \
      static_cast<A*>(eatom), static_cast<A*>(vatom))
  switch (prec) {
    case 0: PERATOM_GATHER(float, float); break;
    case 1: PERATOM_GATHER(float, double); break;
    case 2: PERATOM_GATHER(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PERATOM_GATHER
  return static_cast<int>(cudaGetLastError());
}

// K10 ad gather.  prec as in pppm_gather; lo, invh and boxL as in
// pppm_deposit, except that with boxL invh holds the k-space box's factors
// (1, 1, slab); dcoef: the (p, p) flt derivative piece table; u: the flt
// potential mesh; sf: (3, nterms) acc.
extern "C" int pppm_gather_ad(int prec, const void* x, const void* y,
                              const void* z, const void* q, const void* aid,
                              int ns, int n, double lox, double loy,
                              double loz, double ihx, double ihy, double ihz,
                              int nx, int ny, int nz, int order,
                              const void* coef, const void* dcoef,
                              const void* boxL, const void* u, double qqrd2e,
                              const void* sf, int nterms, void* fx, void* fy,
                              void* fz, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || nterms < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ns <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATHER_AD(T, A)                                                      \
  pppm_gather_ad_kernel<T, A><<<slot_blocks(ns), kThreads, 0, s>>>(          \
      static_cast<const T*>(x), static_cast<const T*>(y),                    \
      static_cast<const T*>(z), static_cast<const T*>(q),                    \
      static_cast<const int*>(aid), ns, n, static_cast<T>(lox),              \
      static_cast<T>(loy), static_cast<T>(loz), static_cast<T>(ihx),         \
      static_cast<T>(ihy), static_cast<T>(ihz), g,                           \
      static_cast<const T*>(coef), static_cast<const T*>(dcoef),             \
      static_cast<const T*>(boxL), static_cast<const T*>(u),                 \
      static_cast<T>(qqrd2e), static_cast<const A*>(sf), nterms,             \
      static_cast<A*>(fx), static_cast<A*>(fy), static_cast<A*>(fz))
  switch (prec) {
    case 0: GATHER_AD(float, float); break;
    case 1: GATHER_AD(float, double); break;
    case 2: GATHER_AD(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATHER_AD
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the K10 slab sums pass (the rows of its partial array).
extern "C" int pppm_slab_parts(int n, int nsm) {
  const int want = 2 * nsm;
  const int need = slot_blocks(n);
  return need < want ? need : want;
}

// K10 slab.  prec as in pppm_gather (z, q and boxL of the flt type; fz,
// eatom, e_out and partial of the acc type).  fz (n) and eatom (n) are
// added to when not null; e_out (one value) is written when not null;
// partial: (nparts, 2) scratch, nparts = pppm_slab_parts(n, SMs).  With
// boxL not null V and zprd come from it and the slab factor.
extern "C" int pppm_slab(int prec, const void* z, const void* q, int n,
                         double qsum, double qqrd2e, double vol, double zprd,
                         const void* boxL, double slab, void* fz,
                         void* eatom, void* e_out, void* partial, int nparts,
                         void* stream) {
  if (n <= 0 || nparts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SLAB(T, A)                                                           \
  slab_sums_kernel<T, A><<<nparts, kThreads, 0, s>>>(                        \
      static_cast<const T*>(z), static_cast<const T*>(q), n,                 \
      static_cast<A*>(partial));                                             \
  slab_apply_kernel<T, A><<<slot_blocks(n), kThreads, 0, s>>>(               \
      static_cast<const T*>(z), static_cast<const T*>(q), n,                 \
      static_cast<const A*>(partial), nparts, static_cast<A>(qsum),          \
      static_cast<A>(qqrd2e), static_cast<A>(vol), static_cast<A>(zprd),     \
      static_cast<const T*>(boxL), static_cast<A>(slab),                     \
      static_cast<A*>(fz), static_cast<A*>(eatom), static_cast<A*>(e_out))
  switch (prec) {
    case 0: SLAB(float, float); break;
    case 1: SLAB(float, double); break;
    case 2: SLAB(double, double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLAB
  return static_cast<int>(cudaGetLastError());
}
