// Dispersion PPPM: the multi-channel deposit, the half-spectrum solve and
// the multi-channel ik gather of the r^-6 channels, and their per-atom
// energy and virial (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/models/kspace/pppm_disp.py
//   _disp_compute_multi (:283): its deposit of each channel (:303-306, one
//   deposit_rho per channel), its spectral part (:303-352 and the ik
//   spectra :422-424), its gather (:405-426: the stencil weights once, then
//   each channel's field, scaled by the channel charge), and the
//   dispersion branch of pppm_cells.py CellPPPM._spectral (:819-870) that
//   CellPPPMDisp (:1160) runs.  The reference does the deposit of all
//   channels in one particle pass (pppm_disp_intel.cpp:315-467, make_rho_a
//   and make_rho_none).
// Per atom (K12pa), pppm_disp.py _disp_peratom_multi (:427, from
//   PPPMDisp.compute_peratom :197; the eflag_atom / vflag_atom dispersion
//   corrections of pppm_disp_intel.cpp:512-537), after disp_deposit and
//   one batched rfftn:
//   disp_peratom_spectral <- chi = P S, phi = G chi and the six virial
//     spectra (:463-485);
//   disp_peratom_gather   <- every channel's energy and six virial meshes
//     interpolated at the entry, times a_c / 2, with the k = 0 and self
//     terms (:466-509), after one batched irfftn.
//   In slot order on the cell-aligned mesh (K18 slots, pppm_cells.py
//   CellPPPM._peratom_disp_slots :1062): the same gather over the slots,
//   their aid plane marking the empty ones.
//
// Channel charges.  Entry s (an atom, or a slot of the cell engine) carries
// a_c = table[c][row[s]] on channel c: the typed pipelines read the (nch,
// T + 1) table of A[c, type] (a last column of zeros for empty slots,
// whose row is T), the geometric one a (1, N + 1) table of per-atom B.  A
// table of at most kStageMax entries is staged in shared memory.
//
// disp_deposit (K12b): one thread per entry.  The order-p weights and the
// folded mesh indices of its stencil (csrc/pppm_stencil.cuh, the weights
// of csrc/pppm.cu) are computed once; then for each channel whose charge is
// not zero, (w_x w_y) w_z a_c is added with atomicAdd to that channel's
// mesh, mesh (nch, nx, ny, nz) in flt (zeroed by the caller), the layout
// the batched rfftn reads.  It replaces nch launches of the charge deposit
// (csrc/pppm.cu pppm_deposit), each of which recomputed the stencil and
// reread the positions.
//
// disp_gather (K12c): one thread per entry; the weights once, then for
// each channel the sum over the stencil of w E_c (three fields, read from
// e (nch, 3, nx, ny, nz) flt, the batched irfftn's output) in acc in the
// order of csrc/pppm.cu's gather, times a_c, summed over the channels in
// order: f (3 planes of the entries, acc).
// It replaces nch launches of the ik gather (pppm_gather) and nch - 1
// elementwise sums of their outputs.  An entry whose charges are all zero
// (an empty slot) writes zero and reads nothing.
//
// disp_spectral (K12a): one thread per point of the rfft half spectrum
// (nx, ny, nz/2 + 1), in a grid-stride loop.  For nch channels S_c (the
// rfftn of each channel's mesh) and the pairing P (nch, nch, at most 8):
//   chi_c = sum_d P_cd S_d,  phi_c = G chi_c,
//   ehat[c][a] = -i k_a phi_c (three spectra per channel),
// and with EV the energy and virial sums over the half spectrum,
//   ek = G Re(sum_c S_c conj(chi_c)) wz,
//   partial[block] = (sum ek, sum ek (1 + vfac kx kx), ... (1 + vfac ky
//   ky), (1 + vfac kz kz), sum ek vfac kx ky, ek vfac kx kz, ek vfac ky kz),
// reduced per block by a fixed shuffle tree; the caller adds the rows in
// a fixed order (torch.sum), so the sums are deterministic.  vfac is
// [d ln w / dk] / k of the dispersion kernel w(k), a static table: the
// Coulomb kernel (csrc/pppm.cu pppm_spectral) hard-codes its own virial
// factor 2 (1/k^2 + 1/4g^2), so the dispersion solve is a kernel of its
// own, not a flag on that one.  The k = 0 term e0 and the self term are
// the caller's.
//
// disp_peratom_spectral (K12pa spectral): one thread per half-spectrum
// point, in a grid-stride loop; it reads every channel's S once, forms chi_c
// = sum_d P_cd S_d and phi_c = G chi_c, and writes out[c] (7 complex
// spectra per channel: phi_c, then c_m phi_c for the virial factors c =
// (1 + vfac kx kx, 1 + vfac ky ky, 1 + vfac kz kz, vfac kx ky, vfac kx kz,
// vfac ky kz)), the layout one batched irfftn reads.  The dispersion
// energy and virial sums are half-spectrum sums (weights wz) like the
// irfftn's implied Hermitian completion, so the per-atom shares sum to
// them on even meshes as on odd ones: no Nyquist rule (unlike csrc/pppm.cu
// pppm_peratom_spectral's nyq).
//
// disp_peratom_gather (K12pa gather, K18 slots): one thread per entry.  The
// weights once, then per channel whose charge is not zero the sum over the
// stencil of w times the channel's seven meshes, read point-major (meshes
// (nch, npoints, 8) acc: u, v_xx .. v_yz and a pad, one aligned load a
// point, the wrapper's copy, as pppm_peratom_gather reads them); eatom =
// sum_c a_c / 2 u_c scale + k0c (a . P asum) + selfc (a . P . a), vatom_m =
// sum_c a_c / 2 v_cm scale (+ the k = 0 share on the diagonal), scale =
// ngrid / V, k0c = w0 / (2 V), selfc = g6^6 / 12.  An entry whose charges
// are all zero, or a slot whose aid is n_atoms or more, writes 0 and reads
// nothing.
//
// What bounds them on the H100.
//   disp_deposit: p^3 atomics per entry and channel onto meshes that stay
//     in the 50 MB L2 (2 x 2.3 M points at the 259,200-atom silica deck,
//     18.7 MB in f32); bytes (positions and rows once, the meshes written
//     once) give a floor of a few microseconds, atomic throughput on
//     overlapping stencils bounds it, as it bounds pppm_deposit.
//   disp_gather: 3 p^3 reads of the fields per entry and channel (L2
//     resident), ~2 flops each; L2 read bandwidth bounds it.
//   disp_spectral: bytes.  Per point it reads S (nch complex) and G (vfac
//     too with EV) and writes 3 nch complex spectra: with nch = 1 in f32,
//     36 bytes a point, 97 MB on the 154 x 187 x 187 mesh of the
//     192,000-atom hexane deck (2.7 M points on the half spectrum), 0.03 ms
//     at 3.35 TB/s; the arithmetic is ~10 flops a point and channel.
//   disp_peratom_spectral: bytes.  Per point S (nch complex), G and vfac
//     read, 7 nch complex written: 2 channels in f32 at the 259,200-atom
//     silica deck's 144 x 150 x 55 half spectrum, 2.4 M points, 148 MB.
//   disp_peratom_gather: p^3 reads of 32 bytes per entry and channel (f32),
//     14 flops each; the point-major meshes (74 MB a channel at 144 x 150 x
//     108) exceed the L2 with two channels, so the channel loop runs the
//     threads in flight over one channel's meshes at a time.
//
// Precision: the deposit in flt (the JAX mesh dtype); the spectral solve
// in acc; the gather flt weights and fields, acc sums.  -O3 without
// --use_fast_math.  Kernels launch on the caller's stream, allocate
// nothing, return cudaGetLastError().

#include <cuda_runtime.h>

#include "pppm_stencil.cuh"

namespace {

using namespace pppm_stencil;

constexpr int kThreads = 256;
constexpr int kMaxCh = 8;
// channel-charge tables of at most this many entries are staged in shared
// memory (16 KB in f64); larger ones (per-atom charges) are read in place
constexpr int kStageMax = 2048;

// The table the entries read: staged in dynamic shared memory when small.
template <typename T>
__device__ __forceinline__ const T* stage_table(const T* table, int count,
                                                T* s_tab) {
  if (count > kStageMax) return table;
  for (int k = threadIdx.x; k < count; k += blockDim.x) s_tab[k] = table[k];
  __syncthreads();
  return s_tab;
}

// The stencil loops run the x planes in a loop (their weights read from a
// small local array), y and z unrolled: a channel loop around a fully
// unrolled stencil would let the compiler hoist the p^3 addresses out of
// it (255 registers and spills).  The deposit touches every channel at
// each stencil point (the channel loop unrolled to kMaxCh with a guard);
// the gather sums one channel's fields over the stencil, then the next,
// so that the threads in flight read one channel's fields at a time (the
// 7 channels' fields of the 192,000-atom hexane deck are 392 MB, beyond
// the 50 MB L2; one channel's are 56 MB).
template <typename T>
__global__ void disp_deposit_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const int* __restrict__ row, int ns,
    const T* __restrict__ table, int ntab, int nch, T lox, T loy, T loz,
    T ihx, T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    T* __restrict__ mesh) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* tab = stage_table(table, nch * ntab,
                             reinterpret_cast<T*>(smem_raw));
  stage_coef(coef, g.p, s_coef);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const int r = row[s];
  T ac[kMaxCh];
  bool any = false;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    ac[c] = c < nch ? tab[c * ntab + r] : T(0);
    any |= ac[c] != T(0);
  }
  if (!any) return;
  int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
  axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
  axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
  const size_t ng = static_cast<size_t>(g.nx) * g.ny * g.nz;
#pragma unroll 1
  for (int a = 0; a < g.p; ++a) {
    const T wxa = wx[a];
    const int rowx = ix[a] * g.ny;
#pragma unroll
    for (int b = 0; b < kMaxOrder; ++b) {
      if (b >= g.p) continue;
      const T wxy = wxa * wy[b];
      const int off = (rowx + iy[b]) * g.nz;
#pragma unroll
      for (int k = 0; k < kMaxOrder; ++k) {
        if (k >= g.p) continue;
        const T w = wxy * wz[k];
        const size_t m = off + iz[k];
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if (c < nch && ac[c] != T(0))
            atomicAdd(mesh + c * ng + m, w * ac[c]);
        }
      }
    }
  }
}

template <typename T, typename A>
__global__ void disp_gather_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const int* __restrict__ row, int ns,
    const T* __restrict__ table, int ntab, int nch, T lox, T loy, T loz,
    T ihx, T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const T* __restrict__ e, A* __restrict__ fx, A* __restrict__ fy,
    A* __restrict__ fz) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* tab = stage_table(table, nch * ntab,
                             reinterpret_cast<T*>(smem_raw));
  stage_coef(coef, g.p, s_coef);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const int r = row[s];
  T ac[kMaxCh];
  bool any = false;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    ac[c] = c < nch ? tab[c * ntab + r] : T(0);
    any |= ac[c] != T(0);
  }
  A fxs = 0, fys = 0, fzs = 0;
  if (any) {
    int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
    T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
    axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
    axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
    axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
    const size_t ng = static_cast<size_t>(g.nx) * g.ny * g.nz;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const T* e_c = e + 3 * c * ng;
      A ex = 0, ey = 0, ez = 0;
#pragma unroll 1
      for (int a = 0; a < g.p; ++a) {
        const T wxa = wx[a];
        const int rowx = ix[a] * g.ny;
#pragma unroll
        for (int b = 0; b < kMaxOrder; ++b) {
          if (b >= g.p) continue;
          const T wxy = wxa * wy[b];
          const int off = (rowx + iy[b]) * g.nz;
#pragma unroll
          for (int k = 0; k < kMaxOrder; ++k) {
            if (k >= g.p) continue;
            const T w = wxy * wz[k];
            const size_t m = off + iz[k];
            ex += static_cast<A>(w * e_c[m]);
            ey += static_cast<A>(w * e_c[ng + m]);
            ez += static_cast<A>(w * e_c[2 * ng + m]);
          }
        }
      }
      const A a_c = static_cast<A>(tab[c * ntab + r]);
      fxs += ex * a_c;
      fys += ey * a_c;
      fzs += ez * a_c;
    }
  }
  fx[s] = fxs;
  fy[s] = fys;
  fz[s] = fzs;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// S: (nch, npts) interleaved complex; P: (nch, nch) row-major; ehat:
// (nch, 3, npts) interleaved complex; partial: [gridDim.x][7] with EV.
template <typename A, bool EV>
__global__ void disp_spectral_kernel(
    const A* __restrict__ S, const A* __restrict__ P, int nch,
    const A* __restrict__ G, const A* __restrict__ vfac,
    const A* __restrict__ kx, const A* __restrict__ ky,
    const A* __restrict__ kz, const A* __restrict__ wz, int nx, int ny,
    int nzh, A* __restrict__ ehat, A* __restrict__ partial) {
  __shared__ A s_P[kMaxCh * kMaxCh];
  for (int i = threadIdx.x; i < nch * nch; i += blockDim.x) s_P[i] = P[i];
  __syncthreads();
  const int npts = nx * ny * nzh;
  A s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < npts;
       i += gridDim.x * blockDim.x) {
    const int k = i % nzh;
    const int j = (i / nzh) % ny;
    const int l = i / (nzh * ny);
    A sre[kMaxCh], sim[kMaxCh];
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < nch) {
        sre[c] = S[2 * (static_cast<size_t>(c) * npts + i)];
        sim[c] = S[2 * (static_cast<size_t>(c) * npts + i) + 1];
      }
    }
    const A gv = G[i];
    const A kxv = kx[l], kyv = ky[j], kzv = kz[k];
    A re_sum = 0;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c >= nch) break;
      A cre = 0, cim = 0;
#pragma unroll
      for (int d = 0; d < kMaxCh; ++d) {
        if (d >= nch) break;
        const A p = s_P[c * nch + d];
        cre += p * sre[d];
        cim += p * sim[d];
      }
      const A pr = gv * cre, pi = gv * cim;
      A* e = ehat + 2 * (static_cast<size_t>(c) * 3 * npts + i);
      e[0] = kxv * pi;
      e[1] = -(kxv * pr);
      e[2 * npts] = kyv * pi;
      e[2 * npts + 1] = -(kyv * pr);
      e[4 * static_cast<size_t>(npts)] = kzv * pi;
      e[4 * static_cast<size_t>(npts) + 1] = -(kzv * pr);
      if (EV) re_sum += sre[c] * cre + sim[c] * cim;
    }
    if (EV) {
      const A ek = gv * re_sum * wz[k];
      const A vf = vfac[i];
      s0 += ek;
      s1 += ek * (A(1) + vf * kxv * kxv);
      s2 += ek * (A(1) + vf * kyv * kyv);
      s3 += ek * (A(1) + vf * kzv * kzv);
      s4 += ek * (vf * kxv * kyv);
      s5 += ek * (vf * kxv * kzv);
      s6 += ek * (vf * kyv * kzv);
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

// K12pa spectral.  S: (nch, npts) interleaved complex; P: (nch, nch)
// row-major; out: (nch, 7, npts) interleaved complex.
template <typename A>
__global__ void disp_peratom_spectral_kernel(
    const A* __restrict__ S, const A* __restrict__ P, int nch,
    const A* __restrict__ G, const A* __restrict__ vfac,
    const A* __restrict__ kx, const A* __restrict__ ky,
    const A* __restrict__ kz, int nx, int ny, int nzh,
    A* __restrict__ out) {
  __shared__ A s_P[kMaxCh * kMaxCh];
  for (int i = threadIdx.x; i < nch * nch; i += blockDim.x) s_P[i] = P[i];
  __syncthreads();
  const int npts = nx * ny * nzh;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < npts;
       i += gridDim.x * blockDim.x) {
    const int k = i % nzh;
    const int j = (i / nzh) % ny;
    const int l = i / (nzh * ny);
    A sre[kMaxCh], sim[kMaxCh];
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < nch) {
        sre[c] = S[2 * (static_cast<size_t>(c) * npts + i)];
        sim[c] = S[2 * (static_cast<size_t>(c) * npts + i) + 1];
      }
    }
    const A gv = G[i], vf = vfac[i];
    const A kxv = kx[l], kyv = ky[j], kzv = kz[k];
    const A f[6] = {A(1) + vf * kxv * kxv, A(1) + vf * kyv * kyv,
                    A(1) + vf * kzv * kzv, vf * kxv * kyv, vf * kxv * kzv,
                    vf * kyv * kzv};
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c >= nch) break;
      A cre = 0, cim = 0;
#pragma unroll
      for (int d = 0; d < kMaxCh; ++d) {
        if (d >= nch) break;
        const A p = s_P[c * nch + d];
        cre += p * sre[d];
        cim += p * sim[d];
      }
      const A pr = gv * cre, pi = gv * cim;
      A* o = out + 2 * (static_cast<size_t>(c) * 7 * npts + i);
      o[0] = pr;
      o[1] = pi;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const size_t off = 2 * static_cast<size_t>(m + 1) * npts;
        o[off] = f[m] * pr;
        o[off + 1] = f[m] * pi;
      }
    }
  }
}

// K12pa gather and K18 slots (see the header).  meshes: (nch, npoints, 8)
// acc point-major; P (nch, nch) and Pasum = P asum (nch) acc; eatom (ns)
// and vatom (ns, 6) acc.  aid null: every entry counts.
template <typename T, typename A>
__global__ void disp_peratom_gather_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ z, const int* __restrict__ row, int ns,
    const T* __restrict__ table, int ntab, int nch, T lox, T loy, T loz,
    T ihx, T ihy, T ihz, MeshGeom g, const T* __restrict__ coef,
    const int* __restrict__ aid, int n_atoms, const A* __restrict__ meshes,
    const A* __restrict__ P, const A* __restrict__ Pasum, A scale, A k0c,
    A selfc, A* __restrict__ eatom, A* __restrict__ vatom) {
  __shared__ T s_coef[kMaxOrder * kMaxOrder];
  __shared__ A s_P[kMaxCh * kMaxCh], s_Pa[kMaxCh];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* tab = stage_table(table, nch * ntab,
                             reinterpret_cast<T*>(smem_raw));
  for (int i = threadIdx.x; i < nch * nch; i += blockDim.x) s_P[i] = P[i];
  for (int i = threadIdx.x; i < nch; i += blockDim.x) s_Pa[i] = Pasum[i];
  stage_coef(coef, g.p, s_coef);  // its __syncthreads covers the stages
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  A ac[kMaxCh];
  bool any = false;
  const bool live = aid == nullptr || aid[s] < n_atoms;
  const int r = live ? row[s] : 0;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    ac[c] = (live && c < nch) ? static_cast<A>(tab[c * ntab + r]) : A(0);
    any |= ac[c] != A(0);
  }
  A e = 0, v[6] = {0, 0, 0, 0, 0, 0};
  if (any) {
    int ix[kMaxOrder], iy[kMaxOrder], iz[kMaxOrder];
    T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
    axis_weights(x[s], lox, ihx, g.nx, g.p, s_coef, ix, wx);
    axis_weights(y[s], loy, ihy, g.ny, g.p, s_coef, iy, wy);
    axis_weights(z[s], loz, ihz, g.nz, g.p, s_coef, iz, wz);
    const size_t ng = static_cast<size_t>(g.nx) * g.ny * g.nz;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      if (ac[c] == A(0)) continue;
      const A* m_c = meshes + 8 * ng * c;
      A sv[7] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
      for (int a = 0; a < g.p; ++a) {
        const T wxa = wx[a];
        const int rowx = ix[a] * g.ny;
#pragma unroll
        for (int b = 0; b < kMaxOrder; ++b) {
          if (b >= g.p) continue;
          const T wxy = wxa * wy[b];
          const int off = (rowx + iy[b]) * g.nz;
#pragma unroll
          for (int k = 0; k < kMaxOrder; ++k) {
            if (k >= g.p) continue;
            const A w = static_cast<A>(wxy * wz[k]);
            A m[8];
            load8(m_c + 8 * static_cast<size_t>(off + iz[k]), m);
#pragma unroll
            for (int q = 0; q < 7; ++q) sv[q] += w * m[q];
          }
        }
      }
      const A h = A(0.5) * ac[c];
      e += h * (sv[0] * scale);
#pragma unroll
      for (int q = 0; q < 6; ++q) v[q] += h * (sv[q + 1] * scale);
    }
    // the k = 0 share (sums to e0) and the self term
    A apa = 0, c6 = 0;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c >= nch) break;
      apa += ac[c] * s_Pa[c];
      A pc = 0;
#pragma unroll
      for (int d = 0; d < kMaxCh; ++d) {
        if (d >= nch) break;
        pc += s_P[c * nch + d] * ac[d];
      }
      c6 += ac[c] * pc;
    }
    const A k0 = k0c * apa;
    e = e + k0 + selfc * c6;
    v[0] += k0;
    v[1] += k0;
    v[2] += k0;
  }
  eatom[s] = e;
  A* vs = vatom + static_cast<size_t>(s) * 6;
#pragma unroll
  for (int q = 0; q < 6; ++q) vs[q] = v[q];
}

template <typename A, bool EV>
int launch(const void* S, const void* P, int nch, const void* G,
           const void* vfac, const void* kx, const void* ky, const void* kz,
           const void* wz, int nx, int ny, int nzh, void* ehat,
           void* partial, int nblocks, cudaStream_t st) {
  disp_spectral_kernel<A, EV><<<nblocks, kThreads, 0, st>>>(
      static_cast<const A*>(S), static_cast<const A*>(P), nch,
      static_cast<const A*>(G), static_cast<const A*>(vfac),
      static_cast<const A*>(kx), static_cast<const A*>(ky),
      static_cast<const A*>(kz), static_cast<const A*>(wz), nx, ny, nzh,
      static_cast<A*>(ehat), static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

inline int entry_blocks(int ns) { return (ns + kThreads - 1) / kThreads; }

template <typename T>
size_t table_smem(int nch, int ntab) {
  return nch * ntab <= kStageMax ? sizeof(T) * nch * ntab : 0;
}

template <typename T>
int launch_deposit(const void* x, const void* y, const void* z,
                   const void* row, int ns, const void* table, int ntab,
                   int nch, const double* lo, const double* ih, MeshGeom g,
                   const void* coef, void* mesh, cudaStream_t st) {
  if (ns <= 0) return 0;
  disp_deposit_kernel<T><<<entry_blocks(ns), kThreads,
                           table_smem<T>(nch, ntab), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const int*>(row), ns,
      static_cast<const T*>(table), ntab, nch, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g,
      static_cast<const T*>(coef), static_cast<T*>(mesh));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_gather(const void* x, const void* y, const void* z,
                  const void* row, int ns, const void* table, int ntab,
                  int nch, const double* lo, const double* ih, MeshGeom g,
                  const void* coef, const void* e, void* fx, void* fy,
                  void* fz, cudaStream_t st) {
  if (ns <= 0) return 0;
  disp_gather_kernel<T, A><<<entry_blocks(ns), kThreads,
                             table_smem<T>(nch, ntab), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const int*>(row), ns,
      static_cast<const T*>(table), ntab, nch, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g,
      static_cast<const T*>(coef), static_cast<const T*>(e),
      static_cast<A*>(fx), static_cast<A*>(fy), static_cast<A*>(fz));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_peratom_gather(const void* x, const void* y, const void* z,
                          const void* row, int ns, const void* table,
                          int ntab, int nch, const double* lo,
                          const double* ih, MeshGeom g, const void* coef,
                          const void* aid, int n_atoms, const void* meshes,
                          const void* P, const void* Pasum, double scale,
                          double k0c, double selfc, void* eatom, void* vatom,
                          cudaStream_t st) {
  if (ns <= 0) return 0;
  disp_peratom_gather_kernel<T, A><<<entry_blocks(ns), kThreads,
                                     table_smem<T>(nch, ntab), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const int*>(row), ns,
      static_cast<const T*>(table), ntab, nch, static_cast<T>(lo[0]),
      static_cast<T>(lo[1]), static_cast<T>(lo[2]), static_cast<T>(ih[0]),
      static_cast<T>(ih[1]), static_cast<T>(ih[2]), g,
      static_cast<const T*>(coef), static_cast<const int*>(aid), n_atoms,
      static_cast<const A*>(meshes), static_cast<const A*>(P),
      static_cast<const A*>(Pasum), static_cast<A>(scale),
      static_cast<A>(k0c), static_cast<A>(selfc), static_cast<A*>(eatom),
      static_cast<A*>(vatom));
  return static_cast<int>(cudaGetLastError());
}

bool channels_ok(int nch, int ntab) {
  return nch > 0 && nch <= kMaxCh && ntab > 0;
}

}  // namespace

// Threads per block (the partials have one row per block) and the largest
// channel count.
extern "C" int disp_threads() { return kThreads; }
extern "C" int disp_max_channels() { return kMaxCh; }

// K12b.  prec: 0 = float, 1 = double (the position, table and mesh type).
// row (ns) int32 columns of table (nch, ntab), every row < ntab; lo and
// invh the mesh origin and 1/h per axis; coef the (order, order) spline
// piece table; mesh (nch, nx, ny, nz) zeroed by the caller.
extern "C" int disp_deposit(int prec, const void* x, const void* y,
                            const void* z, const void* row, int ns,
                            const void* table, int ntab, int nch, double lox,
                            double loy, double loz, double ihx, double ihy,
                            double ihz, int nx, int ny, int nz, int order,
                            const void* coef, void* mesh, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || !channels_ok(nch, ntab))
    return static_cast<int>(cudaErrorInvalidValue);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEPOSIT_ARGS \
  x, y, z, row, ns, table, ntab, nch, lo, ih, g, coef, mesh, s
  switch (prec) {
    case 0: return launch_deposit<float>(DEPOSIT_ARGS);
    case 1: return launch_deposit<double>(DEPOSIT_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEPOSIT_ARGS
}

// K12c.  prec: 0 = (float, float), 1 = (float, double), 2 = (double,
// double) for (flt, acc).  e (nch, 3, nx, ny, nz) flt fields; fx/fy/fz
// (ns) acc.  The other arguments as in disp_deposit.
extern "C" int disp_gather(int prec, const void* x, const void* y,
                           const void* z, const void* row, int ns,
                           const void* table, int ntab, int nch, double lox,
                           double loy, double loz, double ihx, double ihy,
                           double ihz, int nx, int ny, int nz, int order,
                           const void* coef, const void* e, void* fx,
                           void* fy, void* fz, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || !channels_ok(nch, ntab))
    return static_cast<int>(cudaErrorInvalidValue);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATHER_ARGS \
  x, y, z, row, ns, table, ntab, nch, lo, ih, g, coef, e, fx, fy, fz, s
  switch (prec) {
    case 0: return launch_gather<float, float>(GATHER_ARGS);
    case 1: return launch_gather<float, double>(GATHER_ARGS);
    case 2: return launch_gather<double, double>(GATHER_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATHER_ARGS
}

// prec: 0 = float, 1 = double (the acc type).  ev != 0 writes
// partial[nblocks][7].
extern "C" int disp_spectral(int prec, int ev, const void* S, const void* P,
                             int nch, const void* G, const void* vfac,
                             const void* kx, const void* ky, const void* kz,
                             const void* wz, int nx, int ny, int nzh,
                             void* ehat, void* partial, int nblocks,
                             void* stream) {
  if (nblocks <= 0 || nx <= 0 || ny <= 0 || nzh <= 0 || nch <= 0 ||
      nch > kMaxCh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DISP_ARGS \
  S, P, nch, G, vfac, kx, ky, kz, wz, nx, ny, nzh, ehat, partial, nblocks, s
  switch (prec * 2 + (ev ? 1 : 0)) {
    case 0: return launch<float, false>(DISP_ARGS);
    case 1: return launch<float, true>(DISP_ARGS);
    case 2: return launch<double, false>(DISP_ARGS);
    case 3: return launch<double, true>(DISP_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DISP_ARGS
}

// K12pa spectral.  prec: 0 = float, 1 = double (the acc type).  S (nch,
// nx, ny, nzh) complex, P (nch, nch), G and vfac (nx, ny, nzh), the wave
// vectors per axis; out (nch, 7, nx, ny, nzh) complex.
extern "C" int disp_peratom_spectral(int prec, const void* S, const void* P,
                                     int nch, const void* G,
                                     const void* vfac, const void* kx,
                                     const void* ky, const void* kz, int nx,
                                     int ny, int nzh, void* out, int nblocks,
                                     void* stream) {
  if (nblocks <= 0 || nx <= 0 || ny <= 0 || nzh <= 0 || nch <= 0 ||
      nch > kMaxCh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_SPECTRAL(A)                                                       \
  disp_peratom_spectral_kernel<A><<<nblocks, kThreads, 0, s>>>(              \
      static_cast<const A*>(S), static_cast<const A*>(P), nch,               \
      static_cast<const A*>(G), static_cast<const A*>(vfac),                 \
      static_cast<const A*>(kx), static_cast<const A*>(ky),                  \
      static_cast<const A*>(kz), nx, ny, nzh, static_cast<A*>(out))
  switch (prec) {
    case 0: PA_SPECTRAL(float); break;
    case 1: PA_SPECTRAL(double); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA_SPECTRAL
  return static_cast<int>(cudaGetLastError());
}

// K12pa gather and K18 slots.  prec: 0 = (float, float), 1 = (float,
// double), 2 = (double, double) for (flt, acc).  The entry arguments as in
// disp_deposit; aid (ns) int32 or null, n_atoms; meshes (nch, nx ny nz, 8)
// acc point-major, 16-byte aligned; P (nch, nch) and Pasum (nch) acc;
// scale = ngrid / V, k0c = w0 / (2 V), selfc = g6^6 / 12; eatom (ns) and
// vatom (ns, 6) acc.
extern "C" int disp_peratom_gather(int prec, const void* x, const void* y,
                                   const void* z, const void* row, int ns,
                                   const void* table, int ntab, int nch,
                                   double lox, double loy, double loz,
                                   double ihx, double ihy, double ihz,
                                   int nx, int ny, int nz, int order,
                                   const void* coef, const void* aid,
                                   int n_atoms, const void* meshes,
                                   const void* P, const void* Pasum,
                                   double scale, double k0c, double selfc,
                                   void* eatom, void* vatom, void* stream) {
  const MeshGeom g{nx, ny, nz, order};
  if (!geom_ok(g) || !channels_ok(nch, ntab))
    return static_cast<int>(cudaErrorInvalidValue);
  const double lo[3] = {lox, loy, loz}, ih[3] = {ihx, ihy, ihz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_GATHER_ARGS                                                      \
  x, y, z, row, ns, table, ntab, nch, lo, ih, g, coef, aid, n_atoms, meshes, \
      P, Pasum, scale, k0c, selfc, eatom, vatom, s
  switch (prec) {
    case 0: return launch_peratom_gather<float, float>(PA_GATHER_ARGS);
    case 1: return launch_peratom_gather<float, double>(PA_GATHER_ARGS);
    case 2: return launch_peratom_gather<double, double>(PA_GATHER_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA_GATHER_ARGS
}
