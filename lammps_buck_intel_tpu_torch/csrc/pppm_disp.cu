// Dispersion PPPM: the half-spectrum solve of the r^-6 channels (sm_90a).
//
// Replaces: lammps_buck_intel_tpu/models/kspace/pppm_disp.py
//   _disp_compute_multi (:283; the spectral part :303-352 and the ik
//   spectra :422-424) and the dispersion branch of pppm_cells.py
//   CellPPPM._spectral (:819-870) that CellPPPMDisp (:1160) runs.
// The deposit and the gather of the same pipeline are csrc/pppm.cu's
// kernels with the dispersion charge a = B[type] in place of q (and
// qqrd2e = 1): they compute what the JAX deposit and gather compute.
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
// host scalars (the caller's).
//
// What bounds it on the H100: bytes.  Per point it reads S (nch complex)
// and G (vfac too with EV) and writes 3 nch complex spectra: with nch = 1
// in f32, 36 bytes a point, 97 MB on the 154 x 187 x 187 mesh of the
// 192,000-atom hexane deck (2.7 M points on the half spectrum), 0.03 ms
// at 3.35 TB/s; the arithmetic is ~10 flops a point and channel.
//
// Precision: acc throughout (the JAX spectral dtype).  -O3 without
// --use_fast_math.  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCh = 8;

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

}  // namespace

// Threads per block (the partials have one row per block) and the largest
// channel count.
extern "C" int disp_threads() { return kThreads; }
extern "C" int disp_max_channels() { return kMaxCh; }

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
