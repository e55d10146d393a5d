// stft_gcc_frontend_cuda: the fused analysis front-end on Hopper.
//
// Replaces gccnmf_tpu/ops/frontend_pallas.py::stft_gcc_frontend_pallas
// (body _frontend_kernel). The TPU kernel assembles frames in VMEM from
// hop-sized rows with pltpu.roll. Here frame t is a strided view of the
// signal, x[t*hop + j], staged straight into shared-memory tiles, so no
// frame tensor ever reaches device memory. Two launches:
//
//   1. dft_coherence_kernel: for a (time, bin) tile, the windowed rDFT of
//      both channels as GEMMs against the host-built [window·cos |
//      ±window·sin] basis (conjugation sign folded in), then in the epilogue
//      |X| per channel and the PHAT coherence X0·conj(X1)/(|X0||X1|) with
//      the guarded divide; writes spec re/im, V and coherence re/im planes
//      (fp32 or bf16).
//   2. angular_kernel: the angular spectrogram Re(C)@cos + Im(C)@sin from
//      the stored coherence planes, stored fp32. Reading the stored planes
//      rounds them exactly as the TPU kernel's bf16 GEMM operands do.
//
// What bounds it on the card: 8·T·win·F + 4·T·F·D flop per utterance
// (about 5.6 GFLOP at the reference shape) against about 13 MB of fp32
// planes written, so the products bound it; they run as fp32 FMAs on the
// SIMT cores here (bf16 mode rounds the operands first).
//
// Planes are exactly F bins wide: the port emits no padded lanes.
#include "common.cuh"

using namespace gccnmf;

namespace {

template <typename TP>
__global__ void __launch_bounds__(NTHREADS)
dft_coherence_kernel(const float* __restrict__ x, long n, int hop, int win,
                     const float* __restrict__ wcos, const float* __restrict__ wsin,
                     int T, int F, bool rnd, TP* __restrict__ sre, TP* __restrict__ sim,
                     TP* __restrict__ mag, TP* __restrict__ cre, TP* __restrict__ cim) {
  __shared__ __align__(16) TileA A0, A1;
  __shared__ __align__(16) TileB Bc, Bs;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* x0 = x + (long)b * 2 * n;
  const float* x1 = x0 + n;
  float re0[4][4], im0[4][4], re1[4][4], im1[4][4];
  zero(re0); zero(im0); zero(re1); zero(im1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int j0 = 0; j0 < win; j0 += BK) {
    stage_a<true>(A0, x0, hop, 1, m0, j0, T, win, rnd);  // (t, j) at x[t*hop + j]
    stage_a<true>(A1, x1, hop, 1, m0, j0, T, win, rnd);
    stage_b<true>(Bc, wcos, F, 1, j0, n0, win, F, rnd);  // (j, f) at basis[j*F + f]
    stage_b<true>(Bs, wsin, F, 1, j0, n0, win, F, rnd);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a0[4], a1[4], c[4], s[4];
      load4(&A0[k][ty * 4], a0);
      load4(&A1[k][ty * 4], a1);
      load4(&Bc[k][tx * 4], c);
      load4(&Bs[k][tx * 4], s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re0[i][j] = fmaf(a0[i], c[j], re0[i][j]);
          im0[i][j] = fmaf(a0[i], s[j], im0[i][j]);
          re1[i][j] = fmaf(a1[i], c[j], re1[i][j]);
          im1[i][j] = fmaf(a1[i], s[j], im1[i][j]);
        }
    }
    __syncthreads();
  }
  const long ch = (long)T * F;  // one channel plane
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = out_col(n0, j);
      if (f >= F) continue;
      const float r0 = re0[i][j], i0 = im0[i][j], r1 = re1[i][j], i1 = im1[i][j];
      const float m0v = sqrtf(r0 * r0 + i0 * i0);
      const float m1v = sqrtf(r1 * r1 + i1 * i1);
      const long p = (long)b * 2 * ch + (long)t * F + f;  // channel 0 of (B, 2, T, F)
      sre[p] = from_f32<TP>(r0);
      sre[p + ch] = from_f32<TP>(r1);
      sim[p] = from_f32<TP>(i0);
      sim[p + ch] = from_f32<TP>(i1);
      mag[p] = from_f32<TP>(m0v);
      mag[p + ch] = from_f32<TP>(m1v);
      const float den = m0v * m1v;
      const float inv = den > TINY ? 1.0f / den : 0.0f;
      const long c = (long)b * ch + (long)t * F + f;  // (B, T, F)
      cre[c] = from_f32<TP>((r0 * r1 + i0 * i1) * inv);
      cim[c] = from_f32<TP>((i0 * r1 - r0 * i1) * inv);
    }
  }
}

// ang[t,d] = Σ_f cre[t,f]·cos[f,d] + cim[t,f]·sin[f,d]
template <typename TP>
__global__ void __launch_bounds__(NTHREADS)
angular_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim,
               const float* __restrict__ cosm, const float* __restrict__ sinm,
               float* __restrict__ ang, int T, int F, int D, bool rnd) {
  __shared__ __align__(16) TileA Ar, Ai;
  __shared__ __align__(16) TileB Bc, Bs;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TP* cr = cre + (long)b * T * F;
  const TP* ci = cim + (long)b * T * F;
  float acc[4][4];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += BK) {
    stage_a<true>(Ar, cr, F, 1, m0, f0, T, F, rnd);  // (t, f) at C[t*F + f]
    stage_a<true>(Ai, ci, F, 1, m0, f0, T, F, rnd);
    stage_b<true>(Bc, cosm, D, 1, f0, n0, F, D, rnd);  // (f, d) at cos[f*D + d]
    stage_b<true>(Bs, sinm, D, 1, f0, n0, F, D, rnd);
    __syncthreads();
    tile_fma(Ar, Bc, acc);
    tile_fma(Ai, Bs, acc);
    __syncthreads();
  }
  float* ab = ang + (long)b * T * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = out_col(n0, j);
      if (d < D) ab[(long)t * D + d] = acc[i][j];
    }
  }
}

template <typename TP>
cudaError_t run(const float* x, int B, long n, int hop, int win, const float* wcos,
                const float* wsin, const float* cosm, const float* sinm, int T, int F,
                int D, bool rnd, TP* sre, TP* sim, TP* mag, TP* cre, TP* cim, float* ang,
                cudaStream_t st) {
  dft_coherence_kernel<TP><<<tile_grid(T, F, B), NTHREADS, 0, st>>>(
      x, n, hop, win, wcos, wsin, T, F, rnd, sre, sim, mag, cre, cim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  angular_kernel<TP><<<tile_grid(T, D, B), NTHREADS, 0, st>>>(cre, cim, cosm, sinm, ang,
                                                              T, F, D, rnd);
  return cudaGetLastError();
}

}  // namespace

// x: (B, 2, n) f32; wcos/wsin: (win, F) f32; cosm/sinm: (F, D) f32;
// sre/sim/mag: (B, 2, T, F) and cre/cim: (B, T, F), bf16 if plane_bf16
// else f32; ang: (B, T, D) f32. rnd rounds every GEMM operand to bf16.
extern "C" int gccnmf_frontend(const float* x, int B, long n, int hop, int win,
                               const float* wcos, const float* wsin, const float* cosm,
                               const float* sinm, int T, int F, int D, int rnd,
                               int plane_bf16, void* sre, void* sim, void* mag,
                               void* cre, void* cim, float* ang, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run<bf16>(x, B, n, hop, win, wcos, wsin, cosm, sinm, T, F, D, rnd != 0,
                          static_cast<bf16*>(sre), static_cast<bf16*>(sim),
                          static_cast<bf16*>(mag), static_cast<bf16*>(cre),
                          static_cast<bf16*>(cim), ang, st);
  return (int)run<float>(x, B, n, hop, win, wcos, wsin, cosm, sinm, T, F, D, rnd != 0,
                         static_cast<float*>(sre), static_cast<float*>(sim),
                         static_cast<float*>(mag), static_cast<float*>(cre),
                         static_cast<float*>(cim), ang, st);
}
