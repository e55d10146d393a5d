// Shared SIMT tile machinery for the port's hand-written Hopper kernels.
//
// Its remaining users: the syntheses' spectra GEMMs (synthesis.cu's
// spectra_kernel, enhance.cu's wiener_spectra_kernel) in every mode, and
// the front-end's float32 angular product (frontend.cu angular_kernel; the
// float32 DFTs are FFTs on the passes of fft.cuh). They run a plain
// tiled SIMT GEMM: a 64x64 output tile per 256-thread block, a 16-deep
// contraction slice staged in shared memory one scalar at a time, a 4x4
// register micro-tile per thread, fp32 fused multiply-adds, with no
// copy/compute overlap. The bf16 modes round each GEMM operand to bf16
// (round-to-nearest-even) as it is staged, which is exactly JAX's "bf16
// operands, fp32 accumulation" contract (the product of two bf16 values is
// exact in fp32). Sums run in a fixed order, with no atomics, so two runs
// give bit-identical results.
//
// What bounds it: fp32 FMAs at 16-21 TFLOP/s on an H100 (PERF.md), scalar
// staging loads with a bf16 round at each. Its users are small GEMMs (the
// float32 front-end is bound by bytes).
// The float32 NMF and soft-mask scores run on the pipelined core of
// simt_gemm.cuh; the bf16 products of the NMF, of the soft mask's scores,
// of the syntheses' iDFT and of the front-end's rDFT and angular
// spectrogram on the tensor cores (tc_gemm.cuh). This file also holds
// the helpers every source shares (bf16 conversions, the guarded divide,
// elementwise launch sizes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gccnmf {

constexpr int BM = 64;         // output tile rows
constexpr int BN = 64;         // output tile columns
constexpr int BK = 16;         // contraction slice per stage
constexpr int PAD = 4;         // keeps rows 16-byte aligned for float4 reads
constexpr int NTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float TINY = 1e-30f; // the JAX kernels' double-where threshold

typedef float TileA[BK][BM + PAD];  // As[kk][m]
typedef float TileB[BK][BN + PAD];  // Bs[kk][n]

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// a / b, or 0 where b <= 1e-30 (the double-where guard; IEEE divide).
__device__ __forceinline__ float safe_div(float a, float b) {
  return b > TINY ? a / b : 0.0f;
}

// Stage the BM x BK slice of A whose element (m, k) sits at a[m*sm + k*sk].
// KC: consecutive threads walk k (sk == 1), else m (sm == 1), so global
// reads coalesce either way. Out-of-range elements stage as 0 (ragged edges
// are masked, never padded in memory).
template <bool KC, typename T>
__device__ __forceinline__ void stage_a(TileA& As, const T* a, long sm, long sk,
                                        int m0, int k0, int M, int K, bool rnd) {
  for (int e = threadIdx.x; e < BM * BK; e += NTHREADS) {
    const int m = KC ? e / BK : e % BM;
    const int k = KC ? e % BK : e / BM;
    const int gm = m0 + m, gk = k0 + k;
    float x = 0.0f;
    if (gm < M && gk < K) {
      x = to_f32(a[gm * sm + gk * sk]);
      if (rnd) x = round_bf16(x);
    }
    As[k][m] = x;
  }
}

// Stage the BK x BN slice of B whose element (k, n) sits at b[k*sk + n*sn].
// NC: consecutive threads walk n (sn == 1), else k (sk == 1).
template <bool NC, typename T>
__device__ __forceinline__ void stage_b(TileB& Bs, const T* b, long sk, long sn,
                                        int k0, int n0, int K, int N, bool rnd) {
  for (int e = threadIdx.x; e < BK * BN; e += NTHREADS) {
    const int n = NC ? e % BN : e / BK;
    const int k = NC ? e / BN : e % BK;
    const int gk = k0 + k, gn = n0 + n;
    float x = 0.0f;
    if (gk < K && gn < N) {
      x = to_f32(b[gk * sk + gn * sn]);
      if (rnd) x = round_bf16(x);
    }
    Bs[k][n] = x;
  }
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// acc[i][j] += Σ_k As[k][ty*4+i] · Bs[k][tx*4+j] over the staged slice.
__device__ __forceinline__ void tile_fma(const TileA& As, const TileB& Bs,
                                         float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4];
    load4(&As[k][ty * 4], a);
    load4(&Bs[k][tx * 4], b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Output coordinates of this thread's micro-tile element (i, j).
__device__ __forceinline__ int out_row(int m0, int i) { return m0 + (threadIdx.x / 16) * 4 + i; }
__device__ __forceinline__ int out_col(int n0, int j) { return n0 + (threadIdx.x % 16) * 4 + j; }

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Blocks of 256 threads for a grid-stride loop over total items: one item
// a thread, capped at 16 blocks an SM.
inline int elementwise_blocks(long total) {
  const long blocks = (total + 255) / 256, cap = 132L * 16;
  return (int)(blocks < cap ? blocks : cap);
}

// The (column tile, row tile, batch) grid of a common.cuh product. CUDA caps
// gridDim.y at 65,535, so rows past 4,194,240 (65,535 tiles of 64) cannot
// launch. No path comes near it: the syntheses' spectra GEMMs and the
// front-end tile T frames of one utterance (1,243 at 10 s, hop 128), or
// B·T at the enhancer's 16 utterances.
inline dim3 tile_grid(int rows, int cols, int batch) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, batch);
}

}  // namespace gccnmf
