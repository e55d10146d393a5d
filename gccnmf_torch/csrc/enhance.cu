// soft_mask_cuda and tf_synthesis_cuda: the offline-enhancement tail on Hopper.
//
// Replaces gccnmf_tpu/ops/enhance_pallas.py::soft_mask_pallas (body
// _mask_kernel) and ::tf_synthesis_pallas (body _tf_synth_kernel).
//
// Soft mask. For every row m = (b, t) of the batch's frames and atom k:
//
//   s[m,d,k] = Σ_f Re c[m,f]·cw[d,f,k] + Im c[m,f]·sw[d,f,k]
//   d*[m,k]  = first d with the largest s (strict >; NaN never wins; an
//              all-NaN column gives 0)
//   h_mask   = exp(−(|d* − target_b|/ε_b)^β_b)/(1 + floor_b) + floor_b,
//              with x^β as exp(β·log x) and distance 0 pinned to x^β = 0
//
// with cw[d] = cos_d ⊗ W and sw[d] = sin_d ⊗ W the steering-folded
// dictionary, built once by the wrapper (bf16 in the bf16 mode, which is
// where JAX's make_mm rounds the folded product). The enhancer's W is shared
// across the batch, so the rows are the frames of all utterances together,
// as the TPU kernel concatenates batch tiles into one row block.
//
//   1. score_argmax_kernel: a (64 rows × 64 atoms) block loops over its
//      chunk of TDOAs; for each d it runs the tiled GEMM over F against
//      cw[d] and sw[d] and folds the 4 × 4 scores of each thread into a
//      running (max, argmax) held in registers. The (B, T, D, K) scores
//      never reach device memory (1.3 GB at B = 16, T = 1,243, D = K = 128).
//      When the frames alone give too few blocks to fill the card (one or
//      two utterances), the TDOAs are split into chunks across blocks.
//   2. mask_kernel: merges the chunks' (max, argmax) in chunk order with the
//      same strict > (so the first maximum still wins) and applies the mask
//      with the parameters of the row's utterance. It can also write the
//      argmax, which only the checks read.
//
// Every score is the same fixed sequence of FMAs whatever the batch or the
// split, so the argmax does not depend on either.
//
// Wiener synthesis. For z = (b, c):
//
//   tf[b,t,f] = Σ_k h_mask[b,t,k]·Wn[k,f],  Wn = (W / Σ_k W)ᵀ
//   X_z       = tf ⊙ planes[b,c]           (both channels from one GEMM)
//   y_z       = overlap-add(X_z·[A; −B]), trimmed by window/2 at each end
//
//   1. wiener_spectra_kernel: the tf GEMM over rows (b, t), the channel
//      multiply in its epilogue in fp32; writes Re X, Im X (bf16 in the bf16
//      mode, which is where JAX's next make_mm rounds them).
//   2. frames_kernel and 3. ola_kernel from istft.cuh, unchanged.
//
// What bounds them on the card: in the bf16 mode, where JAX rounds the folded
// product, the soft mask needs 4·B·T·F·D·K flop (669 GFLOP at B = 16,
// T = 1,243, F = 513, D = K = 128; in float32, 2·B·T·F·D·K + 3·B·T·F·D, by
// forming Re c·cos_d + Im c·sin_d first) against tens of MB of planes, so
// the products bound it by far. The synthesis as computed here is
// 2·B·T·(K·F + C·2·F·win) flop (86 GFLOP at B = 16) against about 190 MB;
// in float32 an FFT would need far fewer operations than its iDFT GEMM.
// Both run as fp32 FMAs on the SIMT cores, with bf16-rounded operands in the
// bf16 mode.
#include <math.h>

#include "common.cuh"
#include "istft.cuh"

using namespace gccnmf;

namespace {

// Running (max, argmax) over d in [split·chunk, min(D, (split+1)·chunk)) of
// s[m,d,k] for the block's (64 × 64) tile of (rows m, atoms k); written to
// pmax/parg at [split, m, k].
template <typename TP, typename TW>
__global__ void __launch_bounds__(NTHREADS)
score_argmax_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim, int ldf,
                    const TW* __restrict__ cw, const TW* __restrict__ sw,
                    float* __restrict__ pmax, int* __restrict__ parg, int M, int F, int K,
                    int D, int chunk, bool rnd) {
  __shared__ __align__(16) TileA Ar, Ai;
  __shared__ __align__(16) TileB Bc, Bs;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int d0 = split * chunk, d1 = min(D, d0 + chunk);
  float best[4][4];
  int arg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[i][j] = -INFINITY;
      arg[i][j] = d0;
    }
  for (int d = d0; d < d1; ++d) {
    const TW* cwd = cw + (long)d * F * K;
    const TW* swd = sw + (long)d * F * K;
    float acc[4][4];
    zero(acc);
    for (int f0 = 0; f0 < F; f0 += BK) {
      stage_a<true>(Ar, cre, ldf, 1, m0, f0, M, F, rnd);  // (m, f) at c[m*ldf + f]
      stage_a<true>(Ai, cim, ldf, 1, m0, f0, M, F, rnd);
      stage_b<true>(Bc, cwd, K, 1, f0, n0, F, K, rnd);    // (f, k) at cw[d][f*K + k]
      stage_b<true>(Bs, swd, K, 1, f0, n0, F, K, rnd);
      __syncthreads();
      tile_fma(Ar, Bc, acc);
      tile_fma(Ai, Bs, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (acc[i][j] > best[i][j]) {  // strict: the first maximum wins; NaN never
          best[i][j] = acc[i][j];
          arg[i][j] = d;
        }
  }
  const long base = (long)split * M * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = out_row(m0, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = out_col(n0, j);
      if (k >= K) continue;
      pmax[base + (long)m * K + k] = best[i][j];
      parg[base + (long)m * K + k] = arg[i][j];
    }
  }
}

// Merge the chunks in order and apply the soft mask; params is (B, 4):
// target, ε, β, floor per utterance.
__global__ void mask_kernel(const float* __restrict__ pmax, const int* __restrict__ parg,
                            const float* __restrict__ params, float* __restrict__ hmask,
                            int* __restrict__ argout, int M, int T, int K, int splits) {
  const long total = (long)M * K;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    float best = -INFINITY;
    int arg = 0;
    for (int s = 0; s < splits; ++s) {
      const float v = pmax[s * total + idx];
      if (v > best) {
        best = v;
        arg = parg[s * total + idx];
      }
    }
    const float* p = params + 4L * ((idx / K) / T);
    const float target = p[0], eps = p[1], beta = p[2], floor_ = p[3];
    const float dist = fabsf((float)arg - target) / eps;
    const float pw = dist > 0.0f ? expf(beta * logf(fmaxf(dist, TINY))) : 0.0f;
    hmask[idx] = expf(-pw) / (1.0f + floor_) + floor_;
    if (argout) argout[idx] = arg;
  }
}

// Re X, Im X for z = (b, c): X[t,f] = (Σ_k hm[b,t,k]·Wn[k,f])·plane[b,c,t,f],
// over rows m = (b, t) so one GEMM serves every channel.
template <typename TP, typename TX>
__global__ void __launch_bounds__(NTHREADS)
wiener_spectra_kernel(const TP* __restrict__ sre, const TP* __restrict__ sim, int ldf,
                      const float* __restrict__ hm, const float* __restrict__ wn,
                      TX* __restrict__ xr, TX* __restrict__ xi, int M, int T, int C, int F,
                      int K, bool rnd) {
  __shared__ __align__(16) TileA As;
  __shared__ __align__(16) TileB Bs;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_a<true>(As, hm, K, 1, m0, k0, M, K, rnd);  // (m, k) at hm[m*K + k]
    stage_b<true>(Bs, wn, F, 1, k0, n0, K, F, rnd);  // (k, f) at Wn[k*F + f]
    __syncthreads();
    tile_fma(As, Bs, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = out_row(m0, i);
    if (m >= M) continue;
    const int b = m / T, t = m % T;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = out_col(n0, j);
      if (f >= F) continue;
      for (int c = 0; c < C; ++c) {
        const long z = (long)b * C + c;
        const long plane = (z * T + t) * ldf + f;
        const long out = (z * T + t) * F + f;
        xr[out] = from_f32<TX>(acc[i][j] * to_f32(sre[plane]));
        xi[out] = from_f32<TX>(acc[i][j] * to_f32(sim[plane]));
      }
    }
  }
}

template <typename TP, typename TW>
cudaError_t run_mask(const TP* cre, const TP* cim, int ldf, const TW* cw, const TW* sw,
                     const float* params, float* pmax, int* parg, float* hmask, int* argout,
                     int B, int T, int F, int K, int D, int splits, int chunk, bool rnd,
                     cudaStream_t st) {
  const int M = B * T;
  score_argmax_kernel<TP, TW><<<tile_grid(M, K, splits), NTHREADS, 0, st>>>(
      cre, cim, ldf, cw, sw, pmax, parg, M, F, K, D, chunk, rnd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)M * K;
  const long blocks = (total + 255) / 256, cap = 132L * 16;
  mask_kernel<<<(int)(blocks < cap ? blocks : cap), 256, 0, st>>>(pmax, parg, params, hmask,
                                                                  argout, M, T, K, splits);
  return cudaGetLastError();
}

template <typename TP, typename TX>
cudaError_t run_tf(const TP* sre, const TP* sim, int ldf, const float* hm, const float* wn,
                   const float* basis_a, const float* basis_b, TX* xr, TX* xi, TX* frames,
                   float* out, int B, int C, int T, int F, int K, int win, int hop, bool rnd,
                   cudaStream_t st) {
  const int M = B * T;
  wiener_spectra_kernel<TP, TX><<<tile_grid(M, F, 1), NTHREADS, 0, st>>>(
      sre, sim, ldf, hm, wn, xr, xi, M, T, C, F, K, rnd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_istft<TX>(xr, xi, basis_a, basis_b, frames, out, B * C, T, F, win, hop, rnd, st);
}

}  // namespace

// cre/cim: (B, T, ldf) coherence planes, bf16 if plane_bf16 else f32,
// ldf >= F; cw/sw: (D, F, K) folded dictionary, bf16 if dict_bf16 else f32;
// params: (B, 4) f32; pmax/parg: (splits, B·T, K) scratch with
// splits = ceil(D / chunk); hmask: (B, T, K) f32; argout: (B, T, K) int32
// or null.
extern "C" int gccnmf_soft_mask(const void* cre, const void* cim, int plane_bf16, int ldf,
                                const void* cw, const void* sw, int dict_bf16,
                                const float* params, float* pmax, int* parg, float* hmask,
                                int* argout, int B, int T, int F, int K, int D, int splits,
                                int chunk, int rnd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GCCNMF_RUN(TP, TW)                                                                \
  return (int)run_mask<TP, TW>(static_cast<const TP*>(cre), static_cast<const TP*>(cim), \
                               ldf, static_cast<const TW*>(cw),                          \
                               static_cast<const TW*>(sw), params, pmax, parg, hmask,    \
                               argout, B, T, F, K, D, splits, chunk, rnd != 0, st)
  if (plane_bf16) {
    if (dict_bf16) GCCNMF_RUN(bf16, bf16);
    GCCNMF_RUN(bf16, float);
  }
  if (dict_bf16) GCCNMF_RUN(float, bf16);
  GCCNMF_RUN(float, float);
#undef GCCNMF_RUN
}

// sre/sim: (B, C, T, ldf) planes, bf16 if plane_bf16 else f32, ldf >= F;
// hmask: (B, T, K) f32; wn: (K, F) f32; basis_a/basis_b: (F, win) f32
// (basis_b already negated); xr/xi: (B·C, T, F) and frames: (B·C, T, win)
// scratch, bf16 if rnd else f32; out: (B, C, (T−1)·hop) f32.
extern "C" int gccnmf_tf_synthesis(const void* sre, const void* sim, int plane_bf16, int ldf,
                                   const float* hmask, const float* wn, const float* basis_a,
                                   const float* basis_b, void* xr, void* xi, void* frames,
                                   float* out, int B, int C, int T, int F, int K, int win,
                                   int hop, int rnd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GCCNMF_RUN(TP, TX)                                                                  \
  return (int)run_tf<TP, TX>(static_cast<const TP*>(sre), static_cast<const TP*>(sim), ldf, \
                             hmask, wn, basis_a, basis_b, static_cast<TX*>(xr),             \
                             static_cast<TX*>(xi), static_cast<TX*>(frames), out, B, C, T,  \
                             F, K, win, hop, rnd != 0, st)
  if (plane_bf16) {
    if (rnd) GCCNMF_RUN(bf16, bf16);
    GCCNMF_RUN(bf16, float);
  }
  if (rnd) GCCNMF_RUN(float, bf16);
  GCCNMF_RUN(float, float);
#undef GCCNMF_RUN
}
