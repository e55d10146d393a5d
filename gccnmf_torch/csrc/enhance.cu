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
// What bounds it: in the bf16 mode, where JAX rounds the folded product, the
// soft mask needs 4·B·T·F·D·K flop (669 GFLOP at B = 16, T = 1,243,
// F = 513, D = K = 128; 0.68 ms at the bf16 tensor-core peak) against tens
// of MB of planes and dictionary, so the products bound it by far. In
// float32 the least work is 2·B·T·F·D·K + 3·B·T·F·D (forming
// Re c·cos_d + Im c·sin_d first), but the kernel keeps JAX's function and
// its 4·B·T·F·D·K (below).
//
// bf16 mode, on the tensor cores (tc_gemm.cuh):
//   1. coherence_rows_kernel packs the planes into bf16 rows
//      A[m] = [Re c[m, :F] | Im c[m, :F] | 0] of ldj = 2F rounded up to 64
//      (rows of whole 128-byte lines for the copies; the planes themselves
//      are F = 513 wide).
//      The wrapper keeps the fold in the same layout, built once with the
//      enhancer: B_d[k] = [cw[d, :, k] | sw[d, :, k] | 0], (D, K, ldj).
//      Each score is then one 2F-deep product, s[m,d,k] = A[m]·B_d[k].
//   2. tma_score_argmax_kernel (scores.cu): a block of 128 rows × two
//      TDOAs' 128 atoms walks its chunk of TDOAs a pair at a time, the
//      64-deep slices of A and of the pair's B_d, B_d+1 (17 at F = 513)
//      copied by TMA into a 4-stage ring and multiplied by wgmma
//      m64n256k16, one ring across the pairs; two row tiles a cluster share
//      the fold's copies by multicast. When the pair's last slice is in,
//      each thread folds its accumulators into a running (max, argmax) (the
//      argmax as d − d0, a byte each, in shared memory) and zeroes them.
//      The (B, T, D, K) scores never reach device memory (31 GB at the
//      enhancement cell's shape). scores.cu says what bounds it.
//   When the frames alone give too few blocks to fill the card (one or two
//   utterances), the wrapper splits the TDOAs into chunks across blocks.
//   3. mask_kernel: merges the chunks' (max, argmax) in chunk order with the
//      same strict > (so the first maximum still wins) and applies the mask
//      with the parameters of the row's utterance. It can also write the
//      argmax, which only the checks read.
// float32 mode runs on the SIMT cores (no tensor-core path is exact fp32),
// with the pipelined fp32 core of simt_gemm.cuh:
//   1. coherence_rows_f32_kernel packs the planes into fp32 rows
//      [Re c | Im c | 0] of ldj floats (16-byte rows).
//   2. simt_score_argmax_kernel: a block of 128 rows × 64 atoms streams, for
//      each d of its chunk, the 2F-deep product of those rows (K-major,
//      float4 loads through registers) against [cw[d]; sw[d]] (MN-major,
//      cp.async from the two planes) in 8-deep slices, one continuous
//      3-stage ring across the d's, 8 × 8 outputs a thread; when d's last
//      slice is in it folds them into the running (max, argmax) as the
//      tensor-core kernel does (argmax bytes, chunk <= 256; the maxima in
//      shared memory, so three blocks fit an SM).
//   3. mask_kernel as above.
//   It computes JAX's function, mm(Re c, cw[d]) + mm(Im c, sw[d]): 4·B·T·F·D·K
//   flop (1.25 ms at B = 2, T = 1,243, F = 513, D = K = 128 at the 67
//   TFLOP/s fp32 SIMT rate), so the FMAs bound it; the A rows are restreamed
//   for every d from L2 (about 1.3 GB at B = 2), which L2 serves.
//
// Every score is the same fixed sequence of operations whatever the batch,
// the row's place in its tile, or the split, so the argmax depends on none
// of them.
//
// Wiener synthesis. For z = (b, c):
//
//   tf[b,t,f] = Σ_k h_mask[b,t,k]·Wn[k,f],  Wn = (W / Σ_k W)ᵀ
//   X_z       = tf ⊙ planes[b,c]           (both channels from one GEMM)
//   y_z       = overlap-add(X_z·[A; −B]), trimmed by window/2 at each end
//
//   1. wiener_spectra_kernel: the tf GEMM over rows (b, t), the channel
//      multiply in its epilogue in fp32; writes X where istft.cuh's iDFT
//      reads it (bf16 rows [Re X | Im X | 0] in the bf16 mode, which is
//      where JAX's next make_mm rounds them; fp32 planes in float32).
//   2. the iDFT and 3. ola_kernel from istft.cuh, shared with synthesis.cu:
//      tc_frames_kernel on the tensor cores in bf16 over the B·C·T rows,
//      fft_frames_kernel (a hand-written FFT) in float32.
// In bf16 it is 2·B·T·(K·F + C·2·F·win) flop (86 GFLOP at B = 16) against
// about 190 MB; in float32 the iDFT is an FFT (2.5·win·log2 win flop a
// frame), so the bytes of X's planes and the frames bound it. The tf GEMM
// runs as fp32 FMAs on the SIMT core of simt_gemm.cuh (128 x 64 tiles, both
// operands through registers, rounded to bf16 there in the bf16 mode).
#include <math.h>

#include "common.cuh"
#include "istft.cuh"
#include "simt_gemm.cuh"
#include "tc_gemm.cuh"

using namespace gccnmf;

extern __shared__ __align__(128) unsigned char tc_smem[];  // SCORE_SMEM_BYTES

namespace gccnmf {
// scores.cu: the bf16 scores' (max, argmax) per chunk on the tensor cores
cudaError_t run_tc_scores(const bf16* rows, const bf16* fold, int ldj, float* pmax, int* parg,
                          int M, int F, int K, int D, int splits, int chunk, cudaStream_t st);
}  // namespace gccnmf

namespace {

// ---- soft mask, float32: the pipelined SIMT products of simt_gemm.cuh -----

// rows[m] = [Re c[m, :F] | Im c[m, :F] | 0] in fp32, ldj floats (a multiple
// of 4), one 16-byte chunk a thread: the scores' A operand, K-major with
// 16-byte rows (the planes' rows of F = 513 floats are not).
template <typename TP>
__global__ void coherence_rows_f32_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim,
                                          int ldf, float* __restrict__ rows, int ldj, int M,
                                          int F) {
  const int chunks = ldj / 4;
  const long total = (long)M * chunks;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long m = idx / chunks;
    const int j0 = (int)(idx % chunks) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      v[e] = j < F ? to_f32(cre[m * ldf + j]) : j < 2 * F ? to_f32(cim[m * ldf + j - F]) : 0.0f;
    }
    *reinterpret_cast<float4*>(rows + m * ldj + j0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// 128 rows x 64 atoms a block, 64 accumulators and 16 words of packed
// argmax a thread; the 64 running maxima a thread live in shared memory
// (read and written once a TDOA), which keeps the registers to three blocks
// an SM. Dynamic shared memory: the ring, then the maxima.
using ScoreTile32 = simt::Tile<128, 64>;
constexpr int SCORE_SMEM_BYTES =
    (ScoreTile32::SMEM_FLOATS + 64 * ScoreTile32::THREADS) * (int)sizeof(float);

// Running (max, argmax) over d in [d0, d0 + chunk) ∩ [0, D), d0 = split·chunk
// (chunk <= 256), of s[m,d,k] = rows[m]·[cw[d]; sw[d]][:, k] (J = 2F deep, in
// index order: the Re c terms, then the Im c terms) for the block's 128 rows
// and 64 atoms; written to pmax/parg at [split, m, k]. Grid: (splits, atom
// tiles, row tiles), as the tensor-core kernel's.
__global__ void __launch_bounds__(ScoreTile32::THREADS, 3)
simt_score_argmax_kernel(const float* __restrict__ rows, int ldj, const float* __restrict__ cw,
                         const float* __restrict__ sw, float* __restrict__ pmax,
                         int* __restrict__ parg, int M, int F, int K, int D, int chunk) {
  using TL = ScoreTile32;
  float* smem = reinterpret_cast<float*>(tc_smem);
  float* best = smem + TL::SMEM_FLOATS + threadIdx.x;  // best[r * THREADS]: this thread's
  const int split = blockIdx.x, n0 = blockIdx.y * TL::BN, m0 = blockIdx.z * TL::BM;
  const int d0 = split * chunk, nd = min(D, d0 + chunk) - d0;
  const int J = 2 * F, nk = (J + simt::BK - 1) / simt::BK;  // slices per TDOA
  const simt::Operand a{rows, ldj, M, J};
  simt::Loader<true, TL::BM, TL::THREADS, TL::LDA> la;
  simt::Loader<false, TL::BN, TL::THREADS, TL::LDB> lb;
  float acc[8][8];
  uint32_t arg[16];  // d − d0 of each running max, a byte each
  simt::zero(acc);
#pragma unroll
  for (int r = 0; r < 64; ++r) best[r * TL::THREADS] = -INFINITY;
#pragma unroll
  for (int r = 0; r < 16; ++r) arg[r] = 0u;
  // the ring fetches and computes the slices in order, once each: slice
  // (fetch_d, fetch_k) of the TDOA d0 + fetch_d is next to fetch, the slice
  // fold_k of TDOA d0 + fold_d next to compute
  int fetch_d = 0, fetch_k = 0, fold_d = 0, fold_k = 0;
  simt::ring<TL>(
      smem, nd * nk,
      [&](int, float* st) {
        const long d = d0 + fetch_d;
        const simt::Operand b{cw + d * F * K, K, K, J, sw + d * F * K, F};
        la.fetch(a, m0, fetch_k * simt::BK, st);
        lb.fetch(b, n0, fetch_k * simt::BK, st + TL::A_FLOATS);
        if (++fetch_k == nk) fetch_k = 0, ++fetch_d;
      },
      [&](float* st) { la.put(st, a); },  // the fold lands by cp.async
      [&](int, const float* st) {
        simt::fma_slice<TL>(st, acc);
        if (++fold_k < nk) return;  // the TDOA's scores are complete: fold them
        fold_k = 0;
        const uint32_t dl = fold_d++;
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int ri = r / 8, rj = r % 8;
          if (acc[ri][rj] > best[r * TL::THREADS]) {  // strict: the first maximum wins; NaN never
            best[r * TL::THREADS] = acc[ri][rj];
            arg[r / 4] = (arg[r / 4] & ~(0xFFu << (8 * (r % 4)))) | (dl << (8 * (r % 4)));
          }
          acc[ri][rj] = 0.0f;
        }
      });
  const long base = (long)split * M * K;
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    const int m = m0 + simt::frag_row<TL>(r / 8), k = n0 + simt::frag_col<TL>(r % 8);
    if (m < M && k < K) {
      pmax[base + (long)m * K + k] = best[r * TL::THREADS];
      parg[base + (long)m * K + k] = d0 + (int)((arg[r / 4] >> (8 * (r % 4))) & 0xFFu);
    }
  }
}

// ---- soft mask, bf16: the tensor-core products of tc_gemm.cuh ------------

// rows[m] = bf16([Re c[m, :F] | Im c[m, :F] | 0]), ldj elements (a
// multiple of 8), one 16-byte chunk a thread.
template <typename TP>
__global__ void coherence_rows_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim,
                                      int ldf, bf16* __restrict__ rows, int ldj, int M, int F) {
  const int chunks = ldj / 8;
  const long total = (long)M * chunks;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long m = idx / chunks;
    const int j0 = (int)(idx % chunks) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + e;
      v[e] = j < F ? to_f32(cre[m * ldf + j]) : j < 2 * F ? to_f32(cim[m * ldf + j - F]) : 0.0f;
    }
    const uint2 lo = tc::pack_bf16x4(v[0], v[1], v[2], v[3]);
    const uint2 hi = tc::pack_bf16x4(v[4], v[5], v[6], v[7]);
    *reinterpret_cast<uint4*>(rows + m * ldj + j0) = make_uint4(lo.x, lo.y, hi.x, hi.y);
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

// (m, f) tiles of 128 x 64: F = 513 in 9 column tiles (576 columns, against
// 640 in tiles of 128).
using WienerTile = simt::Tile<128, 64>;

// X for z = (b, c): X[t,f] = (Σ_k hm[b,t,k]·Wn[k,f])·plane[b,c,t,f], at
// spectrum row z·T + t of x (put_x: ldx, x_im), over rows m = (b, t) so one
// GEMM serves every channel.
template <typename TP, typename TX>
__global__ void __launch_bounds__(WienerTile::THREADS, 4)
wiener_spectra_kernel(const TP* __restrict__ sre, const TP* __restrict__ sim, int ldf,
                      const float* __restrict__ hm, const float* __restrict__ wn,
                      TX* __restrict__ x, int ldx, long x_im, int M, int T, int C, int F, int K,
                      bool rnd) {
  using TL = WienerTile;
  __shared__ __align__(16) float smem[TL::SMEM_FLOATS];
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  float acc[8][8];
  // (m, k) at hm[m*K + k]; (k, f) at Wn[k*F + f], both through registers
  simt::gemm<TL, true, false>(acc, smem, simt::Rounded{{hm, K, M, K}, rnd},
                              simt::Rounded{{wn, F, F, K}, rnd}, m0, n0, 0, K);
  const int lane = simt::frag_col<TL>(0) / 4;  // 0..7 across a row's threads
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + simt::frag_row<TL>(i);
    if (m >= M) continue;
    const int b = m / T, t = m % T;
    if (n0 == 0)
      for (int c = 0; c < C; ++c) {
        pad_x(x, ((long)b * C + c) * T + t, F, ldx, lane);
        pad_x(x, ((long)b * C + c) * T + t, F, ldx, lane + 8);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = n0 + simt::frag_col<TL>(j);
      if (f >= F) continue;
      for (int c = 0; c < C; ++c) {
        const long r = ((long)b * C + c) * T + t;
        const long plane = r * ldf + f;
        put_x(x, r, f, ldx, x_im, acc[i][j] * to_f32(sre[plane]), acc[i][j] * to_f32(sim[plane]));
      }
    }
  }
}

// fold null: the float32 mode's: the planes packed into fp32 rows, then the
// SIMT scores against cw/sw; else the bf16 mode's: the planes packed into
// bf16 rows, then the tensor cores.
template <typename TP>
cudaError_t run_mask(const TP* cre, const TP* cim, int ldf, const float* cw, const float* sw,
                     const bf16* fold, void* rows, int ldj, const float* params, float* pmax,
                     int* parg, float* hmask, int* argout, int B, int T, int F, int K, int D,
                     int splits, int chunk, cudaStream_t st) {
  const int M = B * T;
  cudaError_t err;
  if (fold) {
    bf16* rb = static_cast<bf16*>(rows);
    coherence_rows_kernel<TP><<<elementwise_blocks((long)M * (ldj / 8)), 256, 0, st>>>(
        cre, cim, ldf, rb, ldj, M, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = run_tc_scores(rb, fold, ldj, pmax, parg, M, F, K, D, splits, chunk, st);
  } else {
    using TL = ScoreTile32;
    float* rf = static_cast<float*>(rows);
    coherence_rows_f32_kernel<TP><<<elementwise_blocks((long)M * (ldj / 4)), 256, 0, st>>>(
        cre, cim, ldf, rf, ldj, M, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const void* kernel = reinterpret_cast<const void*>(simt_score_argmax_kernel);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SCORE_SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const dim3 grid(splits, (K + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
    simt_score_argmax_kernel<<<grid, TL::THREADS, SCORE_SMEM_BYTES, st>>>(
        rf, ldj, cw, sw, pmax, parg, M, F, K, D, chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  mask_kernel<<<elementwise_blocks((long)M * K), 256, 0, st>>>(pmax, parg, params, hmask,
                                                                argout, M, T, K, splits);
  return cudaGetLastError();
}

// TX = bf16 (the bf16 mode): X on bf16 rows of ldj, the tensor-core iDFT;
// TX = float: fp32 planes, the FFT.
template <typename TP, typename TX>
cudaError_t run_tf(const TP* sre, const TP* sim, int ldf, const float* hm, const float* wn,
                   const FftPlan& plan, const bf16* basis_rows, int ldj, TX* x, TX* frames,
                   float* out, int B, int C, int T, int F, int K, int win, int hop,
                   cudaStream_t st) {
  const int M = B * T, Z = B * C;
  const bool rows = sizeof(TX) == 2;
  wiener_spectra_kernel<TP, TX><<<simt::grid<WienerTile>(M, F, 1), WienerTile::THREADS, 0, st>>>(
      sre, sim, ldf, hm, wn, x, rows ? ldj : F, rows ? (long)F : (long)Z * T * F, M, T, C, F,
      K, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_istft<TX>(x, plan, basis_rows, ldj, frames, out, Z, T, F, win, hop, st);
}

}  // namespace

// cre/cim: (B, T, ldf) coherence planes, bf16 if plane_bf16 else f32,
// ldf >= F; params: (B, 4) f32; pmax/parg: (splits, B·T, K) scratch with
// splits = ceil(D / chunk); hmask: (B, T, K) f32; argout: (B, T, K) int32
// or null; ldj >= 2F a multiple of 8; chunk <= 256. float32 mode (fold
// null): cw/sw the (D, F, K) f32 folded dictionary, rows (B·T, ldj) f32
// scratch. bf16 mode: fold (D, K, ldj) bf16 with row (d, k) =
// [cw[d,:,k] | sw[d,:,k] | 0], 16-byte aligned; rows (B·T, ldj) bf16
// scratch; cw/sw unused.
extern "C" int gccnmf_soft_mask(const void* cre, const void* cim, int plane_bf16, int ldf,
                                const float* cw, const float* sw, const void* fold, void* rows,
                                int ldj, const float* params, float* pmax, int* parg,
                                float* hmask, int* argout, int B, int T, int F, int K, int D,
                                int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rows || ldj % 8 != 0 || ldj < 2 * F || chunk < 1 || chunk > 256)
    return (int)cudaErrorInvalidValue;
#define GCCNMF_RUN(TP)                                                                       \
  return (int)run_mask<TP>(static_cast<const TP*>(cre), static_cast<const TP*>(cim), ldf, cw, \
                           sw, static_cast<const bf16*>(fold), rows, ldj,                     \
                           params, pmax, parg, hmask, argout, B, T, F, K, D, splits, chunk, st)
  if (plane_bf16) GCCNMF_RUN(bf16);
  GCCNMF_RUN(float);
#undef GCCNMF_RUN
}

// sre/sim: (B, C, T, ldf) planes, bf16 if plane_bf16 else f32, ldf >= F;
// hmask: (B, T, K) f32; wn: (K, F) f32; out: (B, C, (T−1)·hop) f32. rnd
// (the bf16 mode): basis_rows (win, ldj) bf16 with row j =
// [A[:, j] | −B[:, j] | 0], ldj >= 2F a multiple of 8; x (B·C·T, ldj) and
// frames (B·C, T, win) bf16 scratch; the FFT's arguments unused. Else the
// FFT's: scale (win,) f32, twiddle (win, 2) f32 e^{+2πi m/win}, radix
// (passes,) int32, F = win/2 + 1; x (2, B·C, T, F) and frames (B·C, T, win)
// f32 scratch; basis_rows unused.
extern "C" int gccnmf_tf_synthesis(const void* sre, const void* sim, int plane_bf16, int ldf,
                                   const float* hmask, const float* wn, const float* scale,
                                   const float* twiddle, const int* radix, int passes,
                                   const void* basis_rows, int ldj, void* x, void* frames,
                                   float* out, int B, int C, int T, int F, int K, int win,
                                   int hop, int rnd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rnd && (ldj % 8 != 0 || ldj < 2 * F)) return (int)cudaErrorInvalidValue;
  if (F != win / 2 + 1) return (int)cudaErrorInvalidValue;
  const FftPlan plan{scale, reinterpret_cast<const float2*>(twiddle), radix, passes};
  const bf16* brows = static_cast<const bf16*>(basis_rows);
#define GCCNMF_RUN(TP, TX)                                                                  \
  return (int)run_tf<TP, TX>(static_cast<const TP*>(sre), static_cast<const TP*>(sim), ldf, \
                             hmask, wn, plan, brows, ldj, static_cast<TX*>(x),              \
                             static_cast<TX*>(frames), out, B, C, T, F, K, win, hop, st)
  if (plane_bf16) {
    if (rnd) GCCNMF_RUN(bf16, bf16);
    GCCNMF_RUN(bf16, float);
  }
  if (rnd) GCCNMF_RUN(float, bf16);
  GCCNMF_RUN(float, float);
#undef GCCNMF_RUN
}
