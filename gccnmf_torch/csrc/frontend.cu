// stft_gcc_frontend_cuda: the fused analysis front-end on Hopper.
//
// Replaces gccnmf_tpu/ops/frontend_pallas.py::stft_gcc_frontend_pallas
// (body _frontend_kernel). The TPU kernel assembles frames in VMEM from
// hop-sized rows with pltpu.roll. Here frame t is read where it lies in the
// signal, x[t*hop + j], so no frame tensor reaches device memory when hop
// allows it. Per call: the windowed rDFT of both channels (conjugated or
// not), then |X| per channel and the PHAT coherence X0·conj(X1)/(|X0||X1|)
// with the guarded divide, written as spec re/im, V and coherence re/im
// planes exactly F bins wide (fp32 or bf16); then the angular spectrogram
// Re(C)@cos + Im(C)@sin, stored fp32.
//
// What bounds it on the card: in float32 the rDFT is an FFT (2.5·win·log2
// win flop a frame), so the bytes do: the signal read once and eight (T,
// F) planes written, about 20 MB an utterance in fp32; in bf16 JAX rounds
// the DFT basis, so the least work is the GEMM, 8·T·win·F + 4·T·F·D flop
// (about 5.6 GFLOP an utterance at the reference shape).
//
// bf16 mode (JAX's make_mm rounding points: frames and the windowed basis
// in bf16, fp32 sums; the angular product on the coherence and the steering
// planes rounded to bf16), on the tensor cores (tc_gemm.cuh):
//   1. The signal as bf16 rows of ldx = n rounded up to 8
//      (dft_signal_rows_kernel, 10 MB at B = 16), so frame t of channel c
//      is row t of a K-major operand with ld = hop: frames overlap in
//      memory and never exist as a tensor. cp.async needs 16-byte sources,
//      so this takes hop and win multiples of 8; for any other hop
//      dft_frame_rows_kernel writes the frames once as bf16 rows of
//      ldw = win rounded up to 8 and the same product reads those.
//   2. tc_dft_coherence_kernel: one block, Tile<128, 3>, takes 64 frames
//      of both channels (warpgroup 0 channel 0, warpgroup 1 channel 1,
//      against the same B stage) and a group of 64 bins: the basis is
//      stored once as bf16 K-major rows (nb, ldw), group g being the 64
//      cos rows then the 64 sin rows of bins 64g..64g+63 (zero rows past
//      F), so one 128-wide tile holds Re and Im of the same bins for both
//      channels and the epilogue forms |X| and the coherence without
//      leaving the block. A 16-slice contraction (win = 1024) through a
//      3-stage cp.async ring, 64 accumulators a thread, two blocks an SM.
//      The epilogue stages the tile through shared memory and writes the
//      five planes, and once more the coherence as bf16 rows
//      [Re c | Im c | 0] of ldj = 2F rounded up to 8 (the pad written by
//      the blocks of group 0). At F = 513 the 9 groups are 576 bins: 12 %
//      of the products are padding.
//   3. tc_angular_kernel: those rows (M = B·T, 2F deep) against the
//      steering fold [cos_mᵀ | sin_mᵀ | 0] (D, ldj) bf16, stored once, one
//      wgmma product with fp32 output.
//   Each output sums its K in one fixed order, and the DFT tiles are per
//   utterance, so reruns and batch elements are bit-identical.
// float32 mode (exact fp32 rules out the tensor cores):
//   1. fft_coherence_kernel: the rDFT as the Stockham FFT of fft.cuh (the
//      passes that istft.cuh's iDFT runs, from frontend_basis's window,
//      twiddle table and radix plan): a block takes two frames of both
//      channels at win = 1,024 (fe_frames_per_block), reads them from the
//      signal coalesced and windowed, packs an even window's real samples
//      two a complex value (an L = win/2-point transform; an odd window
//      runs the win-point transform of its real input), runs the + sign
//      passes, which give conj rfft directly, unpacks the bins and writes
//      the planes and the coherence in the same block (put_bin). A window
//      too long for both channels' transforms in one block (even from
//      2,558 samples, odd from 1,279) takes one frame a block, channel 0
//      then channel 1, channel 0's bins held in an fp32 scratch row; past
//      29,052 (even) or 14,525 (odd) samples one transform does not fit
//      and the call is refused.
//   2. angular_kernel: the angular product from the stored coherence
//      planes, on the SIMT core of simt_gemm.cuh (64 x 128 tiles, the
//      planes' rows staged through registers, the steering planes by
//      cp.async).
//   The FFT's butterflies run in one fixed order for each frame, so reruns
//   and batch elements are bit-identical.
#include <climits>

#include "common.cuh"
#include "fft.cuh"
#include "simt_gemm.cuh"
#include "tc_gemm.cuh"

using namespace gccnmf;

namespace {

// Bin f of frame t of utterance b from Re/Im of both channels: writes spec
// re/im and |X| of each channel to (B, 2, T, F) and the guarded PHAT
// coherence X0·conj(X1)/(|X0||X1|) to (B, T, F); returns the coherence in
// fp32.
template <typename TP>
__device__ __forceinline__ float2 put_bin(float r0, float i0, float r1, float i1, int b, int t,
                                          int f, int T, int F, TP* sre, TP* sim, TP* mag,
                                          TP* cre, TP* cim) {
  const long ch = (long)T * F;  // one channel plane
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
  const float cr = (r0 * r1 + i0 * i1) * inv, ci = (i0 * r1 - r0 * i1) * inv;
  const long q = (long)b * ch + (long)t * F + f;  // (B, T, F)
  cre[q] = from_f32<TP>(cr);
  cim[q] = from_f32<TP>(ci);
  return make_float2(cr, ci);
}

// ---- float32: the rDFT as the FFT of fft.cuh ------------------------------

// Frames a block takes, both channels of each: two of fft.cuh's transforms
// a frame. 0 where fewer than two transforms fit (an even window from
// 2,558 samples, an odd one from 1,279): one frame a block then, its
// channels transformed one after the other.
__host__ __device__ constexpr int fe_frames_per_block(int win) {
  return fft_frames_per_block(win) / 2;
}

// Bin k of the transform in row z: Y[k] = Σ_j y[j]·e^{+2πi jk/win} = conj
// rfft(y)[k] of the windowed frame y, negated in Im for an unconjugated
// spectrum. Even window: z holds the L-point transform Z of z[n] = y[2n] +
// i·y[2n+1], and Y[k] = A[k] + e^{+2πi k/win}·B[k] with A[k] = (Z[k] +
// conj Z[L−k])/2, B[k] = (Z[k] − conj Z[L−k])/(2i), Z[L] ≡ Z[0]. Odd
// window: z holds Y itself.
__device__ __forceinline__ float2 fft_bin(const float2* z, int k, int L, bool even,
                                          const float2* __restrict__ tw, bool conjugate) {
  float2 y;
  if (even) {
    const float2 a = z[k == L ? 0 : k], c = z[k == 0 ? 0 : L - k];
    const float2 av = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 bv = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    y = cadd(av, cmul(__ldg(tw + k), bv));
  } else {
    y = z[k];
  }
  if (!conjugate) y.y = -y.y;
  return y;
}

// For the frames [blockIdx.x·P, + P) of the B·T frames (frame r: utterance
// r / T, frame t = r % T), P = fe_frames_per_block(win) or 1: the windowed
// rDFT of both channels, frame t of channel c read where it lies, at
// x[(2b + c)·n + t·hop + j], coalesced along j and times the window on the
// way in, then the planes and the coherence (put_bin) coalesced along the
// bins. Both channels' transforms sit in the block's shared memory at once
// (rows 2p + c); with P = 0 (a long window) channel 0 runs first, its F
// bins go to y0 (B·T, F) fp32 scratch, and channel 1's pass reads them
// back. WC: the window as a compile-time constant (FFT_FIXED_WIN), or 0
// for win_rt. Dynamic shared memory: 2 · rows · fft_row(win) float2, rows
// = 2P (1 for P = 0).
template <typename TP, int WC>
__global__ void __launch_bounds__(FFT_THREADS)
fft_coherence_kernel(const float* __restrict__ x, long n, int hop, FftPlan plan, int T,
                     int frames, int win_rt, int conjugate, float2* __restrict__ y0,
                     TP* __restrict__ sre, TP* __restrict__ sim, TP* __restrict__ mag,
                     TP* __restrict__ cre, TP* __restrict__ cim) {
  extern __shared__ __align__(16) float2 fft_smem[];
  const int win = WC ? WC : win_rt, per = fe_frames_per_block(win);
  const int L = fft_len(win), ld = fft_row(win), tstep = win / L, F = win / 2 + 1;
  const bool even = win % 2 == 0, pow2 = (L & (L - 1)) == 0, conj = conjugate != 0;
  const int P = per ? per : 1;
  // frame indices in 32 bits (the host checks B·T): a 64-bit division
  // would be a called routine, its registers saved on the stack
  const int r0 = blockIdx.x * P;
  const int nf = frames - r0 < P ? frames - r0 : P;
  const int half = (per ? 2 * P : 1) * ld;  // buffer 1 follows buffer 0
  const int b0 = r0 / T, t0 = r0 - b0 * T;
  // with both channels in the block one phase; else channel 0, then 1
  for (int phase = 0;; ++phase) {
    // buffer 0 ← the transforms' input: row rr is frame p and channel c
    // (rr = 2p + c, or the block's one frame in channel `phase`), two
    // samples a complex value for an even window (the row's float view is
    // the windowed frame), one real sample for an odd one; the row loop
    // unrolls where the window is a constant, so all of a thread's loads
    // can be in flight at once
    const int nr = per ? 2 * nf : 1;
#pragma unroll
    for (int rr = 0; rr < (WC ? 2 * fe_frames_per_block(WC) : nr); ++rr) {
      if (rr >= nr) break;
      int t = t0 + (per ? rr >> 1 : 0), b = b0;
      while (t >= T) t -= T, ++b;
      const float* src = x + (2L * b + (per ? rr & 1 : phase)) * n + (long)t * hop;
      float2* row = fft_smem + rr * ld;
#pragma unroll 4
      for (int j = threadIdx.x; j < win; j += FFT_THREADS) {
        const float v = src[j] * __ldg(plan.scale + j);
        if (even)
          reinterpret_cast<float*>(row)[j] = v;
        else
          row[j] = make_float2(v, 0.0f);
      }
    }
    __syncthreads();
    const float2* z = fft_smem + fft_passes(fft_smem, half, plan, L, tstep, nr, ld, pow2) * half;
    if (!per && phase == 0) {  // channel 0's bins to the scratch row
      for (int k = threadIdx.x; k < F; k += FFT_THREADS)
        y0[(long)r0 * F + k] = fft_bin(z, k, L, even, plan.tw, conj);
      __syncthreads();  // the buffers take channel 1
      continue;
    }
    // the last phase: nothing of the loads and passes stays live past here
    if (per) {  // both channels' bins of each frame, coalesced along the bins
      for (int e = threadIdx.x; e < nf * F; e += FFT_THREADS) {
        const int p = e / F, k = e - p * F;
        int t = t0 + p, b = b0;
        while (t >= T) t -= T, ++b;
        const float2 v0 = fft_bin(z + 2 * p * ld, k, L, even, plan.tw, conj);
        const float2 v1 = fft_bin(z + (2 * p + 1) * ld, k, L, even, plan.tw, conj);
        put_bin(v0.x, v0.y, v1.x, v1.y, b, t, k, T, F, sre, sim, mag, cre, cim);
      }
    } else {  // each thread reads back the bins of channel 0 it wrote
      for (int k = threadIdx.x; k < F; k += FFT_THREADS) {
        const float2 v0 = y0[(long)r0 * F + k], v1 = fft_bin(z, k, L, even, plan.tw, conj);
        put_bin(v0.x, v0.y, v1.x, v1.y, b0, t0, k, T, F, sre, sim, mag, cre, cim);
      }
    }
    return;
  }
}

// ---- the angular product on the SIMT core of simt_gemm.cuh --------------

// 64 frames x 128 TDOAs a block: D = 128 in one column tile, so each
// coherence row (F = 513 wide: element loads) is read once.
using AngTile32 = simt::Tile<64, 128>;

// ang[t,d] = Σ_f cre[t,f]·cos[f,d] + cim[t,f]·sin[f,d], summed in 16-bin
// blocks, each block's Re terms, then its Im terms: slice i of the ring is
// the Re (i % 4 < 2) or Im terms of bins f0..f0 + 7, f0 = 16·(i/4) + 8·(i%2).
template <typename TP>
__global__ void __launch_bounds__(AngTile32::THREADS, 4)
angular_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim,
               const float* __restrict__ cosm, const float* __restrict__ sinm,
               float* __restrict__ ang, int T, int F, int D) {
  using TL = AngTile32;
  __shared__ __align__(16) float smem[TL::SMEM_FLOATS];
  const int b = blockIdx.z, m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const long plane = (long)b * T * F;
  using Plane = simt::OperandOf<TP>;
  simt::Loader<true, TL::BM, TL::THREADS, TL::LDA, Plane> la;
  simt::Loader<false, TL::BN, TL::THREADS, TL::LDB> lb;
  float acc[8][8];
  simt::zero(acc);
  simt::ring<TL>(
      smem, 4 * ((F + 15) / 16),
      [&](int i, float* st) {  // (t, f) at C[t*F + f]; (f, d) at cos[f*D + d]
        const bool re = i % 4 < 2;
        const int f0 = 16 * (i / 4) + 8 * (i % 2);
        la.fetch({(re ? cre : cim) + plane, F, T, F}, m0, f0, st);
        lb.fetch({re ? cosm : sinm, D, D, F}, n0, f0, st + TL::A_FLOATS);
      },
      // a plane stages its runs as they are (its value() reads no field); B
      // lands by cp.async
      [&](float* st) { la.put(st, Plane{}); },
      [&](int, const float* st) { simt::fma_slice<TL>(st, acc); });
  float* ab = ang + (long)b * T * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = m0 + simt::frag_row<TL>(i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = n0 + simt::frag_col<TL>(j);
      if (d < D) ab[(long)t * D + d] = acc[i][j];
    }
  }
}

// The FFT front-end, then the angular product from the stored coherence.
template <typename TP>
cudaError_t run_fft(const float* x, int B, long n, int hop, int win, const FftPlan& plan,
                    int conjugate, float2* y0, const float* cosm, const float* sinm, int T, int F,
                    int D, TP* sre, TP* sim, TP* mag, TP* cre, TP* cim, float* ang,
                    cudaStream_t st) {
  const int per = fe_frames_per_block(win), P = per ? per : 1;
  const int smem = 2 * (per ? 2 * P : 1) * fft_row(win) * (int)sizeof(float2);
  const int frames = B * T;  // below 2^31 (gccnmf_frontend checks)
  const unsigned blocks = (unsigned)(((long)frames + P - 1) / P);
  cudaError_t err;
  if (win == FFT_FIXED_WIN) {
    fft_coherence_kernel<TP, FFT_FIXED_WIN><<<blocks, FFT_THREADS, smem, st>>>(
        x, n, hop, plan, T, frames, win, conjugate, y0, sre, sim, mag, cre, cim);
  } else {
    if (smem > 48 * 1024) {  // one long frame: dynamic shared memory past 48 KiB
      err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fft_coherence_kernel<TP, 0>),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    fft_coherence_kernel<TP, 0><<<blocks, FFT_THREADS, smem, st>>>(
        x, n, hop, plan, T, frames, win, conjugate, y0, sre, sim, mag, cre, cim);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  angular_kernel<TP><<<simt::grid<AngTile32>(T, D, B), AngTile32::THREADS, 0, st>>>(
      cre, cim, cosm, sinm, ang, T, F, D);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core products of tc_gemm.cuh ------------------------

constexpr int GROUP = 64;             // bins a column tile: their cos rows, then their sin rows
constexpr int FRAMES = tc::BM / 2;    // frames a block, of each channel
using DftTile = tc::Tile<2 * GROUP, 3>;
using AngTile = tc::Tile<128, 3>;

// xb[r, j] = bf16(x[r, j]) for j < n, 0 for n <= j < ldx: the rows signals
// (utterance, channel) as 16-byte rows.
__global__ void dft_signal_rows_kernel(const float* __restrict__ x, long n,
                                       bf16* __restrict__ xb, long ldx, long rows) {
  const long total = rows * ldx;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long r = idx / ldx, j = idx % ldx;
    xb[idx] = __float2bfloat16_rn(j < n ? x[r * n + j] : 0.0f);
  }
}

// frames[(r·T + t), j] = bf16(x[r, t·hop + j]) for j < win, 0 for
// win <= j < ldw: the frames of the rows signals, for a hop whose frames
// do not start on 16 bytes.
__global__ void dft_frame_rows_kernel(const float* __restrict__ x, long n, int hop, int win,
                                      int T, bf16* __restrict__ frames, int ldw, long rows) {
  const long total = rows * T * ldw;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long q = idx / ldw;
    const int j = (int)(idx % ldw);
    const long r = q / T;
    const int t = (int)(q % T);
    frames[idx] = __float2bfloat16_rn(j < win ? x[r * n + (long)t * hop + j] : 0.0f);
  }
}

// For utterance b = blockIdx.z, frames t0.. t0 + 63 (t0 = 64·blockIdx.y)
// and bin group g = blockIdx.x: the rDFT of both channels, frame t of
// channel c at a[(2b + c)·a_chan + t·a_ld + j], against basis rows
// [128g, 128g + 128) of (nb, ldw); then the planes (B, 2, T, F) and
// (B, T, F) and the coherence rows (B·T, ldj).
template <typename TP>
__global__ void __launch_bounds__(tc::THREADS, 2)
tc_dft_coherence_kernel(const bf16* __restrict__ a, long a_chan, long a_ld,
                        const bf16* __restrict__ basis, int ldw, int nb, int win, int T, int F,
                        TP* __restrict__ sre, TP* __restrict__ sim, TP* __restrict__ mag,
                        TP* __restrict__ cre, TP* __restrict__ cim, bf16* __restrict__ crows,
                        int ldj) {
  using TL = DftTile;
  extern __shared__ __align__(128) unsigned char smem[];  // TL::SMEM_BYTES
  const int g = blockIdx.x, t0 = blockIdx.y * FRAMES, b = blockIdx.z;
  const tc::Operand x0{a + 2L * b * a_chan, a_ld, t0, T, win};
  const tc::Operand x1{x0.p + a_chan, a_ld, t0, T, win};
  const tc::Operand w{basis, ldw, g * TL::BN, nb, win};
  float acc[TL::ACC];
#pragma unroll
  for (int r = 0; r < TL::ACC; ++r) acc[r] = 0.0f;
  tc::ring<TL>(
      smem, (win + tc::BK - 1) / tc::BK,
      [&](int i, uint32_t st) {  // A rows 0..63 channel 0, 64..127 channel 1
        const int k0 = i * tc::BK;
        tc::load_tile<false, FRAMES>(st, x0, k0);
        tc::load_tile<false, FRAMES>(st + FRAMES * tc::BK * 2, x1, k0);
        tc::load_tile<false, TL::BN>(st + tc::TILE_A, w, k0);
      },
      [&](int, uint32_t st) { tc::mma_stage<TL, false, false>(acc, st); });
  // tile row r: frame t0 + r of channel 0 (r < 64) or 1; column c: Re of bin
  // 64g + c (c < 64) or Im of bin 64g + c − 64
  float* s = reinterpret_cast<float*>(smem);
  tc::stage_acc<TL>(acc, s);
  const int f0 = g * GROUP, pad = ldj - 2 * F;
#pragma unroll 4
  for (int i = 0; i < FRAMES * GROUP / tc::THREADS; ++i) {
    const int idx = threadIdx.x + i * tc::THREADS;  // a warp: 32 bins of one frame
    const int r = idx / GROUP, c = idx % GROUP, t = t0 + r, f = f0 + c;
    if (t >= T) continue;
    bf16* row = crows + ((long)b * T + t) * ldj;
    if (g == 0 && c < pad) row[2 * F + c] = __float2bfloat16_rn(0.0f);
    if (f >= F) continue;
    const float* s0 = s + r * TL::LDS;       // channel 0's frame t
    const float* s1 = s0 + FRAMES * TL::LDS;  // channel 1's
    const float2 coh = put_bin(s0[c], s0[GROUP + c], s1[c], s1[GROUP + c], b, t, f, T, F, sre,
                               sim, mag, cre, cim);
    row[f] = __float2bfloat16_rn(coh.x);
    row[F + f] = __float2bfloat16_rn(coh.y);
  }
}

// ang[m, d] = Σ_k crows[m, k]·steer[d, k] over the J = 2F columns of the
// (M, ldj) coherence rows and the (D, ldj) steering fold.
__global__ void __launch_bounds__(tc::THREADS, 2)
tc_angular_kernel(const bf16* __restrict__ crows, const bf16* __restrict__ steer, int ldj,
                  float* __restrict__ ang, int M, int J, int D) {
  using TL = AngTile;
  extern __shared__ __align__(128) unsigned char smem[];  // TL::SMEM_BYTES
  const int m0 = blockIdx.y * tc::BM, n0 = blockIdx.x * TL::BN;
  float acc[TL::ACC];
  tc::gemm<TL, false, false>(acc, smem, {crows, ldj, m0, M, J}, {steer, ldj, n0, D, J}, 0, J);
  float* s = reinterpret_cast<float*>(smem);
  tc::stage_acc<TL>(acc, s);
  const int col = tc::epi_col<TL>(), d = n0 + col;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < TL::EPI; ++i) {
    const int row = tc::epi_row<TL>(i), m = m0 + row;
    if (m >= M) continue;
    const float* v = s + row * TL::LDS + col;
    float* out = ang + (long)m * D + d;
    if (D % 4 == 0) {  // 16-byte aligned: one store of four
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && d + e < D; ++e) out[e] = v[e];
    }
  }
}

// Dynamic shared memory past 48 KiB, and the carveout for it.
template <class TL>
cudaError_t allow_smem(const void* kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TL::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename TP>
cudaError_t run_tc(const float* x, int B, long n, int hop, int win, const bf16* basis, int nb,
                   int ldw, const bf16* steer, int ldj, bf16* stage, long ldx, bool frame_rows,
                   bf16* crows, int T, int F, int D, TP* sre, TP* sim, TP* mag, TP* cre, TP* cim,
                   float* ang, cudaStream_t st) {
  const long rows = 2L * B;  // (utterance, channel) signals
  long a_chan, a_ld;
  if (frame_rows) {
    dft_frame_rows_kernel<<<elementwise_blocks(rows * T * ldw), 256, 0, st>>>(
        x, n, hop, win, T, stage, ldw, rows);
    a_chan = (long)T * ldw;
    a_ld = ldw;
  } else {
    dft_signal_rows_kernel<<<elementwise_blocks(rows * ldx), 256, 0, st>>>(x, n, stage, ldx,
                                                                            rows);
    a_chan = ldx;
    a_ld = hop;
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = allow_smem<DftTile>(reinterpret_cast<const void*>(tc_dft_coherence_kernel<TP>));
  if (err != cudaSuccess) return err;
  // the group is the fastest index: a frame tile's blocks share its A in L2
  const dim3 grid(nb / DftTile::BN, (T + FRAMES - 1) / FRAMES, B);
  tc_dft_coherence_kernel<TP><<<grid, tc::THREADS, DftTile::SMEM_BYTES, st>>>(
      stage, a_chan, a_ld, basis, ldw, nb, win, T, F, sre, sim, mag, cre, cim, crows, ldj);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem<AngTile>(reinterpret_cast<const void*>(tc_angular_kernel));
  if (err != cudaSuccess) return err;
  tc_angular_kernel<<<tc::grid<AngTile>(B * T, D, 1), tc::THREADS, AngTile::SMEM_BYTES, st>>>(
      crows, steer, ldj, ang, B * T, 2 * F, D);
  return cudaGetLastError();
}

}  // namespace

// x: (B, 2, n) f32; sre/sim/mag: (B, 2, T, F) and cre/cim: (B, T, F), bf16
// if plane_bf16 else f32; ang: (B, T, D) f32.
// float32 (rnd 0): the FFT's window (win,) f32, twiddle (win,) float2 of
// e^{+2πi m/win} and radix (passes,) int32 (frontend_basis), conjugate
// (the spectrum's sign), y0 (B·T, F) float2 scratch for a window whose
// channels are transformed one after the other (fe_frames_per_block 0,
// else unused), and cosm/sinm (F, D) f32 for the angular product; the
// bf16 operands are unused.
// bf16 (rnd 1): basis (nb, ldw) bf16 rows, nb = 128·ceil(F / 64), group g =
// the cos rows then the sin rows of bins 64g..64g+63, ldw >= win a
// multiple of 8; steer (D, ldj) bf16 rows [cos_m[:, d] | sin_m[:, d] | 0],
// ldj >= 2F a multiple of 8; crows (B·T, ldj) bf16 scratch; stage bf16
// scratch: (B·2, ldx) signal rows, ldx >= n a multiple of 8 (needs hop and
// win multiples of 8), or with frame_rows (B·2·T, ldw) frame rows. The fp32
// operands are unused: nothing falls back to the FFT.
extern "C" int gccnmf_frontend(const float* x, int B, long n, int hop, int win,
                               const float* window, const void* twiddle, const int* radix,
                               int passes, int conjugate, void* y0, const float* cosm,
                               const float* sinm, const void* basis, int nb, int ldw,
                               const void* steer, int ldj, void* stage, long ldx, int frame_rows,
                               void* crows, int T, int F, int D, int rnd, int plane_bf16,
                               void* sre, void* sim, void* mag, void* cre, void* cim, float* ang,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rnd) {
    const bool bad = !basis || !steer || !stage || !crows || ldw % 8 || ldw < win || ldj % 8 ||
                     ldj < 2 * F || nb != 2 * GROUP * ((F + GROUP - 1) / GROUP) ||
                     (!frame_rows && (hop % 8 || win % 8 || ldx % 8 || ldx < n));
    if (bad) return (int)cudaErrorInvalidValue;
  } else if (!window || !twiddle || !radix || passes < 0 || !cosm || !sinm ||
             F != win / 2 + 1 || 2 * fft_row(win) * (int)sizeof(float2) > FFT_MAX_SMEM ||
             (long)B * T > INT_MAX ||
             (!fe_frames_per_block(win) && !y0)) {
    return (int)cudaErrorInvalidValue;
  }
  const FftPlan plan{window, static_cast<const float2*>(twiddle), radix, passes};
#define GCCNMF_RUN(TP)                                                                          \
  {                                                                                             \
    if (rnd)                                                                                    \
      return (int)run_tc<TP>(x, B, n, hop, win, static_cast<const bf16*>(basis), nb, ldw,       \
                             static_cast<const bf16*>(steer), ldj, static_cast<bf16*>(stage),   \
                             ldx, frame_rows != 0, static_cast<bf16*>(crows), T, F, D,          \
                             static_cast<TP*>(sre), static_cast<TP*>(sim),                      \
                             static_cast<TP*>(mag), static_cast<TP*>(cre),                      \
                             static_cast<TP*>(cim), ang, st);                                   \
    return (int)run_fft<TP>(x, B, n, hop, win, plan, conjugate, static_cast<float2*>(y0), cosm, \
                            sinm, T, F, D, static_cast<TP*>(sre), static_cast<TP*>(sim),        \
                            static_cast<TP*>(mag), static_cast<TP*>(cre),                       \
                            static_cast<TP*>(cim), ang, st);                                    \
  }
  if (plane_bf16) GCCNMF_RUN(bf16)
  GCCNMF_RUN(float)
#undef GCCNMF_RUN
}
