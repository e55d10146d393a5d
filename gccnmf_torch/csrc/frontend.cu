// stft_gcc_frontend_cuda: the fused analysis front-end on Hopper.
//
// Replaces gccnmf_tpu/ops/frontend_pallas.py::stft_gcc_frontend_pallas
// (body _frontend_kernel). The TPU kernel assembles frames in VMEM from
// hop-sized rows with pltpu.roll. Here frame t is read where it lies in the
// signal, x[t*hop + j], so no frame tensor reaches device memory when hop
// allows it. Per call: the windowed rDFT of both channels against the
// host-built [window·cos | ±window·sin] basis (conjugation sign folded in),
// then |X| per channel and the PHAT coherence X0·conj(X1)/(|X0||X1|) with
// the guarded divide, written as spec re/im, V and coherence re/im planes
// exactly F bins wide (fp32 or bf16); then the angular spectrogram
// Re(C)@cos + Im(C)@sin, stored fp32.
//
// What bounds it on the card: 8·T·win·F + 4·T·F·D flop per utterance
// (about 5.6 GFLOP at the reference shape) against eight (T, F) planes
// written, about 20 MB in fp32 (10 MB in bf16), so the products bound it.
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
// float32 mode keeps the SIMT tile of common.cuh (no tensor-core path is
// exact fp32): dft_coherence_kernel, then angular_kernel from the stored
// planes.
#include "common.cuh"
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

// ---- float32: the SIMT products of common.cuh ----------------------------

template <typename TP>
__global__ void __launch_bounds__(NTHREADS)
dft_coherence_kernel(const float* __restrict__ x, long n, int hop, int win,
                     const float* __restrict__ wcos, const float* __restrict__ wsin,
                     int T, int F, TP* __restrict__ sre, TP* __restrict__ sim,
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
    stage_a<true>(A0, x0, hop, 1, m0, j0, T, win, false);  // (t, j) at x[t*hop + j]
    stage_a<true>(A1, x1, hop, 1, m0, j0, T, win, false);
    stage_b<true>(Bc, wcos, F, 1, j0, n0, win, F, false);  // (j, f) at basis[j*F + f]
    stage_b<true>(Bs, wsin, F, 1, j0, n0, win, F, false);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = out_col(n0, j);
      if (f < F)
        put_bin(re0[i][j], im0[i][j], re1[i][j], im1[i][j], b, t, f, T, F, sre, sim, mag, cre,
                cim);
    }
  }
}

// ang[t,d] = Σ_f cre[t,f]·cos[f,d] + cim[t,f]·sin[f,d]
template <typename TP>
__global__ void __launch_bounds__(NTHREADS)
angular_kernel(const TP* __restrict__ cre, const TP* __restrict__ cim,
               const float* __restrict__ cosm, const float* __restrict__ sinm,
               float* __restrict__ ang, int T, int F, int D) {
  __shared__ __align__(16) TileA Ar, Ai;
  __shared__ __align__(16) TileB Bc, Bs;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TP* cr = cre + (long)b * T * F;
  const TP* ci = cim + (long)b * T * F;
  float acc[4][4];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += BK) {
    stage_a<true>(Ar, cr, F, 1, m0, f0, T, F, false);  // (t, f) at C[t*F + f]
    stage_a<true>(Ai, ci, F, 1, m0, f0, T, F, false);
    stage_b<true>(Bc, cosm, D, 1, f0, n0, F, D, false);  // (f, d) at cos[f*D + d]
    stage_b<true>(Bs, sinm, D, 1, f0, n0, F, D, false);
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
cudaError_t run_simt(const float* x, int B, long n, int hop, int win, const float* wcos,
                     const float* wsin, const float* cosm, const float* sinm, int T, int F, int D,
                     TP* sre, TP* sim, TP* mag, TP* cre, TP* cim, float* ang, cudaStream_t st) {
  dft_coherence_kernel<TP><<<tile_grid(T, F, B), NTHREADS, 0, st>>>(
      x, n, hop, win, wcos, wsin, T, F, sre, sim, mag, cre, cim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  angular_kernel<TP><<<tile_grid(T, D, B), NTHREADS, 0, st>>>(cre, cim, cosm, sinm, ang, T, F, D);
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
// float32 (rnd 0): wcos/wsin (win, F) and cosm/sinm (F, D) f32, the SIMT
// products; the bf16 operands are unused.
// bf16 (rnd 1): basis (nb, ldw) bf16 rows, nb = 128·ceil(F / 64), group g =
// the cos rows then the sin rows of bins 64g..64g+63, ldw >= win a
// multiple of 8; steer (D, ldj) bf16 rows [cos_m[:, d] | sin_m[:, d] | 0],
// ldj >= 2F a multiple of 8; crows (B·T, ldj) bf16 scratch; stage bf16
// scratch: (B·2, ldx) signal rows, ldx >= n a multiple of 8 (needs hop and
// win multiples of 8), or with frame_rows (B·2·T, ldw) frame rows. The fp32
// operands are unused: nothing falls back to the SIMT products.
extern "C" int gccnmf_frontend(const float* x, int B, long n, int hop, int win,
                               const float* wcos, const float* wsin, const float* cosm,
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
  } else if (!wcos || !wsin || !cosm || !sinm) {
    return (int)cudaErrorInvalidValue;
  }
#define GCCNMF_RUN(TP)                                                                          \
  {                                                                                             \
    if (rnd)                                                                                    \
      return (int)run_tc<TP>(x, B, n, hop, win, static_cast<const bf16*>(basis), nb, ldw,       \
                             static_cast<const bf16*>(steer), ldj, static_cast<bf16*>(stage),   \
                             ldx, frame_rows != 0, static_cast<bf16*>(crows), T, F, D,          \
                             static_cast<TP*>(sre), static_cast<TP*>(sim),                      \
                             static_cast<TP*>(mag), static_cast<TP*>(cre),                      \
                             static_cast<TP*>(cim), ang, st);                                   \
    return (int)run_simt<TP>(x, B, n, hop, win, wcos, wsin, cosm, sinm, T, F, D,                 \
                             static_cast<TP*>(sre), static_cast<TP*>(sim),                      \
                             static_cast<TP*>(mag), static_cast<TP*>(cre),                      \
                             static_cast<TP*>(cim), ang, st);                                   \
  }
  if (plane_bf16) GCCNMF_RUN(bf16)
  GCCNMF_RUN(float)
#undef GCCNMF_RUN
}
