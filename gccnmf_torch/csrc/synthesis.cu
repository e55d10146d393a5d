// masked_synthesis_cuda: the fused reconstruction tail of separation on Hopper.
//
// Replaces gccnmf_tpu/ops/synthesis_pallas.py::masked_synthesis_pallas
// (body _synthesis_kernel). For each target s and channel c:
//
//   mag    = (H_c ⊙ [winner == s]) · Wᵀ
//   X      = mag · phase(mixture), phase = (1, 0) where the mixture bin is 0
//   frames = Re X · A − Im X · B   (windowed, gained iDFT basis; the minus
//                                   undoes the conjugated forward transform)
//   y      = overlap-add(frames), trimmed by window/2 at each end
//
// The TPU kernel carries the overlap-add tail from one time tile to the next
// in VMEM scratch and relies on a sequential grid. On Hopper blocks run in
// any order, so nothing carries between blocks: three launches instead.
//
//   1. spectra_kernel: the mag GEMM with the winner mask applied as H is
//      staged (the one-hot mask never exists) and the mixture phase applied
//      in the epilogue, in fp32; writes X where istft.cuh's iDFT reads it:
//      fp32 planes in float32, bf16 rows [Re X | Im X | 0] in bf16.
//   2. the iDFT (istft.cuh, shared with enhance.cu): tc_frames_kernel on the
//      tensor cores in bf16, fft_frames_kernel (a hand-written FFT) in
//      float32.
//   3. ola_kernel: the gather form of overlap-add with the window/2 trim.
//
// Time rows past T do not exist here: staging masks them to 0, which is the
// TPU kernel's padded rows (winner −1, H 0), and the gather never reads them.
//
// What bounds it on the card: in bf16, 2·S·C·T·F·(K + 2·win) flop per
// utterance (about 16.7 GFLOP at the reference shape with 3 targets)
// against about 20 MB of planes, H, winner and waveforms, so the products
// bound it; the mag GEMM (about 6 % of them) runs as fp32 FMAs on the SIMT
// core of simt_gemm.cuh, its operands rounded to bf16 where JAX's make_mm
// rounds them, the iDFT on wgmma. In float32 the iDFT is an FFT (2.5·win·log2 win flop a
// frame), which leaves the mag GEMM (2·S·C·T·F·K) as most of the
// operations, and X's planes and the frames (written and read once each)
// as most of the bytes.
#include "common.cuh"
#include "istft.cuh"
#include "simt_gemm.cuh"

using namespace gccnmf;

namespace {

// (t, f) tiles of 128 x 64, as kernel 1's ratio: F = 513 in 9 column tiles
// (576 columns, against 640 in tiles of 128).
using SpectraTile = simt::Tile<128, 64>;

// H[t,k] where winner[t,k] == s, else 0, rounded to bf16 where rnd: the
// winner mask applied as H passes through registers (the one-hot mask
// never exists). The winner shares H's (t, k) layout.
struct MaskedH : simt::Operand {
  const int* winner;
  int s;
  bool rnd;
  struct Run {
    float4 h;
    int4 w;
  };
  __device__ __forceinline__ bool vec() const {
    return simt::Operand::vec() && simt::aligned16(winner);
  }
  __device__ __forceinline__ Run run(long off) const {
    return {simt::Operand::run(off), *reinterpret_cast<const int4*>(winner + off)};
  }
  __device__ __forceinline__ Run run(long off, int n) const {  // past n: H 0, winner −1
    return {simt::Operand::run(off, n),
            make_int4(n > 0 ? winner[off] : -1, n > 1 ? winner[off + 1] : -1,
                      n > 2 ? winner[off + 2] : -1, n > 3 ? winner[off + 3] : -1)};
  }
  __device__ __forceinline__ float pick(float h, int w) const {
    return w == s ? (rnd ? round_bf16(h) : h) : 0.0f;
  }
  __device__ __forceinline__ float4 value(const Run& v) const {
    return make_float4(pick(v.h.x, v.w.x), pick(v.h.y, v.w.y), pick(v.h.z, v.w.z),
                       pick(v.h.w, v.w.w));
  }
};

// X for z = (b, s, c): X[t,f] = (Σ_k H[b,c,t,k]·[win[b,t,k]==s]·W[b,f,k])·phase,
// at spectrum row z·T + t of x (put_x: ldx, x_im).
template <typename TP, typename TX>
__global__ void __launch_bounds__(SpectraTile::THREADS, 4)
spectra_kernel(const TP* __restrict__ sre, const TP* __restrict__ sim, int ldf,
               const int* __restrict__ winner, const float* __restrict__ w,
               const float* __restrict__ h, TX* __restrict__ x, int ldx, long x_im, int S,
               int C, int T, int F, int K, bool rnd) {
  using TL = SpectraTile;
  __shared__ __align__(16) float smem[TL::SMEM_FLOATS];
  const int z = blockIdx.z, c = z % C, s = (z / C) % S, b = z / (C * S);
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  float acc[8][8];
  // (t, k) at H[t*K + k], masked; (f, k) at W[f*K + k]
  const MaskedH hs{{h + ((long)b * C + c) * T * K, K, T, K}, winner + (long)b * T * K, s, rnd};
  simt::gemm<TL, true, true>(acc, smem, hs, simt::Rounded{{w + (long)b * F * K, K, F, K}, rnd},
                             m0, n0, 0, K);
  const long plane = ((long)b * C + c) * T * ldf;
  const int lane = simt::frag_col<TL>(0) / 4;  // 0..7 across a row's threads
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = m0 + simt::frag_row<TL>(i);
    if (t >= T) continue;
    if (n0 == 0) {
      pad_x(x, (long)z * T + t, F, ldx, lane);
      pad_x(x, (long)z * T + t, F, ldx, lane + 8);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = n0 + simt::frag_col<TL>(j);
      if (f >= F) continue;
      const float re = to_f32(sre[plane + (long)t * ldf + f]);
      const float im = to_f32(sim[plane + (long)t * ldf + f]);
      const float mag2 = re * re + im * im;
      const bool ok = mag2 > 0.0f;
      const float inv = ok ? 1.0f / sqrtf(mag2) : 0.0f;
      const float pr = ok ? re * inv : 1.0f;
      const float pi = im * inv;
      const float mag = acc[i][j];
      put_x(x, (long)z * T + t, f, ldx, x_im, mag * pr, mag * pi);
    }
  }
}

// TX = bf16 (the bf16 mode): X on bf16 rows of ldj, the tensor-core iDFT;
// TX = float: fp32 planes, the FFT.
template <typename TP, typename TX>
cudaError_t run(const TP* sre, const TP* sim, int ldf, const int* winner, const float* w,
                const float* h, const FftPlan& plan, const bf16* basis_rows, int ldj, TX* x,
                TX* frames, float* out, int B, int S, int C, int T, int F, int K, int win,
                int hop, cudaStream_t st) {
  const int Z = B * S * C;
  const bool rows = sizeof(TX) == 2;
  spectra_kernel<TP, TX><<<simt::grid<SpectraTile>(T, F, Z), SpectraTile::THREADS, 0, st>>>(
      sre, sim, ldf, winner, w, h, x, rows ? ldj : F, rows ? (long)F : (long)Z * T * F, S, C,
      T, F, K, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_istft<TX>(x, plan, basis_rows, ldj, frames, out, Z, T, F, win, hop, st);
}

}  // namespace

// sre/sim: (B, C, T, ldf) planes, bf16 if plane_bf16 else f32, ldf >= F;
// winner: (B, T, K) int32; w: (B, F, K) f32; h: (B, C, T, K) f32;
// out: (B, S, C, (T−1)·hop) f32. rnd (the bf16 mode): basis_rows
// (win, ldj) bf16 with row j = [A[:, j] | −B[:, j] | 0], ldj >= 2F a
// multiple of 8; x (B·S·C·T, ldj) and frames (B·S·C, T, win) bf16 scratch;
// the FFT's arguments unused. Else the FFT's: scale (win,) f32, twiddle
// (win, 2) f32 e^{+2πi m/win}, radix (passes,) int32, F = win/2 + 1; x (2,
// B·S·C, T, F) and frames (B·S·C, T, win) f32 scratch; basis_rows unused.
extern "C" int gccnmf_masked_synthesis(const void* sre, const void* sim, int plane_bf16,
                                       int ldf, const int* winner, const float* w,
                                       const float* h, const float* scale,
                                       const float* twiddle, const int* radix, int passes,
                                       const void* basis_rows, int ldj, void* x, void* frames,
                                       float* out, int B, int S, int C, int T, int F, int K,
                                       int win, int hop, int rnd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rnd && (ldj % 8 != 0 || ldj < 2 * F)) return (int)cudaErrorInvalidValue;
  if (F != win / 2 + 1) return (int)cudaErrorInvalidValue;
  const FftPlan plan{scale, reinterpret_cast<const float2*>(twiddle), radix, passes};
  const bf16* brows = static_cast<const bf16*>(basis_rows);
#define GCCNMF_RUN(TP, TX)                                                                  \
  return (int)run<TP, TX>(static_cast<const TP*>(sre), static_cast<const TP*>(sim), ldf,   \
                          winner, w, h, plan, brows, ldj, static_cast<TX*>(x),             \
                          static_cast<TX*>(frames), out, B, S, C, T, F, K, win, hop, st)
  if (plane_bf16) {
    if (rnd) GCCNMF_RUN(bf16, bf16);
    GCCNMF_RUN(bf16, float);
  }
  if (rnd) GCCNMF_RUN(float, bf16);
  GCCNMF_RUN(float, float);
#undef GCCNMF_RUN
}
