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
//      in the epilogue, in fp32 even for bf16 planes; writes Re X, Im X.
//   2. frames_kernel and 3. ola_kernel (istft.cuh, shared with enhance.cu):
//      the iDFT GEMM against [A; −B], then the gather form of overlap-add
//      with the window/2 center trim.
//
// Time rows past T do not exist here: staging masks them to 0, which is the
// TPU kernel's padded rows (winner −1, H 0), and the gather never reads them.
//
// What bounds it on the card: 2·S·C·T·F·(K + 2·win) flop per utterance
// (about 16.7 GFLOP at the reference shape with 3 targets) against about
// 20 MB of planes, H, winner and waveforms, so the products bound it; they
// run as fp32 FMAs on the SIMT cores (bf16 mode rounds the operands where
// JAX's make_mm does: the mag operands, the iDFT operands and the frames
// that enter the overlap-add).
#include "common.cuh"
#include "istft.cuh"

using namespace gccnmf;

namespace {

// Re X, Im X for z = (b, s, c): X[t,f] = (Σ_k H[b,c,t,k]·[win[b,t,k]==s]·W[b,f,k])·phase
template <typename TP, typename TX>
__global__ void __launch_bounds__(NTHREADS)
spectra_kernel(const TP* __restrict__ sre, const TP* __restrict__ sim, int ldf,
               const int* __restrict__ winner, const float* __restrict__ w,
               const float* __restrict__ h, TX* __restrict__ xr, TX* __restrict__ xi,
               int S, int C, int T, int F, int K, bool rnd) {
  __shared__ __align__(16) TileA As;
  __shared__ __align__(16) TileB Bs;
  const int z = blockIdx.z, c = z % C, s = (z / C) % S, b = z / (C * S);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* hb = h + ((long)b * C + c) * T * K;
  const int* wnb = winner + (long)b * T * K;
  const float* wb = w + (long)b * F * K;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // (t, k): H[t,k] where the winner is s, else 0
    for (int e = threadIdx.x; e < BM * BK; e += NTHREADS) {
      const int m = e / BK, k = e % BK, gt = m0 + m, gk = k0 + k;
      float v = 0.0f;
      if (gt < T && gk < K && wnb[(long)gt * K + gk] == s) {
        v = hb[(long)gt * K + gk];
        if (rnd) v = round_bf16(v);
      }
      As[k][m] = v;
    }
    stage_b<false>(Bs, wb, 1, K, k0, n0, K, F, rnd);  // (k, f) at W[f*K + k]
    __syncthreads();
    tile_fma(As, Bs, acc);
    __syncthreads();
  }
  const long plane = ((long)b * C + c) * T * ldf;
  const long out = (long)z * T * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = out_col(n0, j);
      if (f >= F) continue;
      const float re = to_f32(sre[plane + (long)t * ldf + f]);
      const float im = to_f32(sim[plane + (long)t * ldf + f]);
      const float mag2 = re * re + im * im;
      const bool ok = mag2 > 0.0f;
      const float inv = ok ? 1.0f / sqrtf(mag2) : 0.0f;
      const float pr = ok ? re * inv : 1.0f;
      const float pi = im * inv;
      const float mag = acc[i][j];
      xr[out + (long)t * F + f] = from_f32<TX>(mag * pr);
      xi[out + (long)t * F + f] = from_f32<TX>(mag * pi);
    }
  }
}

template <typename TP, typename TX>
cudaError_t run(const TP* sre, const TP* sim, int ldf, const int* winner, const float* w,
                const float* h, const float* basis_a, const float* basis_b, TX* xr,
                TX* xi, TX* frames, float* out, int B, int S, int C, int T, int F,
                int K, int win, int hop, bool rnd, cudaStream_t st) {
  const int Z = B * S * C;
  spectra_kernel<TP, TX><<<tile_grid(T, F, Z), NTHREADS, 0, st>>>(
      sre, sim, ldf, winner, w, h, xr, xi, S, C, T, F, K, rnd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_istft<TX>(xr, xi, basis_a, basis_b, frames, out, Z, T, F, win, hop, rnd, st);
}

}  // namespace

// sre/sim: (B, C, T, ldf) planes, bf16 if plane_bf16 else f32, ldf >= F;
// winner: (B, T, K) int32; w: (B, F, K) f32; h: (B, C, T, K) f32;
// basis_a/basis_b: (F, win) f32 (basis_b already negated);
// xr/xi: (B·S·C, T, F) and frames: (B·S·C, T, win) scratch, bf16 if rnd
// else f32; out: (B, S, C, (T−1)·hop) f32.
extern "C" int gccnmf_masked_synthesis(const void* sre, const void* sim, int plane_bf16,
                                       int ldf, const int* winner, const float* w,
                                       const float* h, const float* basis_a,
                                       const float* basis_b, void* xr, void* xi,
                                       void* frames, float* out, int B, int S, int C,
                                       int T, int F, int K, int win, int hop, int rnd,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GCCNMF_RUN(TP, TX)                                                            \
  return (int)run<TP, TX>(static_cast<const TP*>(sre), static_cast<const TP*>(sim), \
                          ldf, winner, w, h, basis_a, basis_b, static_cast<TX*>(xr), \
                          static_cast<TX*>(xi), static_cast<TX*>(frames), out, B, S, \
                          C, T, F, K, win, hop, rnd != 0, st)
  if (plane_bf16) {
    if (rnd) GCCNMF_RUN(bf16, bf16);
    GCCNMF_RUN(bf16, float);
  }
  if (rnd) GCCNMF_RUN(float, bf16);
  GCCNMF_RUN(float, float);
#undef GCCNMF_RUN
}
