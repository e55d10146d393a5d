// The inverse-STFT tail shared by the separation and enhancement synthesis
// kernels (synthesis.cu, enhance.cu): a windowed, gained iDFT from the
// masked spectrum X to frames, then the gather form of overlap-add with the
// window/2 center trim.
//
// The TPU kernels carry the overlap-add tail between time tiles on their
// sequential grid; Hopper blocks run in any order, so the frames reach
// device memory and a second launch sums, for each output sample, the
// window/hop frames that cover it, in a fixed order (no atomics).
//
// Where X lives (put_x): the spectra kernels write spectrum row r = z·T + t
// of every (utterance, target, channel) z.
//   float32: two fp32 planes, Re X at x[r·F + f] and Im X at
//     x[Z·T·F + r·F + f]; fft_frames_kernel reads them.
//   bf16 (the rounding points of JAX's make_mm: X and the basis in bf16,
//     fp32 sums, frames in bf16): one bf16 row a spectrum row,
//     [Re X[:F] | Im X[:F] | 0] of ldj = 2F rounded up to 8 (16-byte rows
//     for cp.async), the padding written as zeros by the spectra kernel.
//     tc_frames_kernel reads them on the tensor cores.
//
// fft_frames_kernel (float32): frames[r, j] = scale[j] · irfft(conj X[r,
// :F], n = win)[j], scale = window · gain: what Re X·A − Im X·B computes
// (ops/synthesis_cuda.py idft_frames_plain), the imaginary parts of the DC
// bin and, for an even window, of the Nyquist bin dropping out as they do
// in the GEMM. Exact fp32 rules out the tensor cores, and as a GEMM the
// iDFT is 2·2F·win flop a frame (2.1 MFLOP at win = 1,024) where an FFT
// needs 2.5·win·log2 win (26 kFLOP): at B = 2 of 10 s with 3 targets the
// GEMM would take 0.47 ms at the 67 TFLOP/s fp32 peak, while reading X and
// writing the frames once (2 × 61 MB) take 0.04 ms at 3.35 TB/s. So the
// kernel runs an FFT (measured on an H100 at about a third of that byte
// rate, its time moving with its instruction count; PERF.md):
//   - a block of 256 threads holds a few frames (fft_frames_per_block: 4
//     at win = 1,024) wholly in shared memory, two rows of fft_row(win)
//     complex fp32 values a frame, the odd of L + 1 and L + 2 so that the
//     frames' rows start in different banks;
//   - X's rows are staged coalesced along f, then packed into the complex
//     input of one L-point inverse FFT a frame, the conjugation applied on
//     the way: for an even window L = win/2, and the usual real-output
//     packing (Z_k = E_k + i·O_k with E_k = Y_k + conj Y_{L−k}, O_k =
//     (Y_k − conj Y_{L−k})·e^{2πik/win}, Y = conj X) gives y[2n] + i·y[2n+1]
//     as output n; for an odd window L = win, the Hermitian spectrum in
//     full;
//   - Stockham passes (fft.cuh, shared with the front-end's rDFT;
//     self-sorting, ping-pong between the two rows), one per radix of the
//     host's plan (ops/synthesis_cuda.py fft_plan: 4s, a 2,
//     3s, 5s, then any other prime as a generic radix, a direct p-point DFT
//     in one pass), butterflies in registers, every twiddle read from one
//     table of the win-th roots of unity built in float64 on the host and
//     rounded once to fp32 (fft_twiddles);
//   - window · gain and 1/win applied on the store, two samples a thread
//     for an even window (8-byte stores);
//   - compiled twice: for the reference window of 1,024 as a constant, so
//     that every index and division folds (a power-of-two length also
//     takes j mod ns as a mask), and for any window given at run time.
// Each frame runs the same butterflies in the same order wherever it
// lies, so reruns are bit-identical and a batch element gives what it
// gives alone. The error is O(ε·log win) against the GEMM's O(ε·win).
//
// tc_frames_kernel: frames = rows · basisᵀ, one product over M = Z·T rows
// (every utterance, target and channel stacked, since the basis is shared),
// N = win and a 2F-deep contraction (17 slices of 64 at F = 513), with the
// basis stored once as (win, ldj) bf16 K-major rows [A[:, j] ; −B[:, j] ; 0]
// (ops/synthesis_cuda.py synthesis_basis), the layout of the soft mask's
// fold, so both operands are K-major. Tile<128, 3>: a 128 × 128 output tile
// a block (64 fp32 accumulators a thread, the wgmma n128 shape, and win =
// 1,024 is 8 such columns), a 3-stage ring of 96 KiB, two blocks an SM. The
// contraction is short (17 slices) and the epilogue a plain bf16 store, so
// a second block in flight hides one block's ring fill and store; a
// 4-stage ring would allow only one. The column tile is the grid's fastest
// index, so the 8 blocks that read one 128-row tile of X run together and
// share it in L2; the 2 MB basis stays in L2. (In bf16 JAX rounds the
// basis itself, which no FFT reproduces, so the GEMM is the mode's least
// work.)
//
// The kernels sit in a top-level anonymous namespace (nvcc's registration
// stubs reject one nested in a named namespace): each source that includes
// this header gets its own copy, as each is compiled without relocatable
// device code and registers its own kernels.
#pragma once

#include "common.cuh"
#include "fft.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace gccnmf;

// Spectrum row r, bin f of X: Re at x[r·ldx + f], Im at x[r·ldx + x_im + f]
// (fp32 planes: ldx = F, x_im = Z·T·F; bf16 rows: ldx = ldj, x_im = F).
template <typename TX>
__device__ __forceinline__ void put_x(TX* x, long r, int f, int ldx, long x_im, float re_v,
                                      float im_v) {
  x[r * ldx + f] = from_f32<TX>(re_v);
  x[r * ldx + x_im + f] = from_f32<TX>(im_v);
}

// The zero padding [2F, ldx) of bf16 row r, written by the threads with
// lane < ldx − 2F of the spectra block that holds bin 0; fp32 planes have
// none.
__device__ __forceinline__ void pad_x(float*, long, int, int, int) {}
__device__ __forceinline__ void pad_x(bf16* x, long r, int F, int ldx, int lane) {
  if (2 * F + lane < ldx) x[r * ldx + 2 * F + lane] = __float2bfloat16_rn(0.0f);
}

// ---- float32: the FFT of fft.cuh ------------------------------------------

// frames[r, :] = scale ⊙ irfft(conj X[r, :F], n = win) for the frames
// [blockIdx.x · per_block, + per_block) of rows; X in put_x's fp32 planes
// (Re at xr[r·F + f], Im at xi[r·F + f]), F = win/2 + 1, frames (rows,
// win) fp32. WC: the window as a compile-time constant (FFT_FIXED_WIN), or
// 0 for a window given at run time (win_rt, per_rt). Dynamic shared memory:
// 2 · per_block · fft_row(win) float2.
template <int WC>
__global__ void __launch_bounds__(FFT_THREADS)
fft_frames_kernel(const float* __restrict__ xr, const float* __restrict__ xi, FftPlan plan,
                  float* __restrict__ frames, long rows, int win_rt, int per_rt) {
  extern __shared__ __align__(16) float2 fft_smem[];
  const int win = WC ? WC : win_rt, per_block = WC ? fft_frames_per_block(WC) : per_rt;
  const int L = fft_len(win), ld = fft_row(win), tstep = win / L, F = win / 2 + 1;
  const bool even = win % 2 == 0, pow2 = (L & (L - 1)) == 0;
  const long r0 = (long)blockIdx.x * per_block, left = rows - r0;
  const int nf = left < per_block ? (int)left : per_block;
  const int half = per_block * ld;  // buffer 1 follows buffer 0
  // X's rows into buffer 1: the block's frames are nf·F consecutive values
  // of each plane, read coalesced, FFT_LOADS of them a thread in flight
  const float* xrb = xr + r0 * F;
  const float* xib = xi + r0 * F;
  const int n_x = nf * F;
  for (int e0 = threadIdx.x; e0 < n_x; e0 += FFT_LOADS * FFT_THREADS) {
    float re[FFT_LOADS], im[FFT_LOADS];
#pragma unroll
    for (int u = 0; u < FFT_LOADS; ++u) {
      const int e = e0 + u * FFT_THREADS;
      re[u] = e < n_x ? xrb[e] : 0.0f;
      im[u] = e < n_x ? xib[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < FFT_LOADS; ++u) {
      const int e = e0 + u * FFT_THREADS, fr = e / F;
      if (e < n_x) fft_smem[half + fr * ld + e - fr * F] = make_float2(re[u], im[u]);
    }
  }
  __syncthreads();
  // the L-point transform's input into buffer 0, conjugating on the way
  for (int e = threadIdx.x; e < nf * L; e += FFT_THREADS) {
    const int fr = e / L, k = e - fr * L;
    const float2* x = fft_smem + half + fr * ld;
    float2 z;
    if (even) {
      // Y_k = conj X_k = (a.x, −ai) and conj Y_{L−k} = X_{L−k} = (c.x, ci), the
      // imaginary parts of DC and Nyquist (both read at k = 0) dropped
      const float2 a = x[k], c = x[L - k];
      const float ai = k == 0 ? 0.0f : a.y, ci = k == 0 ? 0.0f : c.y;
      const float2 ev = make_float2(a.x + c.x, ci - ai);
      const float2 od = cmul(make_float2(a.x - c.x, -ai - ci), __ldg(plan.tw + k));
      z = make_float2(ev.x - od.y, ev.y + od.x);  // E + i·O
    } else {
      // Y_k = conj X_k below F, conj Y_{N−k} = X_{N−k} from F, Im Y_0 dropped
      z = k == 0 ? make_float2(x[0].x, 0.0f)
          : k < F ? make_float2(x[k].x, -x[k].y)
                  : x[L - k];
    }
    fft_smem[fr * ld + k] = z;
  }
  __syncthreads();
  const int cur = fft_passes(fft_smem, half, plan, L, tstep, nf, ld, pow2);
  // the frames: window · gain / win on the store
  const float inv_n = 1.0f / (float)win;
  const float2* z = fft_smem + cur * half;
  float* out = frames + r0 * win;
  if (even) {  // output n is samples 2n and 2n + 1
    for (int e = threadIdx.x; e < nf * L; e += FFT_THREADS) {
      const int fr = e / L, n = e - fr * L;
      const float2 v = z[fr * ld + n];
      *reinterpret_cast<float2*>(out + (long)fr * win + 2 * n) =
          make_float2(v.x * inv_n * plan.scale[2 * n], v.y * inv_n * plan.scale[2 * n + 1]);
    }
  } else {  // the real part of output n is sample n
    for (int e = threadIdx.x; e < nf * win; e += FFT_THREADS) {
      const int fr = e / win, n = e - fr * win;
      out[(long)fr * win + n] = z[fr * ld + n].x * inv_n * plan.scale[n];
    }
  }
}

using FramesTile = tc::Tile<128, 3>;

// bf16: frames[m, j] = bf16(Σ_k rows[m, k]·basis[j, k]) over the J = 2F
// columns of the (M, ldj) spectrum rows and the (win, ldj) basis rows.
__global__ void __launch_bounds__(tc::THREADS, 2)
tc_frames_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ basis, int ldj,
                 bf16* __restrict__ frames, int M, int J, int win) {
  using TL = FramesTile;
  extern __shared__ __align__(128) unsigned char smem[];  // TL::SMEM_BYTES
  const int m0 = blockIdx.y * tc::BM, n0 = blockIdx.x * TL::BN;
  float acc[TL::ACC];
  tc::gemm<TL, false, false>(acc, smem, {rows, ldj, m0, M, J}, {basis, ldj, n0, win, J}, 0, J);
  float* s = reinterpret_cast<float*>(smem);
  tc::stage_acc<TL>(acc, s);
  const int col = tc::epi_col<TL>(), j = n0 + col;
  if (j >= win) return;
#pragma unroll
  for (int i = 0; i < TL::EPI; ++i) {
    const int row = tc::epi_row<TL>(i), m = m0 + row;
    if (m >= M) continue;
    const float* v = s + row * TL::LDS + col;
    bf16* out = frames + (long)m * win + j;
    if (win % 4 == 0) {  // 8-byte aligned: one store of four
      *reinterpret_cast<uint2*>(out) = tc::pack_bf16x4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && j + e < win; ++e) out[e] = __float2bfloat16_rn(v[e]);
    }
  }
}

// out[z,i] = Σ_{k=0}^{ratio-1} frames[z, q-k, k*hop + r] over frames that
// exist, with g = i + win/2 = q*hop + r (center trim) and ratio = win/hop.
template <typename TF>
__global__ void ola_kernel(const TF* __restrict__ frames, float* __restrict__ out,
                           long Z, int T, int win, int hop, long n_out) {
  const int ratio = win / hop, half = win / 2;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < Z * n_out;
       idx += (long)gridDim.x * blockDim.x) {
    const long z = idx / n_out, i = idx % n_out;
    const long g = i + half;
    const long q = g / hop;
    const int r = (int)(g % hop);
    const TF* fz = frames + z * T * win;
    float acc = 0.0f;
    for (int k = 0; k < ratio; ++k) {
      const long t = q - k;
      if (t >= 0 && t < T) acc += to_f32(fz[t * win + (long)k * hop + r]);
    }
    out[idx] = acc;
  }
}

cudaError_t launch_frames(const float* x, const FftPlan& plan, const bf16*, int, float* frames,
                          int Z, int T, int F, int win, cudaStream_t st) {
  const int per = fft_frames_per_block(win);
  const int smem = 2 * per * fft_row(win) * (int)sizeof(float2);
  const long rows = (long)Z * T;
  const unsigned blocks = (unsigned)((rows + per - 1) / per);
  if (win == FFT_FIXED_WIN) {
    fft_frames_kernel<FFT_FIXED_WIN><<<blocks, FFT_THREADS, smem, st>>>(
        x, x + rows * F, plan, frames, rows, win, per);
    return cudaGetLastError();
  }
  if (smem > 48 * 1024) {  // one long frame: dynamic shared memory past 48 KiB
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(fft_frames_kernel<0>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fft_frames_kernel<0><<<blocks, FFT_THREADS, smem, st>>>(x, x + rows * F, plan, frames, rows,
                                                          win, per);
  return cudaGetLastError();
}

cudaError_t launch_frames(const bf16* x, const FftPlan&, const bf16* basis_rows, int ldj,
                          bf16* frames, int Z, int T, int F, int win, cudaStream_t st) {
  using TL = FramesTile;
  const void* kernel = reinterpret_cast<const void*>(tc_frames_kernel);
  // dynamic shared memory past 48 KiB, and the carveout for two blocks an SM
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TL::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int M = Z * T;
  tc_frames_kernel<<<tc::grid<TL>(M, win, 1), tc::THREADS, TL::SMEM_BYTES, st>>>(
      x, basis_rows, ldj, frames, M, 2 * F, win);
  return cudaGetLastError();
}

// The iDFT then the overlap-add over Z = (batch · targets · channels)
// spectra of T frames: X as put_x laid it out (fp32 planes with the FFT's
// plan, or bf16 rows of ldj with the (win, ldj) bf16 basis_rows), frames
// (Z, T, win) scratch in the type of X, out (Z, (T−1)·hop) fp32.
template <typename TX>
cudaError_t run_istft(const TX* x, const FftPlan& plan, const bf16* basis_rows, int ldj,
                      TX* frames, float* out, int Z, int T, int F, int win, int hop,
                      cudaStream_t st) {
  cudaError_t err = launch_frames(x, plan, basis_rows, ldj, frames, Z, T, F, win, st);
  if (err != cudaSuccess) return err;
  const long n_out = (long)(T - 1) * hop, total = (long)Z * n_out;
  ola_kernel<TX><<<elementwise_blocks(total), 256, 0, st>>>(frames, out, Z, T, win, hop, n_out);
  return cudaGetLastError();
}

}  // namespace
