// The inverse-STFT tail shared by the separation and enhancement synthesis
// kernels (synthesis.cu, enhance.cu): a windowed, gained iDFT GEMM from the
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
//     x[Z·T·F + r·F + f]; frames_kernel, the SIMT tile of common.cuh, reads
//     them (no tensor-core path is exact fp32).
//   bf16 (the rounding points of JAX's make_mm: X and the basis in bf16,
//     fp32 sums, frames in bf16): one bf16 row a spectrum row,
//     [Re X[:F] | Im X[:F] | 0] of ldj = 2F rounded up to 8 (16-byte rows
//     for cp.async), the padding written as zeros by the spectra kernel.
//     tc_frames_kernel reads them on the tensor cores.
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
// share it in L2; the 2 MB basis stays in L2.
//
// The kernels sit in a top-level anonymous namespace (nvcc's registration
// stubs reject one nested in a named namespace): each source that includes
// this header gets its own copy, as each is compiled without relocatable
// device code and registers its own kernels.
#pragma once

#include "common.cuh"
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

// float32: frames[z,t,j] = Σ_f Re X[t,f]·A[f,j] + Im X[t,f]·Bneg[f,j]
__global__ void __launch_bounds__(NTHREADS)
frames_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float* __restrict__ basis_a, const float* __restrict__ basis_b,
              float* __restrict__ frames, int T, int F, int win) {
  __shared__ __align__(16) TileA Ar, Ai;
  __shared__ __align__(16) TileB Ba, Bb;
  const int z = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xrb = xr + (long)z * T * F;
  const float* xib = xi + (long)z * T * F;
  float acc[4][4];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += BK) {
    stage_a<true>(Ar, xrb, F, 1, m0, f0, T, F, false);        // (t, f) at X[t*F + f]
    stage_a<true>(Ai, xib, F, 1, m0, f0, T, F, false);
    stage_b<true>(Ba, basis_a, win, 1, f0, n0, F, win, false);  // (f, j) at A[f*win + j]
    stage_b<true>(Bb, basis_b, win, 1, f0, n0, F, win, false);
    __syncthreads();
    tile_fma(Ar, Ba, acc);
    tile_fma(Ai, Bb, acc);
    __syncthreads();
  }
  float* fb = frames + (long)z * T * win;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = out_col(n0, j);
      if (col < win) fb[(long)t * win + col] = acc[i][j];
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

cudaError_t launch_frames(const float* x, const float* basis_a, const float* basis_b,
                          const bf16*, int, float* frames, int Z, int T, int F, int win,
                          cudaStream_t st) {
  frames_kernel<<<tile_grid(T, win, Z), NTHREADS, 0, st>>>(x, x + (long)Z * T * F, basis_a,
                                                           basis_b, frames, T, F, win);
  return cudaGetLastError();
}

cudaError_t launch_frames(const bf16* x, const float*, const float*, const bf16* basis_rows,
                          int ldj, bf16* frames, int Z, int T, int F, int win, cudaStream_t st) {
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
// spectra of T frames: X as put_x laid it out (fp32 planes, or bf16 rows of
// ldj with the (win, ldj) bf16 basis_rows), frames (Z, T, win) scratch in
// the type of X, out (Z, (T−1)·hop) fp32.
template <typename TX>
cudaError_t run_istft(const TX* x, const float* basis_a, const float* basis_b,
                      const bf16* basis_rows, int ldj, TX* frames, float* out, int Z, int T,
                      int F, int win, int hop, cudaStream_t st) {
  cudaError_t err = launch_frames(x, basis_a, basis_b, basis_rows, ldj, frames, Z, T, F, win, st);
  if (err != cudaSuccess) return err;
  const long n_out = (long)(T - 1) * hop, total = (long)Z * n_out;
  ola_kernel<TX><<<elementwise_blocks(total), 256, 0, st>>>(frames, out, Z, T, win, hop, n_out);
  return cudaGetLastError();
}

}  // namespace
