// The inverse-STFT tail shared by the separation and enhancement synthesis
// kernels (synthesis.cu, enhance.cu): a windowed, gained iDFT GEMM from the
// masked spectrum planes Re X, Im X to frames, then the gather form of
// overlap-add with the window/2 center trim.
//
// The TPU kernels carry the overlap-add tail between time tiles on their
// sequential grid; Hopper blocks run in any order, so here the frames reach
// device memory and a second launch sums, for each output sample, the
// window/hop frames that cover it, in a fixed order (no atomics).
//
// The kernels sit in a top-level anonymous namespace (nvcc's registration
// stubs reject one nested in a named namespace): each source that includes
// this header gets its own copy, as each is compiled without relocatable
// device code and registers its own kernels.
#pragma once

#include "common.cuh"

namespace {

using namespace gccnmf;

// frames[z,t,j] = Σ_f Re X[t,f]·A[f,j] + Im X[t,f]·Bneg[f,j]
template <typename TX, typename TF>
__global__ void __launch_bounds__(NTHREADS)
frames_kernel(const TX* __restrict__ xr, const TX* __restrict__ xi,
              const float* __restrict__ basis_a, const float* __restrict__ basis_b,
              TF* __restrict__ frames, int T, int F, int win, bool rnd) {
  __shared__ __align__(16) TileA Ar, Ai;
  __shared__ __align__(16) TileB Ba, Bb;
  const int z = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TX* xrb = xr + (long)z * T * F;
  const TX* xib = xi + (long)z * T * F;
  float acc[4][4];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += BK) {
    stage_a<true>(Ar, xrb, F, 1, m0, f0, T, F, rnd);        // (t, f) at X[t*F + f]
    stage_a<true>(Ai, xib, F, 1, m0, f0, T, F, rnd);
    stage_b<true>(Ba, basis_a, win, 1, f0, n0, F, win, rnd);  // (f, j) at A[f*win + j]
    stage_b<true>(Bb, basis_b, win, 1, f0, n0, F, win, rnd);
    __syncthreads();
    tile_fma(Ar, Ba, acc);
    tile_fma(Ai, Bb, acc);
    __syncthreads();
  }
  TF* fb = frames + (long)z * T * win;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = out_row(m0, i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = out_col(n0, j);
      if (col < win) fb[(long)t * win + col] = from_f32<TF>(acc[i][j]);
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

// Launch frames_kernel then ola_kernel over Z = (batch · targets · channels)
// spectra of (T, F): frames (Z, T, win) scratch, out (Z, (T−1)·hop).
template <typename TX>
cudaError_t run_istft(const TX* xr, const TX* xi, const float* basis_a,
                      const float* basis_b, TX* frames, float* out, int Z, int T, int F,
                      int win, int hop, bool rnd, cudaStream_t st) {
  frames_kernel<TX, TX><<<tile_grid(T, win, Z), NTHREADS, 0, st>>>(
      xr, xi, basis_a, basis_b, frames, T, F, win, rnd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n_out = (long)(T - 1) * hop, total = (long)Z * n_out;
  ola_kernel<TX><<<elementwise_blocks(total), 256, 0, st>>>(frames, out, Z, T, win, hop,
                                                            n_out);
  return cudaGetLastError();
}

}  // namespace
