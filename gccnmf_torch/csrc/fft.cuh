// The float32 FFT that the iDFT of the syntheses (istft.cuh
// fft_frames_kernel) and the front-end's rDFT (frontend.cu
// fft_coherence_kernel) share: the constants of a plan, the complex
// helpers, the R-point butterflies and one Stockham pass of each radix.
//
// A block of FFT_THREADS threads holds its transforms wholly in shared
// memory, two rows of fft_row(win) complex values each (ping-pong
// buffers), and runs one pass a radix of the host's plan
// (ops/synthesis_cuda.py fft_plan: 4s, a 2, 3s, 5s, then any other prime
// as a generic radix), every twiddle read from one table of the win-th
// roots of unity (fft_twiddles). The passes compute the unnormalised
// transform with the + sign, Σ_u v[u]·e^{+2πi qu/L}: the inverse DFT, and
// the conjugated forward one. Each transform runs the same butterflies in
// the same order wherever it lies in the grid.
//
// Like every header here, it sits in a top-level anonymous namespace: each
// source that includes it gets its own copy.
#pragma once

#include "common.cuh"

namespace {

using namespace gccnmf;

// An FFT's constants, built once on the host (synthesis_basis for the
// iDFT, frontend_basis for the rDFT).
struct FftPlan {
  const float* scale;  // (win,) window · gain (the iDFT) or the window (the rDFT)
  const float2* tw;    // (win,) e^{+2πi m/win}
  const int* radix;    // the Stockham passes' radices, in order
  int passes;
};

constexpr int FFT_THREADS = 256;  // the kernel's loops stride by it: launch exactly this many
constexpr int FFT_LOADS = 8;      // X's loads a thread keeps in flight while staging
constexpr int FFT_SMEM_TARGET = 40960;  // a block's bytes at most (4 frames, 32 KB at 1,024)
constexpr int FFT_MAX_FRAMES = 16;      // and its transforms at most (short windows)
// Dynamic shared memory a block may take on Hopper (227 KB): one
// transform's two rows must fit (ops/synthesis_cuda.py FFT_MAX_SMEM)
constexpr int FFT_MAX_SMEM = 232448;

// The complex transform's length, a frame's row in shared memory
// (ops/synthesis_cuda.py fft_row_len), and the frames a block holds.
__host__ __device__ constexpr int fft_len(int win) { return win % 2 == 0 ? win / 2 : win; }
__host__ __device__ constexpr int fft_row(int win) { return (fft_len(win) + 1) | 1; }
__host__ __device__ constexpr int fft_frames_per_block(int win) {
  const int per = FFT_SMEM_TARGET / (2 * fft_row(win) * (int)sizeof(float2));
  return per < 1 ? 1 : per > FFT_MAX_FRAMES ? FFT_MAX_FRAMES : per;
}

// The window that fft_frames_kernel is also compiled for, its length a
// constant: the reference configurations' 1,024. Every division and index
// of the kernel then folds at compile time, where at a window known only
// at run time each butterfly spends dozens of instructions dividing.
constexpr int FFT_FIXED_WIN = 1024;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float s, float2 a) { return make_float2(s * a.x, s * a.y); }
__device__ __forceinline__ float2 times_i(float2 a) { return make_float2(-a.y, a.x); }

// v ← the R-point inverse DFT of v: v[q] = Σ_u v[u]·e^{+2πi qu/R}.
template <int R>
__device__ __forceinline__ void idft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void idft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void idft<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = times_i(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void idft<3>(float2 (&v)[3]) {
  constexpr float S = 0.86602540378443865f;  // sin(2π/3)
  const float2 s = cadd(v[1], v[2]);
  const float2 m = csub(v[0], cscale(0.5f, s));
  const float2 e = times_i(cscale(S, csub(v[1], v[2])));
  v[0] = cadd(v[0], s);
  v[1] = cadd(m, e);
  v[2] = csub(m, e);
}

template <>
__device__ __forceinline__ void idft<5>(float2 (&v)[5]) {
  constexpr float C1 = 0.30901699437494742f, C2 = -0.80901699437494742f;  // cos 2π/5, 4π/5
  constexpr float S1 = 0.95105651629515357f, S2 = 0.58778525229247314f;   // sin 2π/5, 4π/5
  const float2 s14 = cadd(v[1], v[4]), d14 = csub(v[1], v[4]);
  const float2 s23 = cadd(v[2], v[3]), d23 = csub(v[2], v[3]);
  const float2 m1 = cadd(v[0], cadd(cscale(C1, s14), cscale(C2, s23)));
  const float2 m2 = cadd(v[0], cadd(cscale(C2, s14), cscale(C1, s23)));
  const float2 e1 = times_i(cadd(cscale(S1, d14), cscale(S2, d23)));
  const float2 e2 = times_i(csub(cscale(S2, d14), cscale(S1, d23)));
  v[0] = cadd(v[0], cadd(s14, s23));
  v[1] = cadd(m1, e1);
  v[4] = csub(m1, e1);
  v[2] = cadd(m2, e2);
  v[3] = csub(m2, e2);
}

// One Stockham pass of radix R over the block's nf frames (rows of ld):
// with ns the product of the earlier passes' radices, butterfly j of a
// frame (k = j mod ns) reads src[j + q·L/R], multiplies input q by
// e^{2πi kq/(ns·R)}, transforms, and writes output q to
// dst[(j − k)·R + k + q·ns]. tstep = win/L maps a power of the L-th root
// to the table of win-th roots; pow2 (L a power of two, so ns is one too)
// takes j mod ns as a mask.
template <int R>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ src, float2* __restrict__ dst,
                                         const float2* __restrict__ tw, int L, int ns,
                                         int tstep, int nf, int ld, bool pow2) {
  const int m = L / R, step = (L / (ns * R)) * tstep;
  for (int e = threadIdx.x; e < nf * m; e += FFT_THREADS) {
    const int fr = e / m, j = e - fr * m, k = pow2 ? j & (ns - 1) : j % ns;
    const float2* s = src + fr * ld + j;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = s[q * m];
#pragma unroll
    for (int q = 1; q < R; ++q) v[q] = cmul(v[q], __ldg(tw + k * q * step));
    idft<R>(v);
    float2* d = dst + fr * ld + (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) d[q * ns] = v[q];
  }
}

// The same pass for any other prime radix p: output q = Σ_u (input u ·
// e^{2πi ku/(ns·p)}) · e^{2πi qu/p}, a direct p-point DFT from shared
// memory (the radix is known only at run time, so nothing is held in
// registers).
__device__ __forceinline__ void fft_pass_generic(const float2* __restrict__ src,
                                                 float2* __restrict__ dst,
                                                 const float2* __restrict__ tw, int L, int ns,
                                                 int p, int tstep, int nf, int ld) {
  const int m = L / p, step = (L / (ns * p)) * tstep, rot = m * tstep;
  for (int e = threadIdx.x; e < nf * m; e += FFT_THREADS) {
    const int fr = e / m, j = e - fr * m, k = j % ns;
    const float2* s = src + fr * ld + j;
    float2* d = dst + fr * ld + (j - k) * p + k;
    for (int q = 0; q < p; ++q) {
      float2 acc = make_float2(0.0f, 0.0f);
      for (int u = 0; u < p; ++u) {
        const float2 x = cmul(s[u * m], __ldg(tw + k * u * step));
        acc = cadd(acc, cmul(x, __ldg(tw + (q * u % p) * rot)));
      }
      d[q * ns] = acc;
    }
  }
}

// The passes of plan over the nf rows (of ld complex values) of buffer 0
// at smem, ping-ponging with buffer 1 at smem + half; returns the buffer
// (0 or 1) that holds the transforms. Buffer 0 must be written and the
// block synchronised before the call; it returns synchronised.
__device__ __forceinline__ int fft_passes(float2* smem, int half, const FftPlan& plan, int L,
                                          int tstep, int nf, int ld, bool pow2) {
  int cur = 0;  // the buffer that holds the latest pass's output
  for (int p = 0, ns = 1; p < plan.passes; ++p) {
    const int r = plan.radix[p];
    const float2* src = smem + cur * half;
    float2* dst = smem + (cur ^ 1) * half;
    switch (r) {
      case 4: fft_pass<4>(src, dst, plan.tw, L, ns, tstep, nf, ld, pow2); break;
      case 2: fft_pass<2>(src, dst, plan.tw, L, ns, tstep, nf, ld, pow2); break;
      case 3: fft_pass<3>(src, dst, plan.tw, L, ns, tstep, nf, ld, pow2); break;
      case 5: fft_pass<5>(src, dst, plan.tw, L, ns, tstep, nf, ld, pow2); break;
      default: fft_pass_generic(src, dst, plan.tw, L, ns, r, tstep, nf, ld);
    }
    __syncthreads();
    cur ^= 1;
    ns *= r;
  }
  return cur;
}

}  // namespace
