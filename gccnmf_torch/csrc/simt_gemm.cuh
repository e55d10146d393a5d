// The port's one core for products summed as exact fp32 FMAs on Hopper's
// SIMT cores: the NMF's three products in the float32 mode (nmf.cu), the
// soft mask's float32 scores and the Wiener synthesis's tf product
// (enhance.cu), the masked synthesis's spectra product (synthesis.cu) and
// the front-end's float32 angular product (frontend.cu). The two
// syntheses' products also run in the bf16 modes, their operands rounded
// to bf16 as they are staged: JAX's "bf16 operands, fp32 accumulation"
// contract, exact in fp32 (the product of two bf16 values is).
//
// The float32 mode is exact fp32 (JAX's make_mm at HIGHEST): no tensor-core
// instruction computes it (TF32 keeps 10 mantissa bits), so these products
// run as fp32 fused multiply-adds, and what bounds them is the card's SIMT
// rate, 67 TFLOP/s on an H100 SXM. The design keeps the FMA pipes fed:
//
// Register blocking. A block computes a BM x BN output tile (Tile<BM, BN>:
// 128 x 64 or 64 x 128, 128 threads), each thread an 8 x 8 micro-tile in 64
// accumulators. A warp covers 32 rows x 64 columns as 4 x 8 threads; a
// thread's rows are two runs of 4 (16 apart), its columns two runs of 4 (32
// apart), so that at each contraction step it reads its 8 A values and 8 B
// values as four 16-byte shared-memory loads (LDS.128), and a warp's load
// of one run is 64 or 128 contiguous bytes: no bank conflict, 64 FMAs for
// every 4 loads.
//
// Pipelined staging. The contraction runs in 8-deep slices through a ring
// of STAGES (3) stages in shared memory, each an A tile As[k][m]
// (BK rows of BM + 4 floats) and a B tile Bs[k][n]. While a slice's FMAs
// run, the copies of the slice STAGES - 1 ahead are in flight:
//   MN-major fp32 operand (element (k, mn) contiguous along mn, as the
//   tile wants it): cp.async 16-byte copies straight into the stage (4-byte
//   copies where the row stride or base is not 16-byte aligned, or a chunk
//   straddles the last row); a copy past the ragged edge reads nothing and
//   writes zeros (src-size 0).
//   K-major operand (contiguous along the contraction), and any operand
//   converted, rounded to bf16 or masked on its way in: runs of 4 loaded
//   into registers (16-byte loads where aligned), issued before the slice's
//   FMAs, and stored into the stage after them (transposed for a K-major
//   operand: with rows of BM + 4 floats, a warp's 16 rows x 2 runs land in
//   32 distinct banks). What each element becomes is its source's value().
//   A slice wholly inside its operand (every row, every k, one plane, a
//   16-byte aligned row stride) takes a path with no per-chunk checks.
// One __syncthreads a slice: it both publishes slice i and frees the stage
// that the copies of slice i + STAGES - 1 overwrite.
//
// Fixed-order sums. Each output accumulates serially over the contraction,
// in index order, one fmaf a step: no atomics, no split of the contraction
// inside a block. A kernel's tile and any split it adds depend on its
// shapes (T, F, K), never on the batch, so a batch element gives what it
// gives alone, bit for bit, and two runs agree.
//
// A kernel whose contraction is not one product (the soft mask's scores run
// one 2F-deep product per TDOA back to back, one continuous ring; the
// angular product interleaves two) calls ring() with its own fetch, put and
// compute; gemm() is ring() over one contraction.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace gccnmf {
namespace simt {

constexpr int BK = 8;   // contraction slice per ring stage
constexpr int PAD = 4;  // floats after each staged row: 16-byte rows, no transposed-store conflicts

template <int BM_, int BN_, int STAGES_ = 3>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WARPS_M = BM / 32, WARPS_N = BN / 64;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int LDA = BM + PAD, LDB = BN + PAD;  // staged row lengths (floats)
  static constexpr int A_FLOATS = BK * LDA;             // the A tile's floats in a stage
  static constexpr int STAGE = BK * (LDA + LDB);        // floats a stage
  static constexpr int SMEM_FLOATS = STAGES * STAGE;
  static_assert(BM % 32 == 0 && BN % 64 == 0, "a warp covers 32 rows x 64 columns");
  static_assert(STAGES >= 2, "a ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// An operand in device memory, of fp32 (Operand) or bf16 elements.
//   K-major: element (mn, k) at p[mn*ld + k].
//   MN-major: element (k, mn) at row(k)[mn], row(k) = p + k*ld below
//   split and p2 + (k - split)*ld from it (two planes stacked along the
//   contraction, as the soft mask's fold [cw[d]; sw[d]]; cp.async only).
// Elements at mn >= rows or k >= depth stage as zeros.
// As the source of a slice staged through registers (Loader, below) it
// gives runs of 4 elements along its contiguous dimension and stages them
// as fp32; a source of the same shape may convert, round or mask them on
// the way in (Rounded; synthesis.cu's winner mask).
template <typename T>
struct OperandOf {
  const T* p;
  long ld;
  int rows, depth;
  const T* p2 = nullptr;
  int split = INT_MAX;

  using Run = float4;  // a run's registers between fetch and put
  // runs load as 16 bytes: fp32 elements, a whole number of runs a row, an aligned base
  __device__ __forceinline__ bool vec() const {
    return sizeof(T) == 4 && ld % 4 == 0 && aligned16(p);
  }
  // the run at p[off], one 16-byte load (only where vec())
  __device__ __forceinline__ Run run(long off) const {
    return *reinterpret_cast<const float4*>(p + off);
  }
  // the run at p[off], its first n elements (n may be <= 0), zeros past them
  __device__ __forceinline__ Run run(long off, int n) const {
    return make_float4(n > 0 ? to_f32(p[off]) : 0.0f, n > 1 ? to_f32(p[off + 1]) : 0.0f,
                       n > 2 ? to_f32(p[off + 2]) : 0.0f, n > 3 ? to_f32(p[off + 3]) : 0.0f);
  }
  // what the stage holds of a run
  __device__ __forceinline__ float4 value(const Run& v) const { return v; }
};
using Operand = OperandOf<float>;

// An fp32 operand rounded to bf16 (round-to-nearest-even) on its way in
// where rnd: the bf16 modes' operands, where JAX's make_mm rounds them.
struct Rounded : Operand {
  bool rnd;
  __device__ __forceinline__ float4 value(const Run& v) const {
    return rnd ? make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w))
               : v;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages an R x BK slice (R rows of the tile, from row r0; contraction from
// k0) of an operand from source Src into st[k*LD + r], by THREADS threads.
//
// Through registers: every K-major operand, and an MN-major one whose source
// converts, rounds or masks. fetch loads the slice as runs of 4 along the
// operand's contiguous dimension, issued before the slice's FMAs; put
// stores each run's value after them, transposed for a K-major operand (a
// warp's 16 rows x 2 runs land in 32 distinct banks), as one 16-byte store
// for an MN-major one. Thread e of a chunk round takes line e / RUNS (a row
// of a K-major operand, a k of an MN-major one) and run e % RUNS of it.
template <bool KMAJOR, int R, int THREADS, int LD, class Src = Operand>
struct Loader {
  static constexpr int LINES = KMAJOR ? R : BK, RUNS = (KMAJOR ? BK : R) / 4;
  static constexpr int CHUNKS = LINES * RUNS / THREADS;
  static_assert(CHUNKS * THREADS == LINES * RUNS, "whole chunk rounds");
  typename Src::Run v[CHUNKS];

  __device__ __forceinline__ void fetch(const Src& op, int r0, int k0, float*) {
    const int o0 = KMAJOR ? r0 : k0, i0 = KMAJOR ? k0 : r0;  // line, element in the line
    const int on = KMAJOR ? op.rows : op.depth, in = KMAJOR ? op.depth : op.rows;
    const bool vec = op.vec();
    if (vec && o0 + LINES <= on && i0 + 4 * RUNS <= in) {  // an interior slice: no checks
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int e = threadIdx.x + c * THREADS;
        v[c] = op.run((long)(o0 + e / RUNS) * op.ld + i0 + (e % RUNS) * 4);
      }
      return;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * THREADS;
      const int go = o0 + e / RUNS, gi = i0 + (e % RUNS) * 4;
      const int n = go < on ? in - gi : 0;  // the run's elements inside the operand
      const long off = (long)go * op.ld + gi;
      v[c] = vec && n >= 4 ? op.run(off) : op.run(off, n);
    }
  }

  __device__ __forceinline__ void put(float* st, const Src& op) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * THREADS;
      const int o = e / RUNS, i = (e % RUNS) * 4;
      const float4 x = op.value(v[c]);
      if (KMAJOR) {
        st[(i + 0) * LD + o] = x.x;
        st[(i + 1) * LD + o] = x.y;
        st[(i + 2) * LD + o] = x.z;
        st[(i + 3) * LD + o] = x.w;
      } else {
        *reinterpret_cast<float4*>(st + o * LD + i) = x;
      }
    }
  }
};

// An MN-major fp32 operand as it is: cp.async straight into the stage
// (fetch); put has nothing to do.
template <int R, int THREADS, int LD>
struct Loader<false, R, THREADS, LD, Operand> {
  static constexpr int PER_K = R / 4;  // 16-byte chunks of one staged k row
  static constexpr int CHUNKS = BK * PER_K / THREADS;
  static_assert(CHUNKS * THREADS == BK * PER_K, "whole chunk rounds");

  __device__ __forceinline__ void fetch(const Operand& op, int r0, int k0, float* st) {
    const bool vec = op.ld % 4 == 0 && aligned16(op.p) && (op.p2 == nullptr || aligned16(op.p2));
    if (vec && r0 + R <= op.rows && k0 + BK <= op.depth &&
        (k0 + BK <= op.split || k0 >= op.split)) {  // an interior slice in one plane: no checks
      const float* base = k0 < op.split ? op.p + (long)k0 * op.ld
                                        : op.p2 + (long)(k0 - op.split) * op.ld;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int e = threadIdx.x + c * THREADS;
        const int k = e / PER_K, r = (e % PER_K) * 4;
        cp_async16(smem_u32(st + k * LD + r), base + (long)k * op.ld + r0 + r, true);
      }
      return;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * THREADS;
      const int k = e / PER_K, r = (e % PER_K) * 4;
      const int gk = k0 + k, gr = r0 + r;
      const uint32_t dst = smem_u32(st + k * LD + r);
      const bool kin = gk < op.depth;
      const float* row = !kin ? op.p
                         : gk < op.split ? op.p + (long)gk * op.ld
                                         : op.p2 + (long)(gk - op.split) * op.ld;
      if (vec && gr + 4 <= op.rows) {
        cp_async16(dst, kin ? row + gr : op.p, kin);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = kin && gr + j < op.rows;
          cp_async4(dst + 4 * j, ok ? row + gr + j : op.p, ok);
        }
      }
    }
  }

  __device__ __forceinline__ void put(float*, const Operand&) const {}
};

// The ring over n slices: fetch(i, stage) issues slice i's copies (or its
// register loads), put(stage) stores what fetch left in registers,
// compute(i, stage) consumes slice i. Ends with every copy landed and the
// block synchronised, so the caller may reuse the shared memory.
template <class TL, class Fetch, class Put, class Compute>
__device__ __forceinline__ void ring(float* smem, int n, Fetch&& fetch, Put&& put,
                                     Compute&& compute) {
  constexpr int S = TL::STAGES;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) {
      fetch(s, smem + s * TL::STAGE);
      put(smem + s * TL::STAGE);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();  // this thread's copies of slice i have landed
    __syncthreads();         // everyone's have, and nobody still reads stage (i - 1) % S
    const int nx = i + S - 1;
    float* next = smem + (nx % S) * TL::STAGE;
    if (nx < n) fetch(nx, next);
    cp_async_commit();
    compute(i, smem + (i % S) * TL::STAGE);
    if (nx < n) put(next);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// This thread's micro-tile: row i (0..7) and column j (0..7) within the tile.
template <class TL>
__device__ __forceinline__ int frag_row(int i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % TL::WARPS_M) * 32 + (lane / 8) * 4 + (i & 3) + (i >> 2) * 16;
}
template <class TL>
__device__ __forceinline__ int frag_col(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / TL::WARPS_M) * 64 + (lane % 8) * 4 + (j & 3) + (j >> 2) * 32;
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += Σ_k As[k][row i] · Bs[k][col j] over one staged slice, k in order.
template <class TL>
__device__ __forceinline__ void fma_slice(const float* st, float (&acc)[8][8]) {
  const float* as = st + frag_row<TL>(0);
  const float* bs = st + TL::A_FLOATS + frag_col<TL>(0);
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * TL::LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * TL::LDA + 16);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * TL::LDB);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * TL::LDB + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = the block's tile at (m0, n0) of Σ_{k_lo <= k < k_hi} A[m, k]·B[k, n]
// (a's rows are the output rows, b's the output columns; k_hi <= each
// operand's depth), from the sources SA and SB.
template <class TL, bool A_KMAJOR, bool B_KMAJOR, class SA = Operand, class SB = Operand>
__device__ __forceinline__ void gemm(float (&acc)[8][8], float* smem, const SA& a, const SB& b,
                                     int m0, int n0, int k_lo, int k_hi) {
  zero(acc);
  Loader<A_KMAJOR, TL::BM, TL::THREADS, TL::LDA, SA> la;
  Loader<B_KMAJOR, TL::BN, TL::THREADS, TL::LDB, SB> lb;
  ring<TL>(
      smem, (k_hi - k_lo + BK - 1) / BK,
      [&](int i, float* st) {
        la.fetch(a, m0, k_lo + i * BK, st);
        lb.fetch(b, n0, k_lo + i * BK, st + TL::A_FLOATS);
      },
      [&](float* st) {
        la.put(st, a);
        lb.put(st + TL::A_FLOATS, b);
      },
      [&](int, const float* st) { fma_slice<TL>(st, acc); });
}

// The (column tile, row tile, batch) grid of a product. CUDA caps gridDim.y
// at 65,535, so rows past 65,535 tiles (8,388,480 in tiles of 128,
// 4,194,240 in tiles of 64) cannot launch in one grid. Kernel 1's float32
// launches are chunked along the rows (nmf.cu row_chunks); no other path
// comes near it: the spectra and angular products tile the T frames of one
// utterance (7,493 at 60 s, hop 128), the Wiener product B·T (119,888 at
// the enhancer's 16 utterances of 60 s).
template <class TL>
inline dim3 grid(int rows, int cols, int batch) {
  return dim3((cols + TL::BN - 1) / TL::BN, (rows + TL::BM - 1) / TL::BM, batch);
}

}  // namespace simt
}  // namespace gccnmf
