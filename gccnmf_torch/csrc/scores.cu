// The soft mask's bf16 scores on Hopper: kernel 4's products (enhance.cu
// packs the coherence rows before and merges and masks after).
//
// Replaces the products of gccnmf_tpu/ops/enhance_pallas.py::soft_mask_pallas
// (body _mask_kernel) in the bf16 mode: for rows m = (b, t) and atoms k,
//
//   s[m,d,k] = A[m]·B_d[k],  A[m] = [Re c[m, :F] | Im c[m, :F] | 0],
//                            B_d[k] = [cw[d, :, k] | sw[d, :, k] | 0]
//
// (bf16 rows of ldj, 2F deep: JAX's mm(Re c, cw[d]) + mm(Im c, sw[d]) on the
// bf16-rounded fold), and the running (max, argmax) over d of each (m, k),
// which never leaves the chip: the (B, T, D, K) fp32 scores would be 31 GB at
// the enhancement cell's B = 16, T = 7,493, D = 64, K = 1,024.
//
// What bounds it: 4·B·T·F·D·K flop (16.1 TFLOP at that shape, 16.3 ms at
// the bf16 tensor-core peak) against 0.25 GB of coherence planes and 0.14 GB
// of fold, so the products, if the copies into shared memory keep up. They
// did not in the kernel this one replaced (128 rows x 128 atoms a block, every
// thread issuing cp.async and meeting at a __syncthreads for each 64-deep
// slice, the tensor cores drained at every slice): 32 KiB copied from L2
// per 2.1 MFLOP, 267 GB a chunk at the cell's shape, 66.8 ms on an H100.
//
// The design halves the bytes copied per flop and keeps the tensor pipe
// fed:
//   - A block computes 128 rows x 256 columns: two TDOAs (d, d + 1) of 128
//     atoms each, one wgmma m64n256k16 per k16 step and consumer
//     warpgroup, so a slice of A serves twice the flops.
//   - Two row tiles form a cluster. Each block's producer copies its own A
//     tile (16 KiB) and one TDOA's half of the fold tile (16 KiB), the
//     latter multicast to both blocks: 32 KiB from L2 per 4.2 MFLOP,
//     half the old ratio (134 GB a chunk at the cell's shape). An odd
//     number of row tiles leaves the last cluster's second block without
//     rows: it copies zeros of A (the map's bounds) and its half of the
//     fold for its peer, and writes nothing. Both operands lie on rows of
//     whole 128-byte lines (ldj a multiple of 64), so a box row is one
//     line.
//   - One producer thread keeps TMA loads in flight in a ring of 4 stages
//     (48 KiB each: A, then B_d, then B_d+1, in the 128-byte swizzle that
//     tc_gemm.cuh's descriptors read), with a full and an empty mbarrier a
//     stage. The two consumer warpgroups retire each slice with
//     wgmma_wait<1> (the next slice's products are issued before the last
//     one's are waited for) and release its stage to the producers of both
//     blocks through their empty barriers; no __syncthreads in the loop.
//   - setmaxnreg gives the producer warpgroup's registers to the
//     consumers: 128 accumulators and 64 running maxima a thread, the
//     argmax bytes in shared memory (16 words a thread, read and written
//     once a TDOA pair).
//
// On an H100 at the cell's shape it takes 22.9 ms (704 TFLOP/s). What is
// left is the fold: both warpgroups fold a pair's 128 accumulators at the
// same time, while the tensor cores wait; a build without the fold ran in
// 17.7 ms.
//
// The numbers are the replaced kernel's: each score is still 2F/64 slices
// of four k16 steps, in order, summed in fp32 from zero, and the pair is
// folded d before d + 1 with a strict > (the first maximum wins; NaN never
// does; an all-NaN column gives d0), so neither the tile, the cluster nor
// the row's place in them changes a bit. A TDOA past the block's chunk or
// past D is copied as zeros or as the next chunk's and never folded.
#include <math.h>

#include "common.cuh"
#include "tc_gemm.cuh"

using namespace gccnmf;

extern __shared__ __align__(128) unsigned char tc_smem[];  // ScoreRing::SMEM_BYTES

namespace {

// The block's shared memory from its first swizzle atom: the ring's
// stages, the argmax words, the full and the empty barriers.
struct ScoreRing {
  static constexpr int STAGES = 4;
  static constexpr int CLUSTER = 2;                    // row tiles a cluster
  static constexpr int A_BYTES = tc::TILE_A;           // 128 rows x 64 of A
  static constexpr int HALF = 128 * tc::BK * 2;        // 128 atoms x 64 of one B_d
  static constexpr int STAGE_BYTES = A_BYTES + 2 * HALF;
  static constexpr int CONSUMERS = 256;                // two warpgroups of 64 rows
  static constexpr int THREADS = CONSUMERS + 128;      // and the producer's warpgroup
  static constexpr int ACC = 128;                      // fp32 accumulators a thread
  static constexpr int ARG_WORDS = ACC / 2 / 4;        // argmax bytes of 64 maxima
  static constexpr int ARGS = STAGES * STAGE_BYTES;
  static constexpr int BARS = ARGS + ARG_WORDS * CONSUMERS * 4;
  // the slack aligns the ring to a swizzle atom (tc_smem is aligned to 128)
  static constexpr int SMEM_BYTES = BARS + 2 * STAGES * 8 + 1024 - 128;
};
using SR = ScoreRing;

// Running (max, argmax) over d in [d0, d0 + chunk) ∩ [0, D), d0 = split·chunk
// (chunk <= 256), of s[m,d,k] = rows[m]·fold[d,k] (J = 2F deep) for the
// block's 128 rows and 128 atoms; written to pmax/parg at [split, m, k].
// Grid: (splits, atom tiles, row tiles rounded up to the cluster), in
// clusters of two row tiles. The maps: rows (ldj, M, 1), fold (ldj, K, D),
// both in boxes of 64 x 128.
__global__ void __launch_bounds__(SR::THREADS, 1)
tma_score_argmax_kernel(const __grid_constant__ CUtensorMap rows_map,
                        const __grid_constant__ CUtensorMap fold_map, float* __restrict__ pmax,
                        int* __restrict__ parg, int M, int J, int K, int D, int chunk) {
  constexpr int S = SR::STAGES;
  const int split = blockIdx.x, n0 = blockIdx.y * 128, m0 = blockIdx.z * tc::BM;
  const int d0 = split * chunk, nd = min(D, d0 + chunk) - d0;
  const int nk = (J + tc::BK - 1) / tc::BK;  // slices per TDOA pair
  const int pairs = (nd + 1) / 2, n = pairs * nk;
  unsigned char* base = tc_smem + ((1024 - (tc::smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t ring = tc::smem_u32(base), full = ring + SR::BARS, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(full + 8 * s, 1);
      tc::mbar_init(empty + 8 * s, 2 * SR::CLUSTER);  // both consumer warpgroups of each block
    }
    tc::mbar_init_fence();
  }
  tc::cluster_sync();  // every block's barriers are set before a copy or arrival reaches them
  if (threadIdx.x >= SR::CONSUMERS) {
    // ---- the producer: one thread issues the copies of slice i into stage i % S
    tc::setmaxnreg_dec<40>();
    if (threadIdx.x == SR::CONSUMERS) {
      const uint32_t rank = tc::cluster_rank();
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        if (i >= S) tc::mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);  // both blocks read it
        const uint32_t st = ring + s * SR::STAGE_BYTES, bar = full + 8 * s;
        const int k0 = (i % nk) * tc::BK, d = d0 + 2 * (i / nk);
        tc::mbar_expect_tx(bar, SR::STAGE_BYTES);
        tc::tma_load_3d(st, &rows_map, k0, m0, 0, bar);
        // this block's TDOA of the pair, into both blocks
        tc::tma_load_3d_multicast(st + SR::A_BYTES + rank * SR::HALF, &fold_map, k0, n0,
                                  d + (int)rank, bar, 0x3);
      }
    }
    tc::cluster_sync();  // no block leaves while a peer may still write or arrive here
  } else {
    // ---- the consumers: warpgroup wg multiplies rows wg·64 .. + 63 of A
    tc::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    uint32_t* args = reinterpret_cast<uint32_t*>(base + SR::ARGS) + threadIdx.x;
    float acc[SR::ACC], best[SR::ACC / 2];  // best[r]: accumulators r (TDOA d) and r + 64 (d + 1)
#pragma unroll
    for (int r = 0; r < SR::ACC; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int r = 0; r < SR::ACC / 2; ++r) best[r] = -INFINITY;
#pragma unroll
    for (int w = 0; w < SR::ARG_WORDS; ++w) args[w * SR::CONSUMERS] = 0u;
    // stage i % S is released to the producers of every block of the cluster
    auto release = [&](int i) {
      if (threadIdx.x % 128 == 0)
        for (int q = 0; q < SR::CLUSTER; ++q) tc::mbar_arrive_cluster(empty + 8 * (i % S), q);
    };
    // slice i's products into acc, from stage i % S once its copies are in
    auto issue = [&](int i) {
      const uint32_t st = ring + (i % S) * SR::STAGE_BYTES;
      tc::mbar_wait(full + 8 * (i % S), (i / S) & 1);
      tc::fence_acc(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < tc::BK / 16; ++j)
        tc::wgmma<0, 0>(acc, tc::tile_desc<false, tc::BM>(st, wg * 64, j),
                        tc::tile_desc<false, 256>(st + SR::A_BYTES, 0, j));
      tc::wgmma_commit();
    };
    for (int p = 0, i = 0; p < pairs; ++p, i += nk) {
      // The pair's first slice is issued before the loop, so every path into
      // the loop and around it has one group in flight: where a path with
      // none joined one with a group in flight, ptxas waited for every group
      // at the join (C7517), and each slice's products ran alone.
      issue(i);
      for (int k = 1; k < nk; ++k) {
        issue(i + k);
        tc::wgmma_wait<1>();  // slice i + k - 1's products are done, slice i + k's run on
        tc::fence_acc(acc);
        release(i + k - 1);
      }
      tc::wgmma_wait<0>();  // the pair's scores are complete: fold them
      tc::fence_acc(acc);
      release(i + nk - 1);
      const uint32_t dl = 2 * p;  // d − d0 of the pair's first TDOA
      const bool second = (int)dl + 1 < nd;
#pragma unroll
      for (int w = 0; w < SR::ARG_WORDS; ++w) {
        uint32_t a = args[w * SR::CONSUMERS];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * w + e;
          // strict, d before d + 1: the first maximum wins; NaN never
          if (acc[r] > best[r]) {
            best[r] = acc[r];
            a = (a & ~(0xFFu << (8 * e))) | (dl << (8 * e));
          }
          if (second && acc[r + 64] > best[r]) {
            best[r] = acc[r + 64];
            a = (a & ~(0xFFu << (8 * e))) | ((dl + 1) << (8 * e));
          }
          acc[r] = 0.0f;
          acc[r + 64] = 0.0f;
        }
        args[w * SR::CONSUMERS] = a;
      }
    }
    const long out = (long)split * M * K;
#pragma unroll
    for (int w = 0; w < SR::ARG_WORDS; ++w) {
      const uint32_t a = args[w * SR::CONSUMERS];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * w + e, m = m0 + tc::acc_row(r), k = n0 + tc::acc_col(r);
        if (m < M && k < K) {
          pmax[out + (long)m * K + k] = best[r];
          parg[out + (long)m * K + k] = d0 + (int)((a >> (8 * e)) & 0xFFu);
        }
      }
    }
    tc::cluster_sync();
  }
}

}  // namespace

namespace gccnmf {

// The bf16 scores' (max, argmax) per chunk: rows (M, ldj) and fold (D, K,
// ldj) bf16, 16-byte aligned, ldj a multiple of 8 (of 64 for rows of whole
// lines).
cudaError_t run_tc_scores(const bf16* rows, const bf16* fold, int ldj, float* pmax, int* parg,
                          int M, int F, int K, int D, int splits, int chunk,
                          cudaStream_t st) {
  const void* kernel = reinterpret_cast<const void*>(tma_score_argmax_kernel);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SR::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  // setmaxnreg hands the producer's registers to the consumers (232 - 168
  // a consumer thread from 168 - 40 a producer thread): a build whose launch
  // held fewer than 168 a thread would leave the consumers waiting for
  // registers forever, so it is refused
  static const int regs = [kernel] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
  }();
  if (err == cudaSuccess && regs != 65536 / SR::THREADS / 8 * 8)
    err = cudaErrorInvalidDeviceFunction;
  CUtensorMap rows_map, fold_map;
  if (err == cudaSuccess) err = tc::plane_map(&rows_map, rows, true, ldj, M, 1, 128);
  if (err == cudaSuccess) err = tc::plane_map(&fold_map, fold, true, ldj, K, D, 128);
  if (err != cudaSuccess) return err;
  const int row_tiles = (M + tc::BM - 1) / tc::BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (K + 127) / 128, (row_tiles + SR::CLUSTER - 1) / SR::CLUSTER * SR::CLUSTER);
  cfg.blockDim = dim3(SR::THREADS);
  cfg.dynamicSmemBytes = SR::SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = SR::CLUSTER;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tma_score_argmax_kernel, rows_map, fold_map, pmax, parg, M,
                           2 * F, K, D, chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace gccnmf
