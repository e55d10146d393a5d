// Tensor-core product core for the port's bf16 GEMMs on Hopper (sm_90a):
// the NMF's products (nmf.cu: three over a materialised Q, and two
// back-to-back products that keep Q on chip, their second product's A
// from registers, wgmma_rs, their tiles copied by TMA), the soft mask's
// scores (scores.cu: a warp-specialised TMA ring, its fold tiles multicast
// across a cluster), the syntheses' iDFT (istft.cuh) and the front-end's
// rDFT and angular spectrogram (frontend.cu).
//
// One block of 256 threads computes a 128 x BN fp32 output tile (BN = 128
// or 64) as two consumer warpgroups of 64 rows each, with
// wgmma.mma_async.m64nBNk16.f32.bf16.bf16: both operands read from shared
// memory through matrix descriptors, the sums kept in BN / 2 fp32
// registers a thread. The contraction runs in 64-deep slices through a ring
// of STAGES stages in dynamic shared memory, each an A tile (128 x 64 bf16,
// 16 KiB) and a B tile (BN x 64 bf16). Every thread of the block fills the
// ring with cp.async 16-byte copies; a copy past the ragged edge reads
// nothing and writes zeros (src-size 0), so a contraction never sees
// garbage and K need not divide the slice. Tile shapes (Tile<BN, STAGES>):
//   Tile<128, 3>: 96 KiB ring (+1 KiB alignment slack), 64 accumulators,
//     two blocks an SM: the long contractions over F and t, the iDFT and
//     the front-end's products.
//   Tile<64, 3>: 72 KiB ring, 32 accumulators, three blocks an SM: the
//     ratio's short contraction over K (two slices, both loaded at once),
//     whose epilogue (a guarded divide per output) costs more than its
//     products, so more blocks in flight hide it; 64-wide tiles also waste
//     less of F = 513 (576 columns against 640).
// A kernel whose A tile is not one operand (the front-end's 64 frames of
// each channel) streams its slices through ring() itself, with load_tile,
// load_stage and mma_stage; gemm is ring over one contraction.
//
// Operands live in device memory as bf16 rows padded to a multiple of 8
// elements (16 bytes), the padding zero, so every copy is one aligned
// 16-byte vector. An operand is either K-major (element (mn, k) at
// p[mn*ld + k]) or MN-major (at p[k*ld + mn]); wgmma's transpose bits take
// the MN-major ones as they lie, so no product materialises a transpose.
//
// Shared-memory layout: the 128-byte swizzle (layout type 1), which lets
// the tensor cores read every core matrix without bank conflicts (the
// unswizzled layout, where the 8 core matrices of a 64-row operand sit
// 1024 bytes apart in the same banks, ran each 64-deep slice several times
// slower on the card). BK = 64 bf16 is one 128-byte swizzle row, and a
// swizzle atom is 8 such rows (1024 bytes, 1024-byte aligned) in which
// 16-byte chunk c of row r sits at chunk c ^ r.
//   K-major tile (R x 64): row mn at mn x 128 bytes, its chunk kc at
//     kc ^ (mn % 8); stride byte offset 1024 (8-row groups); a k16 step
//     moves the start address 32 bytes along the row.
//   MN-major tile (R x 64): atom (K group kg, MN atom ma) of 8 K rows x 64
//     MN elements at (kg x R/64 + ma) x 1024; leading byte offset 1024
//     (MN atoms), stride byte offset R/64 x 1024 (K groups); a k16 step
//     moves the start two K groups on.
// Copies map 8 consecutive threads to the 8 chunks of one swizzle row, so
// they land in 8 distinct bank groups and read 128 contiguous bytes.
//
// Epilogues do not walk the accumulator fragment (pairs of columns in rows
// 8 apart, which made each thread's loads of V or H a chain of scattered
// accesses): stage_acc writes the tile to shared memory, and each warp then
// takes whole rows, so its reads and writes of device memory coalesce and
// a thread issues a batch of loads before it uses one.
//
// wgmma discipline: wgmma.fence before a slice's first mma_async, the
// accumulators fenced against compiler reordering around each batch, and
// wait_group 0 before the __syncthreads that lets any thread refill the
// stage just read. fence.proxy.async makes the cp.async writes (generic
// proxy) visible to wgmma's reads (async proxy).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gccnmf {
namespace tc {

constexpr int BM = 128;      // output rows per block: two warpgroups of 64
constexpr int BK = 64;       // contraction slice per ring stage
constexpr int THREADS = 256; // two warpgroups
constexpr int TILE_A = BM * BK * 2;  // bytes of an A stage

// The shapes of one kernel's tiles: BN output columns a block (the wgmma
// N), STAGES ring stages.
template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int ACC = BN / 2;  // fp32 accumulators a thread
  static constexpr int STAGE_BYTES = TILE_A + BN * BK * 2;
  // the epilogue's fp32 output tile: rows of LDS = BN + 8 floats (the
  // fragment's float2 writes of a half-warp then hit 32 distinct banks);
  // each thread takes EPI items of 4 adjacent columns
  static constexpr int LDS = BN + 8;
  static constexpr int EPI = BM * BN / 4 / THREADS;
  static constexpr int RING = STAGES * STAGE_BYTES, OUT = BM * LDS * 4;
  // the ring or the output tile, plus the slack that aligns the ring to a
  // swizzle atom
  static constexpr int SMEM_BYTES = (RING > OUT ? RING : OUT) + 1024;
  static_assert(BN == 64 || BN == 128, "wgmma shapes instantiated: n64, n128");
  static_assert(THREADS % (BN / 4) == 0, "an item's column must not depend on i");
};
static_assert(BK == 64, "one 64-deep bf16 slice is one 128-byte swizzle row");

// A bf16 operand in device memory: element (mn, k) at p[mn*ld + k]
// (K-major) or p[k*ld + mn] (MN-major), ld a multiple of 8. The block's
// tile starts at MN index mn0 (a multiple of 8); a copy stages zeros where
// its MN index is at or past mn_lim or its K index at or past k_lim (for
// the contiguous dimension, where the 16-byte chunk starts).
struct Operand {
  const __nv_bfloat16* p;
  long ld;
  int mn0, mn_lim, k_lim;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The tensor memory accelerator (TMA) and its barriers: thread 0 of a
// block arms an mbarrier with the bytes a stage expects and issues the
// stage's tile copies, each a box of a 3-D tensor map (columns, rows,
// batch) written into shared memory in the 128-byte swizzle, zeros past
// the tensor's bounds; every thread then waits on the barrier's phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Box (c0, c1, c2) of the tensor map at map (a __grid_constant__ kernel
// parameter) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// Thread-block clusters (the soft mask's scores, scores.cu): blocks of one
// cluster share TMA copies. A copy multicast to the blocks of mask lands at
// the same shared offset in each and completes on the barrier at bar's
// offset in each; a consumer releases a stage by arriving on the barrier
// at the same offset in every block whose producer writes it.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: what each did before is
// visible to all after (barrier initialisation, the last remote arrivals).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// One arrival on the mbarrier at shared offset bar in the cluster's block
// rank (this block's own for its rank), with mbarrier.arrive's default
// semantics (release at CTA scope), as for a consumer whose reads of the
// stage were wgmma's, complete at its wgmma.wait_group. A .release.cluster
// arrival made every release wait on the thread's memory operations at
// cluster scope: the soft mask's scores ran 2.1 times slower with it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// Box (c0, c1, c2) of the tensor map into shared offset dst of every block
// in mask (bit r: cluster rank r), completing on bar's offset in each.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const void* map, int c0,
                                                      int c1, int c2, uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "h"(mask)
      : "memory");
}
// Hand registers between the warpgroups of a warp-specialised block: the
// producer's gives its up, the consumers' take them (every thread of the
// warpgroup, on one path that never rejoins the other's).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// cuTensorMapEncodeTiled (host), looked up once through
// cudaGetDriverEntryPoint, so nothing links libcuda; null where the driver
// has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  return encode;
}
// The tensor map of a plane of batch x rows rows of ld elements (bf16 or
// fp32; ld · size a multiple of 16, p 16-byte aligned) as (columns, rows,
// batch), in boxes of 128 bytes of columns x box_rows rows (at most 256)
// in the 128-byte swizzle, zeros past its bounds.
inline cudaError_t plane_map(CUtensorMap* map, const void* p, bool is_bf16, int ld, int rows,
                             int batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t size = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {ld * size, ld * size * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / size), (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            3, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) asm volatile("" : "+f"(acc[r])::"memory");
}

// A matrix descriptor of the 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Descriptor of k16 step j of the 64 MN rows from row mn (a multiple of
// 64) of the swizzled R x BK tile at shared address tile.
template <bool MN_MAJOR, int R>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int mn, int j) {
  if (MN_MAJOR) {
    constexpr uint32_t sbo = (R / 64) * 1024;
    return make_desc(tile + (mn / 64) * 1024 + j * 2 * sbo, 1024, sbo);
  }
  return make_desc(tile + mn * 128 + j * 32, 16, 1024);  // lbo unused when K-major
}

// d += A·B for one 64 x N x 16 step; TA / TB = 1 reads that operand
// MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A·B for one 64 x N x 16 step with A from registers (N = 128 or
// 256): a holds this thread's four bf16 pairs of the 64 x 16 slice of A in
// the accumulator fragment's places (a[0]: row acc_row(0), columns
// acc_col(0) and + 1; a[1]: row + 8; a[2], a[3]: the same 8 columns on), so
// an fp32 accumulator of one product, rounded to bf16 pairs, is the A of
// the next with no shuffle. TB = 1 reads B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// Copy the R x BK slice [mn0, mn0 + R) x [k0, k0 + BK) of op into the
// swizzled tile at shared address dst, one 16-byte chunk (8 elements along
// the contiguous dimension) per copy.
template <bool MN_MAJOR, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const Operand& op, int k0) {
  constexpr int CHUNKS = R * BK / 8;
#pragma unroll
  for (int e = threadIdx.x; e < CHUNKS; e += THREADS) {
    int mn, k;
    uint32_t off;
    const __nv_bfloat16* src;
    if (MN_MAJOR) {  // BK rows along K of R / 8 chunks along MN
      const int mc = e % (R / 8);
      k = e / (R / 8);
      mn = mc * 8;
      off = ((k / 8) * (R / 64) + mc / 8) * 1024 + (k % 8) * 128 + ((mc % 8) ^ (k % 8)) * 16;
      src = op.p + (long)(k0 + k) * op.ld + op.mn0 + mn;
    } else {  // R rows along MN of BK / 8 chunks along K
      const int kc = e % 8;
      mn = e / 8;
      k = kc * 8;
      off = mn * 128 + (kc ^ (mn % 8)) * 16;
      src = op.p + (long)(op.mn0 + mn) * op.ld + k0 + k;
    }
    const bool ok = op.mn0 + mn < op.mn_lim && k0 + k < op.k_lim;
    cp_async16(dst + off, ok ? src : op.p, ok);
  }
}

// Copy slice [k0, k0 + BK) of A's BM rows and B's BN columns into the ring
// stage at shared address st.
template <class TL, bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(uint32_t st, const Operand& a, const Operand& b,
                                           int k0) {
  load_tile<A_MN, BM>(st, a, k0);
  load_tile<B_MN, TL::BN>(st + TILE_A, b, k0);
}

// acc += the 64-deep slice product of the stage at st, waited for: each
// warpgroup multiplies its 64 rows of A by the stage's BN columns of B.
template <class TL, bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_stage(float (&acc)[TL::ACC], uint32_t st) {
  const int a_rows = (threadIdx.x / 128) * 64;  // this warpgroup's rows of A
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma<A_MN, B_MN>(acc, tile_desc<A_MN, BM>(st, a_rows, j),
                      tile_desc<B_MN, TL::BN>(st + TILE_A, 0, j));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// Stream n slices through the ring of TL::STAGES stages in smem (TL::SMEM_BYTES
// of dynamic shared memory): load(i, st) issues slice i's copies into stage
// st, use(i, st) runs once every thread's copies of slice i have landed.
// A stage is refilled only after the __syncthreads that follows its use, so
// use must be done reading it when it returns.
template <class TL, class Load, class Use>
__device__ __forceinline__ void ring(unsigned char* smem, int n, Load&& load, Use&& use) {
  constexpr int S = TL::STAGES, SB = TL::STAGE_BYTES;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // swizzle atoms
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s, base + s * SB);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();  // slice i has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed; slice i - 1 fully read
    const int next = i + S - 1;  // refills the stage slice i - 1 used
    if (next < n) load(next, base + (next % S) * SB);
    cp_async_commit();
    use(i, base + (i % S) * SB);
  }
  cp_async_wait<0>();
}

// acc = A·B over K indices [k_begin, k_end): A is this block's BM rows
// (K-major unless A_MN), B its BN columns (K-major unless B_MN). Each
// warpgroup keeps its 64 rows of the tile in acc, laid out as
// acc_row / acc_col say. smem: TL::SMEM_BYTES of dynamic shared memory.
template <class TL, bool A_MN, bool B_MN>
__device__ __forceinline__ void gemm(float (&acc)[TL::ACC], unsigned char* smem,
                                     const Operand& a, const Operand& b, int k_begin,
                                     int k_end) {
#pragma unroll
  for (int r = 0; r < TL::ACC; ++r) acc[r] = 0.0f;
  ring<TL>(
      smem, (k_end - k_begin + BK - 1) / BK,
      [&](int i, uint32_t st) { load_stage<TL, A_MN, B_MN>(st, a, b, k_begin + i * BK); },
      [&](int, uint32_t st) { mma_stage<TL, A_MN, B_MN>(acc, st); });
}

// Row within the block's BM rows, and column within its BN, of accumulator
// r (the m64nNk16 fp32 fragment: warp w of the block owns rows 16w..16w+15;
// a thread holds pairs of adjacent columns, every 8 columns, in two rows 8
// apart).
__device__ __forceinline__ int acc_row(int r) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * ((r / 2) % 2);
}
__device__ __forceinline__ int acc_col(int r) {
  return 8 * (r / 4) + 2 * (threadIdx.x % 4) + (r % 2);
}

// Item i of this thread's EPI epilogue items: row epi_row(i) of the tile
// and columns epi_col() .. + 3, so a warp covers whole rows.
template <class TL>
__device__ __forceinline__ int epi_row(int i) {
  return (threadIdx.x + i * THREADS) / (TL::BN / 4);
}
template <class TL>
__device__ __forceinline__ int epi_col() { return (threadIdx.x % (TL::BN / 4)) * 4; }

// Write acc to the fp32 tile s[BM][LDS] (over the ring, once every
// warpgroup is done with it).
template <class TL>
__device__ __forceinline__ void stage_acc(const float (&acc)[TL::ACC], float* s) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TL::ACC; r += 2)
    *reinterpret_cast<float2*>(s + acc_row(r) * TL::LDS + acc_col(r)) =
        make_float2(acc[r], acc[r + 1]);
  __syncthreads();
}

// Ask L2 for the rows [r0, r0 + BM) x bytes [c0, c0 + 4 x 128) of a
// row-major plane with rows of ld bytes, rows < rows and bytes < width
// only, so that an epilogue's loads of them hit L2: one 128-byte line per
// request, issued when the block starts. On an H100 it takes the ratio's
// launch at B = 16 from about 97 to 86 us (chip_nmf_phases.py
// --no-prefetch); in the H update, where it competes with the slice
// copies, it was slower, so only the ratio asks.
__device__ __forceinline__ void prefetch_tile_l2(const void* p, long ld, int r0, int rows,
                                                 long c0, long width) {
  for (int i = threadIdx.x; i < BM * 4; i += THREADS) {
    const int r = r0 + i / 4;
    const long c = c0 + (i % 4) * 128;
    if (r < rows && c < width)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(static_cast<const char*>(p) + r * ld + c));
  }
}

// Four floats as four bf16 (round to nearest even), for one 8-byte store.
__device__ __forceinline__ uint2 pack_bf16x4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// The (column tile, row tile, batch) grid of a product. CUDA caps gridDim.y
// at 65,535, so rows past 8,388,480 (65,535 tiles of 128) cannot launch.
// No path comes near it: the bf16 products run 10 s utterances (T = 2,486
// rows of left‖right at the reference shape, 16 of them at once in z), and
// long audio's one-device NMF runs the float32 mode, whose launches are
// chunked along the rows (nmf.cu row_chunks).
template <class TL>
inline dim3 grid(int rows, int cols, int batch) {
  return dim3((cols + TL::BN - 1) / TL::BN, (rows + BM - 1) / BM, batch);
}

}  // namespace tc
}  // namespace gccnmf
