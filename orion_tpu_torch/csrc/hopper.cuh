// Hopper (sm_90a) building blocks shared by the wgmma kernels of this
// directory: gmm.cu, flash_attention.cu, flash_attention_bwd.cu,
// causal_dot_norm.cu and causal_dot_bwd.cu.
//
//   - shared-memory addresses and mbarriers, with a wait that traps after 4 s
//     of the card's clock, so a pipeline fault is a launch error, never a
//     hung card;
//   - TMA copies (cp.async.bulk.tensor, 2-D and 3-D) that complete on an
//     mbarrier, and the host-side tensor-map encoding through the runtime's
//     driver entry point (no -lcuda);
//   - wgmma descriptors for 128-byte swizzled operands, the fences and the
//     m64n64k16 / m64n128k16 bf16 products these kernels issue;
//   - split_pair: an fp32 value as two bf16 halves, for the products whose
//     operand the TPU kernels keep in fp32, and write_state: a carried fp32
//     state tile as those halves in the layout TMA lands (the linear
//     attention walks of causal_dot_norm.cu and causal_dot_bwd.cu).
//
// Each source builds into its own library (ops/kernels/library.py passes -I
// to this directory and hashes every header a source includes), so
// everything here is internal to the translation unit that includes it.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

// ---------------------------------------------------------------------------
// Shared memory and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed. Traps after 4
// s: a fault in the pipeline (bytes that never arrive) ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}

// The generic pointer to the shared-memory address smem_addr of the block's
// dynamic shared memory `smem`.
template <typename T> __device__ __forceinline__ T* at(uint32_t smem_addr, unsigned char* smem) {
  return reinterpret_cast<T*>(smem + (smem_addr - smem_u32(smem)));
}

// Orders this thread's ordinary shared-memory stores before later reads of
// the same bytes by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier among the `count` threads (whole warps) that name barrier `id`;
// id 0 is __syncthreads'.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
      "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row, row + 64) of head `head` (columns 0-127) of a map made by
// encode_heads into a 64 x 128 tile: two boxes.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int head) {
  tma_3d(dst, map, bar, 0, row, head);
  tma_3d(dst + 64 * 64 * 2, map, bar, 64, row, head);
}

// cuTensorMapEncodeTiled through the runtime's entry point (no -lcuda).
inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, byte strides of dims 1..)
// read in boxes `box`, 128-byte swizzled, zeros past every edge.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled fn = encode_fn();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 [heads, rows, width] tensor as a 3-D map {width, rows, heads}, read
// in boxes of 64 rows x 64 columns (one 128-byte row each): a box that runs
// past `rows` or `width` is zero-filled inside its own head.
inline bool encode_heads(CUtensorMap* map, const void* base, int width, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)rows * width * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// Whether TMA can take p as a base (16-byte aligned).
inline bool tma_ok(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor with the 128-byte swizzle: 8-row groups
// of 128-byte rows 1024 bytes apart (the stride byte offset), `lbo` the
// leading byte offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint32_t SBO = 1024;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((SBO >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The operand layouts of a bf16 tile of 64 rows x 128 columns as TMA lands
// it through encode_heads' boxes: two boxes of 64 rows x 64 columns, 8 KB
// each, 128-byte swizzled. Read K-major (the columns are the reduction), a
// 16-deep slice starts 32 bytes along the row, slices 4-7 in the second
// box. Read MN-major (the rows are the reduction), a 16-deep slice starts 16
// rows (2048 bytes) further, and the next 64 columns are one box (the
// leading offset) further. Slices past row 64 continue the same pattern, so
// a buffer of 128 rows x 64 columns reads MN-major as slices 0-7.
constexpr int HALF_BYTES = 64 * 64 * 2;     // one box: 64 rows x 64 columns
constexpr int TILE_BYTES = 2 * HALF_BYTES;  // 64 rows x 128 columns
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * HALF_BYTES + (kk & 3) * 32, 16);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, HALF_BYTES);
}

// The byte offset of element (t, d) of a 64 x 128 tile as TMA lands it (two
// swizzled boxes); for d < 64 also of a single 64 x 64 box.
__device__ __forceinline__ int tile_offset(int t, int d) {
  return (d >> 6) * HALF_BYTES + t * 128 + ((((d & 63) >> 3) ^ (t & 7)) << 4) + (d & 7) * 2;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A[64 x 16] B[16 x 64], both in shared memory. TA / TB: the
// transpose bits, 1 for an MN-major operand.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (four bf16 pairs a
// thread, the accumulator fragment's order), B in shared memory; TB: B's
// transpose bit, 1 for MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A from registers, B in shared
// memory; TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32),
        HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#undef HOPPER_ACC8

// The accumulator of an m64nN product holds, in this thread's element j,
// row 16 warp + lane / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) + 2 (lane %
// 4) + j % 2 of the warpgroup's tile (warp and lane within the warpgroup).
// Its 16-column slice kk (elements 8 kk .. 8 kk + 7) taken as bf16 pairs is
// exactly wgmma's register A fragment of the k16 slice kk.

// The largest of x over the four lanes that share an accumulator row, and
// their sum.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x as hi = bf16(x) and lo = bf16(x - hi), two values a register: the A
// fragment's pairs (the lower column in the lower half).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A carried fp32 state tile (rows m of 128, columns n of 64) as the two bf16
// halves of an MN-major B operand: rows of 128 bytes, 128-byte swizzled (the
// 16-byte chunk n / 8 of row m at chunk (n / 8) xor (m % 8)), the layout TMA
// lands. sa, sb: the warpgroup's m64n64 accumulators of rows 0-63 and
// 64-127.
__device__ __forceinline__ void write_state(const float (&sa)[32], const float (&sb)[32],
                                            unsigned char* hi, unsigned char* lo) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int m = 64 * half + 16 * warp + lane / 4 + 8 * ((j / 2) % 2);
      const int n = 8 * (j / 4) + 2 * (lane % 4);
      const int off = m * 128 + (((n >> 3) ^ (m & 7)) << 4) + (n & 7) * 2;
      uint32_t h, l;
      split_pair(half ? sb[j] : sa[j], half ? sb[j + 1] : sa[j + 1], h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

}  // namespace hopper
}  // namespace
