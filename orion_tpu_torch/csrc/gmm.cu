// Grouped expert matmul (gmm) for Hopper (sm_90a): the dropless mixture of
// experts' expert products, forward and weight gradient.
//
// Replaces two TPU kernels of orion_tpu/ops/pallas/gmm.py:
//
//   gmm_fwd_wgmma_kernel, gmm_fwd_kernel <- _fwd_kernel (launched by
//     _gmm_call). Rows of x [M, K] lie in tile-aligned expert segments: row
//     tile i (tile_rows rows) belongs to expert te[i]. It writes
//         y[r] = x[r] @ W[te[r / tile_rows]]                 (x's dtype)
//     with W[e] = w[e] ([K, N], w [E, K, N]) or, with transpose_w, w[e]^T
//     (w [E, N, K]): the backward's dx = dy @ w[e]^T reads the stack in place
//     instead of the 90 MB copy swapaxes(w, 1, 2) the TPU path makes.
//   gmm_dw_wgmma_kernel, gmm_dw_kernel <- _dw_kernel (launched by _dw_call):
//         dw[e] = sum over expert e's row tiles of x_tile^T @ g_tile
//     x [M, D], g [M, H] -> dw [E, D, H] fp32; an expert without tiles gets 0.
//
// Two routes, chosen by the wrapper before the launch (ops/kernels/gmm.py,
// gmm_variant / gmm_dw_variant), each with its own kernels:
//
//   wgmma (gmm_fwd_wgmma_kernel, gmm_dw_wgmma_kernel): bf16 operands whose
//     widths are multiples of 8 and bases 16-byte aligned, which is what TMA
//     can describe; every model width is. The main path's route.
//   simt (gmm_fwd_kernel, gmm_dw_kernel): everything else -- fp32 operands
//     (the tiny models) and bf16 at widths TMA cannot stride (K or N not a
//     multiple of 8). Synchronous: thread-issued 16-byte loads into shared
//     memory, sync, multiply, sync.
//
// Bound. At moe_1b3_4e's training shape (8192 routed rows, tile-aligned to
// M = 8704; d 2048, h 5504; 4 experts) one call is 2 M K N = 196.2 GFLOP,
// 0.198 ms at the 989 TFLOP/s bf16 tensor-core peak, against 222 MB read and
// written by the forward (0.066 ms at 3.35 TB/s) and 312 MB by dw: bound by
// operations. So the wgmma route feeds Hopper's asynchronous tensor-core
// product from shared memory that TMA fills ahead of it:
//
//   - A block owns a 128 x 256 output tile: two consumer warpgroups, each one
//     wgmma.mma_async m64n256k16 (bf16 in, fp32 accumulators in registers,
//     128 a thread) per 16-deep slice, and one producer warp whose first lane
//     issues the TMA copies. N = 256, not 128: a 128 x 256 tile does 85
//     operations for each byte it brings into shared memory, a 128 x 128 one
//     64, and 256 is the widest wgmma takes; 128 accumulators a thread fit in
//     the 224 registers 288 threads may hold.
//   - The reduction walks 64-deep steps (64 bf16 = 128 bytes: one row of the
//     128-byte swizzle) through a ring of 4 stages of 48 KB (A 128 x 64, B
//     256 x 64), each with a "full" mbarrier (the producer arms it with the
//     stage's bytes; TMA completes it) and an "empty" one (each consumer
//     warpgroup arrives once wgmma.wait_group says the step's products have
//     read the stage). Up to 3 stages are in flight while the tensor cores
//     work on the fourth.
//   - Operands land 128-byte swizzled (the tensor maps' swizzle mode), the
//     layout the wgmma descriptors name. Three layouts: forward A = x, K-major; B =
//     w[e] [K, N], N-major (the transpose bit on B); dx: B = w[e] [N, K],
//     K-major; dw: A = x^T read from x [rows, d], M-major (the transpose bit
//     on A), B = g [rows, H], N-major.
//   - w's tensor map is 3-D ([E, K, N] or [E, N, K]), so TMA fills zeros past
//     K and N inside one expert instead of reading the next expert's rows;
//     the K and N tails (and whole boxes past N) are TMA's zero fill.
//   - Epilogue straight from the registers: y rounded once to bf16, two
//     values a store; dw in fp32, two a store. Rows and columns past the
//     output are masked; an expert without tiles stores its zero accumulators.
//   - Grid order as the simt route: row tiles inner, so consecutive blocks
//     share a weight tile in L2 (one expert's weight is 22.5 MB, the stack
//     90 MB, the L2 50 MB). One block per output tile, not persistent.
//   - The tensor maps are encoded on the host at each call (the pointers
//     change), through the runtime's driver entry point, so the library
//     needs no -lcuda.
//   - A wait on an mbarrier that has not completed after 4 s of the card's
//     clock traps: a pipeline fault is a launch error, never a hung card.
//   - The TMA, mbarrier and wgmma helpers come from hopper.cuh, shared with
//     the flash attention and linear attention kernels.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 0.32-0.38
//   ms a call at that shape, 49-58 % of the operations bound. A call brings
//   2.3 GB from L2 into shared memory (48 KB a block and step), at 6.1-7.1
//   TB/s in every product: that rate, not the tensor cores, is the likely
//   limit (no counter reads it there), and TMA multicast of B across a
//   cluster of blocks the next step (ROADMAP.md queue B).
//
// The simt route: a block owns a 128 x 128 output tile and walks the
// reduction axis in steps of 32, staging both operand tiles in shared memory
// (zeros past every edge, so any K, N, D, H is taken) and accumulating in
// fp32. bf16 operands go through the tensor cores (nvcuda::wmma 16 x 16 x 16
// bf16 fragments, fp32 accumulators; 8 warps, each a 64 x 32 slab of the
// tile); fp32 operands through fp32 FMAs on the CUDA cores (a thread owns 8 x
// 8 outputs). The accumulators go through shared memory once at the end and
// are written with one rounding to the output dtype (the TPU kernel's
// preferred_element_type=float32, then astype).
//
// Both routes:
//   - forward: the grid is (row tile, column tile); a block reads its expert
//     from the tile table on the device (the TPU kernel's scalar prefetch), so
//     no tile counts ever reach the host. tile_rows must be a multiple of 128,
//     so a block never straddles two experts.
//   - dw: the TPU kernel revisits one output block over consecutive grid steps
//     and zeroes it on an expert's first tile. Blocks here run in no order, so
//     a block owns one (expert, d tile, h tile) output and walks that expert's
//     row tiles itself, from tile_start[e] for tile_count[e] tiles (both
//     computed on the device from the table): no atomics, a fixed summation
//     order, and an expert with no tile writes zeros from its untouched
//     accumulators.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;   // output tile rows (x rows; dw's d)
constexpr int BN = 128;   // output tile columns (y's N; dw's h)
constexpr int BK = 32;    // reduction step
constexpr int NT = 256;   // threads per block: 8 warps
constexpr int PAD = 8;    // shared-memory row padding, in elements
constexpr int LDC = BN + 4;
constexpr int TILE_ELEMS = (BM * (BK + PAD) > BK * (BM + PAD)) ? BM * (BK + PAD) : BK * (BM + PAD);

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.f); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// An R x C tile of a row-major source (row stride lds) into shared memory
// (row stride ldd), 16 bytes a thread where the source allows it, zeros at
// rows >= rows and columns >= cols.
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* __restrict__ src,
                                          long long lds, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CV = C / V;
  for (int e = threadIdx.x; e < R * CV; e += NT) {
    const int r = e / CV, c = (e % CV) * V;
    T* d = dst + r * ldd + c;
    const T* s = src + r * lds + c;
    if (r < rows && c + V <= cols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = (r < rows && c + v < cols) ? s[v] : zero<T>();
    }
  }
}

// The block's 128 x 128 fp32 accumulator. A_KMAJOR: the A tile is staged as
// As[k][m] (dw's x, read transposed), else As[m][k]. B_NMAJOR: the B tile is
// staged as Bs[n][k] (a transposed weight), else Bs[k][n].
template <typename T, bool A_KMAJOR, bool B_NMAJOR> struct Acc;

template <bool A_KMAJOR, bool B_NMAJOR> struct Acc<bf16, A_KMAJOR, B_NMAJOR> {
  using ALayout = typename std::conditional<A_KMAJOR, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<B_NMAJOR, wmma::col_major, wmma::row_major>::type;
  static constexpr int LDA = A_KMAJOR ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_NMAJOR ? BK + PAD : BN + PAD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x / 32;
    const int m0 = (warp / 4) * 64, n0 = (warp % 4) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 16 * i;
        wmma::load_matrix_sync(a[i], A_KMAJOR ? As + kk * LDA + m : As + m * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + 16 * j;
        wmma::load_matrix_sync(b[j], B_NMAJOR ? Bs + n * LDB + kk : Bs + kk * LDB + n, LDB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
        }
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int warp = threadIdx.x / 32;
    const int m0 = (warp / 4) * 64, n0 = (warp % 4) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (m0 + 16 * i) * LDC + n0 + 16 * j, c[i][j], LDC,
                                wmma::mem_row_major);
  }
};

template <bool A_KMAJOR, bool B_NMAJOR> struct Acc<float, A_KMAJOR, B_NMAJOR> {
  static constexpr int LDA = A_KMAJOR ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_NMAJOR ? BK + PAD : BN + PAD;
  float c[8][8];  // rows ty + 16 i, columns tx + 16 j

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        a[i] = A_KMAJOR ? As[kk * LDA + m] : As[m * LDA + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = B_NMAJOR ? Bs[n * LDB + kk] : Bs[kk * LDB + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = c[i][j];
  }
};

// The accumulators through shared memory (which aliases the operand tiles)
// into out[r0 + r][c0 + c] (row stride ldo), rows < rows, columns < cols.
template <typename Acc, typename O>
__device__ __forceinline__ void write_out(Acc& acc, float* Cs, O* __restrict__ out,
                                          long long ldo, int rows, int cols) {
  __syncthreads();  // every warp is done reading the operand tiles
  acc.store(Cs);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    if (r < rows && c < cols) out[r * ldo + c] = from_f<O>(Cs[r * LDC + c]);
  }
}

template <typename T, bool TRANSPOSE_W>
__global__ void __launch_bounds__(NT) gmm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ tile_expert,
    T* __restrict__ y, int m, int k, int n, int tile_rows, int n_experts) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE_ELEMS;
  using AccT = Acc<T, false, TRANSPOSE_W>;

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int e = min(max(tile_expert[row0 / tile_rows], 0), n_experts - 1);
  const T* we = w + (size_t)e * k * n;

  AccT acc;
  acc.init();
  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous step's reads of As, Bs are done
    load_tile<T, BM, BK>(As, AccT::LDA, x + (size_t)row0 * k + k0, k, m - row0, k - k0);
    if (TRANSPOSE_W)  // w[e] is [N, K]: stage Bs[n][k]
      load_tile<T, BN, BK>(Bs, AccT::LDB, we + (size_t)col0 * k + k0, k, n - col0, k - k0);
    else  // w[e] is [K, N]: stage Bs[k][n]
      load_tile<T, BK, BN>(Bs, AccT::LDB, we + (size_t)k0 * n + col0, n, k - k0, n - col0);
    __syncthreads();
    acc.step(As, Bs);
  }
  write_out(acc, reinterpret_cast<float*>(smem), y + (size_t)row0 * n + col0, n, m - row0,
            n - col0);
}

template <typename T>
__global__ void __launch_bounds__(NT) gmm_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, float* __restrict__ dw, int d, int h, int tile_rows,
    int n_ht) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE_ELEMS;
  using AccT = Acc<T, true, false>;

  const int e = blockIdx.y;
  const int d0 = (blockIdx.x / n_ht) * BM, h0 = (blockIdx.x % n_ht) * BN;
  const int r0 = tile_start[e] * tile_rows;
  const int n_rows = tile_count[e] * tile_rows;

  AccT acc;
  acc.init();
  for (int s0 = 0; s0 < n_rows; s0 += BK) {
    __syncthreads();
    // x rows [r0 + s0, +32) x columns [d0, +128), staged As[row][d]: x^T's tile
    load_tile<T, BK, BM>(As, AccT::LDA, x + (size_t)(r0 + s0) * d + d0, d, n_rows - s0, d - d0);
    load_tile<T, BK, BN>(Bs, AccT::LDB, g + (size_t)(r0 + s0) * h + h0, h, n_rows - s0, h - h0);
    __syncthreads();
    acc.step(As, Bs);
  }
  write_out(acc, reinterpret_cast<float*>(smem), dw + ((size_t)e * d + d0) * h + h0, h, d - d0,
            h - h0);
}

constexpr int SMEM_BYTES = BM * LDC * (int)sizeof(float);  // >= both fp32 operand tiles

template <typename K>
cudaError_t allow_smem(K kernel) {
  static_assert(2 * TILE_ELEMS * (int)sizeof(float) <= SMEM_BYTES, "operand tiles exceed smem");
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

template <typename T, bool TRANSPOSE_W>
cudaError_t launch_fwd(const void* x, const void* w, const int* te, void* y, int m, int k, int n,
                       int n_experts, int tile_rows, cudaStream_t stream) {
  cudaError_t err = allow_smem(gmm_fwd_kernel<T, TRANSPOSE_W>);
  if (err != cudaSuccess) return err;
  const dim3 grid(m / BM, (n + BN - 1) / BN);
  gmm_fwd_kernel<T, TRANSPOSE_W><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), te, static_cast<T*>(y), m, k, n,
      tile_rows, n_experts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, const int* start, const int* count, float* dw,
                      int d, int h, int n_experts, int tile_rows, cudaStream_t stream) {
  cudaError_t err = allow_smem(gmm_dw_kernel<T>);
  if (err != cudaSuccess) return err;
  const int n_dt = (d + BM - 1) / BM, n_ht = (h + BN - 1) / BN;
  const dim3 grid(n_dt * n_ht, n_experts);
  gmm_dw_kernel<T><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), start, count, dw, d, h, tile_rows, n_ht);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma route: TMA into a ring of shared-memory stages, wgmma from there
// ---------------------------------------------------------------------------

constexpr int WM = 128;                      // output tile rows: two warpgroups of 64
constexpr int WN = 256;                      // output tile columns: one m64n256k16
constexpr int WK = 64;                       // reduction step: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int A_BYTES = WM * WK * 2;         // 16 KB
constexpr int B_BYTES = WN * WK * 2;         // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CHUNK_BYTES = 64 * WK * 2;     // one [64][64] bf16 box: 8 KB
constexpr int WG_THREADS = 2 * 128 + 32;     // two consumer warpgroups, one producer warp
// the stages at a 1024-byte-aligned base (the 128-byte swizzle repeats every
// 8 rows of 128 bytes), then the full and empty barriers
constexpr int WG_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

// 128-byte swizzled operand layouts, as the wgmma descriptor reads them.
// K-major ([rows][64 k], one 128-byte row each): 8-row groups 1024 bytes
// apart (the stride byte offset), the leading offset unused; a 16-deep slice
// starts 32 bytes further along the row. MN-major ([64 k][64 mn] boxes of 8
// KB): 8-k-row groups 1024 bytes apart, the next 64 columns of M or N one box
// (8 KB, the leading offset) further; a 16-deep slice starts 16 rows (2048
// bytes) further.
constexpr uint32_t KMAJOR_LBO = 16, KMAJOR_STEP = 32;
constexpr uint32_t MNMAJOR_LBO = CHUNK_BYTES, MNMAJOR_STEP = 16 * 128;

#define ACC8(i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += A[64 x 16] B[16 x 256], both from shared memory. TA / TB:
// the transpose bits, 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64),
        ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef ACC8

// The ring: STAGES stages of [A | B] at a 1024-byte-aligned base, then a
// "full" and an "empty" barrier for each.
struct Ring {
  uint32_t tiles, bars;
  __device__ __forceinline__ uint32_t a(int s) const { return tiles + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem) {
  Ring r;
  r.tiles = (smem_u32(smem) + 1023) & ~1023u;
  r.bars = r.tiles + STAGES * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(r.empty(s), 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer's turn for reduction step kt: wait until the consumers have
// released the stage's previous contents, arm its full barrier with the
// stage's bytes (whole boxes: TMA counts the zeros it fills), and return the
// stage.
__device__ __forceinline__ int produce_step(const Ring& r, int kt) {
  const int s = kt % STAGES;
  if (kt >= STAGES) mbar_wait(r.empty(s), ((kt / STAGES) + 1) & 1);
  mbar_expect_tx(r.full(s), STAGE_BYTES);
  return s;
}

// A consumer warpgroup's walk over n_k reduction steps into its 64 x 256
// accumulator: A_STEP / B_STEP and A_LBO / B_LBO per the operands' layouts.
template <int TA, int TB, uint32_t A_LBO, uint32_t A_STEP, uint32_t B_LBO, uint32_t B_STEP>
__device__ __forceinline__ void consume(const Ring& r, int n_k, float (&acc)[128]) {
  const int wg = threadIdx.x / 128;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(r.full(s), (kt / STAGES) & 1);
    const uint32_t a = r.a(s) + wg * CHUNK_BYTES, b = r.b(s);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_m64n256k16<TA, TB>(acc, sw128_desc(a + kk * A_STEP, A_LBO),
                               sw128_desc(b + kk * B_STEP, B_LBO));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the step before is done: release its stage
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(r.empty((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// The accumulator element j (0..127) of this thread lies at row
// 16 warp + lane / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) + 2 (lane % 4) + j % 2
// of the warpgroup's 64 x 256 tile.
template <typename O>
__device__ __forceinline__ void store_pair(O* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// out[r0 + r][c0 + c] (row stride ldo) for r < rows, c < cols from the
// warpgroup's accumulators; cols even, so a pair is in or out whole.
template <typename O>
__device__ __forceinline__ void store_acc(const float (&acc)[128], O* __restrict__ out,
                                          long long ldo, int rows, int cols) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = (threadIdx.x / 128) * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (c < cols) {
      if (r < rows) store_pair(out + r * ldo + c, acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < rows) store_pair(out + (r + 8) * ldo + c, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// y [M, N] bf16 = x [M, K] @ W[e]. xmap: x as [M][K], boxes of 128 rows x 64
// k. wmap: w as [E][K][N] (boxes of 64 k x 64 n; four fill B's 256 columns)
// or, TRANSPOSE_W, as [E][N][K] (one box of 256 n x 64 k).
template <bool TRANSPOSE_W>
__global__ void __launch_bounds__(WG_THREADS, 1) gmm_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const int* __restrict__ tile_expert, bf16* __restrict__ y, int k, int n, int tile_rows,
    int n_experts) {
  extern __shared__ unsigned char smem[];
  const Ring r = make_ring(smem);
  const int row0 = blockIdx.x * WM, col0 = blockIdx.y * WN;
  const int n_k = (k + WK - 1) / WK;
  if (threadIdx.x >= 256) {  // the producer warp: its first lane issues the copies
    if (threadIdx.x == 256) {
      const int tile = row0 / tile_rows;
      const int e = min(max(tile_expert[tile], 0), n_experts - 1);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = produce_step(r, kt);
        tma_2d(r.a(s), &xmap, r.full(s), kt * WK, row0);
        if (TRANSPOSE_W) {
          tma_3d(r.b(s), &wmap, r.full(s), kt * WK, col0, e);
        } else {
          for (int j = 0; j < WN / 64; ++j)
            tma_3d(r.b(s) + j * CHUNK_BYTES, &wmap, r.full(s), col0 + 64 * j, kt * WK, e);
        }
      }
    }
    return;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (TRANSPOSE_W)  // B = w[e] [N, K]: K-major
    consume<0, 0, KMAJOR_LBO, KMAJOR_STEP, KMAJOR_LBO, KMAJOR_STEP>(r, n_k, acc);
  else  // B = w[e] [K, N]: N-major, the transpose bit on B
    consume<0, 1, KMAJOR_LBO, KMAJOR_STEP, MNMAJOR_LBO, MNMAJOR_STEP>(r, n_k, acc);
  store_acc(acc, y + (size_t)row0 * n + col0, n, WM, n - col0);
}

// dw [E, D, H] fp32: block (d tile, h tile) of expert blockIdx.y walks the
// expert's rows in steps of 64. xmap: x as [M][D], gmap: g as [M][H], both in
// boxes of 64 rows x 64 columns (two fill A's 128 d, four fill B's 256 h).
__global__ void __launch_bounds__(WG_THREADS, 1) gmm_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    float* __restrict__ dw, int d, int h, int tile_rows, int n_ht) {
  extern __shared__ unsigned char smem[];
  const Ring r = make_ring(smem);
  const int e = blockIdx.y;
  const int d0 = (blockIdx.x / n_ht) * WM, h0 = (blockIdx.x % n_ht) * WN;
  const int n_k = tile_count[e] * (tile_rows / WK);
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      const int r0 = tile_start[e] * tile_rows;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = produce_step(r, kt);
        for (int j = 0; j < WM / 64; ++j)
          tma_2d(r.a(s) + j * CHUNK_BYTES, &xmap, r.full(s), d0 + 64 * j, r0 + kt * WK);
        for (int j = 0; j < WN / 64; ++j)
          tma_2d(r.b(s) + j * CHUNK_BYTES, &gmap, r.full(s), h0 + 64 * j, r0 + kt * WK);
      }
    }
    return;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // A = x^T: M-major (the transpose bit on A), one 64-wide box a warpgroup;
  // B = g: N-major
  consume<1, 1, MNMAJOR_LBO, MNMAJOR_STEP, MNMAJOR_LBO, MNMAJOR_STEP>(r, n_k, acc);
  store_acc(acc, dw + ((size_t)e * d + d0) * h + h0, h, d - d0, h - h0);
}

template <bool TRANSPOSE_W>
cudaError_t launch_fwd_wgmma(const void* x, const void* w, const int* te, void* y, int m, int k,
                             int n, int n_experts, int tile_rows, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m}, xstr[1] = {(cuuint64_t)k * 2};
  const cuuint32_t xbox[2] = {WK, WM};
  // w [E, K, N] as {N, K, E}, or transposed [E, N, K] as {K, N, E}
  const cuuint64_t inner = TRANSPOSE_W ? k : n, outer = TRANSPOSE_W ? n : k;
  const cuuint64_t wdims[3] = {inner, outer, (cuuint64_t)n_experts};
  const cuuint64_t wstr[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t wbox[3] = {64, TRANSPOSE_W ? (cuuint32_t)WN : (cuuint32_t)WK, 1};
  if (!encode_bf16(&xmap, x, 2, xdims, xstr, xbox) ||
      !encode_bf16(&wmap, w, 3, wdims, wstr, wbox))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gmm_fwd_wgmma_kernel<TRANSPOSE_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(m / WM, (n + WN - 1) / WN);
  gmm_fwd_wgmma_kernel<TRANSPOSE_W><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      xmap, wmap, te, static_cast<bf16*>(y), k, n, tile_rows, n_experts);
  return cudaGetLastError();
}

cudaError_t launch_dw_wgmma(const void* x, const void* g, const int* start, const int* count,
                            float* dw, int m, int d, int h, int n_experts, int tile_rows,
                            cudaStream_t stream) {
  CUtensorMap xmap, gmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)m}, xstr[1] = {(cuuint64_t)d * 2};
  const cuuint64_t gdims[2] = {(cuuint64_t)h, (cuuint64_t)m}, gstr[1] = {(cuuint64_t)h * 2};
  const cuuint32_t box[2] = {64, WK};
  if (!encode_bf16(&xmap, x, 2, xdims, xstr, box) ||
      !encode_bf16(&gmap, g, 2, gdims, gstr, box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gmm_dw_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  const int n_dt = (d + WM - 1) / WM, n_ht = (h + WN - 1) / WN;
  const dim3 grid(n_dt * n_ht, n_experts);
  gmm_dw_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(xmap, gmap, start, count, dw, d, h,
                                                             tile_rows, n_ht);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], y [M, N], w [E, K, N] (or [E, N, K] with transpose_w): bf16 when
// is_bf16 else fp32. tile_expert [M / tile_rows] int32 on the device, each in
// [0, E). M and tile_rows multiples of 128. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int gmm_fwd(const void* x, const void* w, const void* tile_expert, void* y, int m,
                       int k, int n, int n_experts, int tile_rows, int transpose_w, int is_bf16,
                       void* stream) {
  if (m < BM || k < 1 || n < 1 || n_experts < 1 || tile_rows < BM || tile_rows % BM != 0 ||
      m % tile_rows != 0 || (n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = transpose_w ? launch_fwd<bf16, true>(x, w, te, y, m, k, n, n_experts, tile_rows, st)
                      : launch_fwd<bf16, false>(x, w, te, y, m, k, n, n_experts, tile_rows, st);
  else
    err = transpose_w ? launch_fwd<float, true>(x, w, te, y, m, k, n, n_experts, tile_rows, st)
                      : launch_fwd<float, false>(x, w, te, y, m, k, n, n_experts, tile_rows, st);
  return (int)err;
}

// x [M, D], g [M, H] (bf16 when is_bf16 else fp32), dw [E, D, H] fp32.
// tile_start, tile_count [E] int32 on the device: expert e owns row tiles
// [tile_start[e], tile_start[e] + tile_count[e]). Every element of dw is
// written. Returns the cudaError_t of the launch (0 on success).
extern "C" int gmm_dw(const void* x, const void* g, const void* tile_start,
                      const void* tile_count, void* dw, int d, int h, int n_experts,
                      int tile_rows, int is_bf16, void* stream) {
  if (d < 1 || h < 1 || n_experts < 1 || n_experts > 65535 || tile_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int* start = static_cast<const int*>(tile_start);
  const int* count = static_cast<const int*>(tile_count);
  float* out = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dw<bf16>(x, g, start, count, out, d, h, n_experts, tile_rows, st)
              : launch_dw<float>(x, g, start, count, out, d, h, n_experts, tile_rows, st);
  return (int)err;
}

// The wgmma route's forward: x [M, K], y [M, N], w [E, K, N] (or [E, N, K]
// with transpose_w), all bf16, K and N multiples of 8, bases 16-byte aligned;
// tile_expert as gmm_fwd. Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for anything it does not take.
extern "C" int gmm_fwd_wgmma(const void* x, const void* w, const void* tile_expert, void* y, int m,
                             int k, int n, int n_experts, int tile_rows, int transpose_w,
                             void* stream) {
  if (m < WM || m % WM != 0 || k < 8 || k % 8 != 0 || n < 8 || n % 8 != 0 || n_experts < 1 ||
      tile_rows < WM || tile_rows % WM != 0 || m % tile_rows != 0 || (n + WN - 1) / WN > 65535 ||
      !tma_ok(x) || !tma_ok(w) || !tma_ok(y))
    return (int)cudaErrorInvalidValue;
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      transpose_w ? launch_fwd_wgmma<true>(x, w, te, y, m, k, n, n_experts, tile_rows, st)
                  : launch_fwd_wgmma<false>(x, w, te, y, m, k, n, n_experts, tile_rows, st);
  return (int)err;
}

// The wgmma route's dw: x [M, D], g [M, H] bf16, D and H multiples of 8,
// bases 16-byte aligned, tile_rows a multiple of 64; tile_start, tile_count
// and dw as gmm_dw. Every element of dw is written.
extern "C" int gmm_dw_wgmma(const void* x, const void* g, const void* tile_start,
                            const void* tile_count, void* dw, int m, int d, int h, int n_experts,
                            int tile_rows, void* stream) {
  if (m < 1 || d < 8 || d % 8 != 0 || h < 8 || h % 8 != 0 || n_experts < 1 ||
      n_experts > 65535 || tile_rows < WK || tile_rows % WK != 0 || !tma_ok(x) || !tma_ok(g) ||
      !tma_ok(dw))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_dw_wgmma(
      x, g, static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<float*>(dw), m, d, h, n_experts, tile_rows, static_cast<cudaStream_t>(stream));
  return (int)err;
}
