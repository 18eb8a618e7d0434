// Grouped expert matmul (gmm) for Hopper (sm_90a): the dropless mixture of
// experts' expert products, forward and weight gradient.
//
// Replaces two TPU kernels of orion_tpu/ops/pallas/gmm.py:
//
//   gmm_fwd_kernel <- _fwd_kernel (launched by _gmm_call). Rows of x [M, K]
//     lie in tile-aligned expert segments: row tile i (tile_rows rows) belongs
//     to expert te[i]. It writes
//         y[r] = x[r] @ W[te[r / tile_rows]]                 (x's dtype)
//     with W[e] = w[e] ([K, N], w [E, K, N]) or, with transpose_w, w[e]^T
//     (w [E, N, K]): the backward's dx = dy @ w[e]^T reads the stack in place
//     instead of the 90 MB copy swapaxes(w, 1, 2) the TPU path makes.
//   gmm_dw_kernel <- _dw_kernel (launched by _dw_call):
//         dw[e] = sum over expert e's row tiles of x_tile^T @ g_tile
//     x [M, D], g [M, H] -> dw [E, D, H] fp32; an expert without tiles gets 0.
//
// Design. Both are one block-level GEMM: a block owns a 128 x 128 output tile
// and walks the reduction axis in steps of 32, staging both operand tiles in
// shared memory (zeros past every edge, so any K, N, D, H is taken) and
// accumulating in fp32. bf16 operands go through the tensor cores
// (nvcuda::wmma 16 x 16 x 16 bf16 fragments, fp32 accumulators; 8 warps, each
// a 64 x 32 slab of the tile); fp32 operands, which only the small models
// use, through fp32 FMAs on the CUDA cores (a thread owns 8 x 8 outputs).
// The accumulators go through shared memory once at the end and are written
// with one rounding to the output dtype (the TPU kernel's
// preferred_element_type=float32, then astype).
//   - forward: the grid is (row tile, column tile); a block reads its expert
//     from the tile table on the device (the TPU kernel's scalar prefetch), so
//     no tile counts ever reach the host. tile_rows must be a multiple of 128,
//     so a block never straddles two experts.
//   - dw: the TPU kernel revisits one output block over consecutive grid steps
//     and zeroes it on an expert's first tile. Blocks here run in no order, so
//     a block owns one (expert, 128-row d tile, 128-column h tile) output and
//     walks that expert's row tiles itself, from tile_start[e] for
//     tile_count[e] tiles (both computed on the device from the table): no
//     atomics, a fixed summation order, and an expert with no tile writes
//     zeros from its untouched accumulators.
//
// Bound. At moe_1b3_4e's training shape (8192 routed rows, tile-aligned to
// M = 8704; d 2048, h 5504; 4 experts) one call is 2 M K N = 196.2 GFLOP,
// 0.198 ms at the 989 TFLOP/s bf16 tensor-core peak, against 222 MB read and
// written by the forward (0.066 ms at 3.35 TB/s) and 312 MB by dw: bound by
// operations. This first kernel is synchronous (load, sync, multiply, sync)
// on mma.sync-class wmma, so it reaches a fraction of that peak; wgmma, TMA
// and a pipelined producer warp are the route to it (ROADMAP.md queue B).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;
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
