// Causal linear attention, forward, for Hopper (sm_90a): one chunk walk, two
// kernels.
//
// causal_dot_norm_kernel replaces the TPU kernel
// orion_tpu/ops/pallas/causal_dot.py::_kernel_norm (launched by _cdpn_flat).
// For phi-mapped q, k [BH, T, Dk] and v [BH, T, Dv] (bf16 or fp32,
// contiguous) and an optional fp32 state (S0 [BH, Dk, Dv], z0 [BH, Dk]) it
// writes
//
//     out[t] = q_t . S_t / (q_t . z_t + eps)          (input dtype)
//     S_T = S0 + sum_t k_t (x) v_t,  z_T = z0 + sum_t k_t   (fp32)
//
// with S_t, z_t the states through position t. The division is fused into
// the epilogue. For inference no fp32 numerator or denominator goes to
// device memory; training asks for them (optional fp32 num [BH, T, Dv] and
// den [BH, T] = q_t . z_t, before eps, as the TPU kernel writes them), since
// the backward (causal_dot_bwd.cu) takes them as its residuals. With null
// num and den pointers the launch is the inference one.
//
// causal_dot_raw_kernel replaces the TPU kernel _kernel (launched by
// _cdp_flat), the unnormalized causal dot product of the public op
// causal_dot_product: with an optional fp32 S0 [BH, Dk, Dv] it writes
//
//     out[t] = sum_{s<=t} (q_t . k_s) v_s + q_t . S0   (input dtype)
//     S_T    = S0 + sum_t k_t (x) v_t                   (fp32)
//
// with no z, no denominator and no division. Its backward runs it again as
// the dq pass, on (g, v, k) with S0^T carried in (_cdp_bwd). Both kernels
// are the one body below (walk<T, NORM>), so the numerator recurrence
// cannot drift between them, as the TPU kernels share _tri_mask.
//
// On the TPU the chunk axis is a sequential grid axis and VMEM scratch
// carries S from one grid step to the next. Blocks on an H100 run in no
// order, so here one block owns one (b*h, 64-column tile of Dv) and walks
// the 64-token chunks of the sequence in a loop, with its S tile (Dk x 64
// fp32) and z kept for the whole walk. Per chunk:
//   1. q, k (64 x Dk) and the v tile (64 x 64); rows past T are zeros, so the
//      ragged tail needs no host padding;
//   2. A = q k^T, masked to s <= t by a select and kept in fp32 (as the TPU
//      kernels do);
//   3. num = A v + q S; normalized: den[t] = sum_s A[t, s] + q_t . z and
//      out = num / (den + eps); raw: out = num; written in the input dtype;
//   4. S += k^T v (normalized: z += sum_s k_s).
// Every Dv tile of a (b*h) recomputes A (and den): Dk x 64 extra
// multiply-adds a token, cheap beside the loads.
//
// Bound of the normalized kernel at B 4, H 16, T 1024, D 128, bf16, no
// initial state: the kernel must read q, k, v (50.3 MB) and write out (16.8
// MB) and S (4.2 MB): 71.3 MB, 21.3 us at 3.35 TB/s. Its arithmetic is 6.4
// GFLOP (the full 64 x 64 score block a chunk), 6.5 us at the 989 TFLOP/s
// bf16 tensor-core peak. So the function is bound by bytes; so is the raw
// one (at B 8: 142.6 MB, 43 us, against 12.9 GFLOP, 13 us), and the
// training launch (num and den written too: 210.3 MB, 63 us at B 8).
//
// Each kernel has two variants, chosen by the wrapper before the launch
// (ops/kernels/causal_dot.py, causal_dot_norm_variant and
// causal_dot_raw_variant, under the same conditions):
//
//   wgmma (causal_dot_norm_wgmma_kernel, causal_dot_raw_wgmma_kernel): bf16
//     at Dk 128 with Dv a multiple of 64 and 16-byte-aligned bases, every
//     model's shape and the public op's. The main path's route, below the
//     simt kernels. Both are one walk (wgmma_walk<NORM>), as the simt
//     kernels are walk<T, NORM>: the raw instance reads no z0, computes no
//     den, divides by nothing (out = A v + q S, bf16 from the accumulator)
//     and writes no zf, num or den; it writes S_T only where sf is not null
//     (the op's dq pass throws its state away and asks for none). A and S
//     go to the tensor cores as two bf16 halves in both instances: rounded
//     once, either misses the raw kernel's out limit as well
//     (tests/test_torch_causal_dot_split.py, test_raw_*).
//   simt (causal_dot_norm_kernel, causal_dot_raw_kernel): everything else
//     -- fp32 (the tiny models) and other widths; the op's dq pass where its
//     contracted width (the op's Dv) is not 128.
//
// The wgmma route. A CUDA-core walk at 5 % of the byte bound spent its time
// on shared-memory load issue for the four products; on the tensor cores a
// chunk is about 40 wgmma instructions, and the walk is bound by the loads
// and by the chunk-to-chunk chain (each chunk's q S needs the state the
// chunk before left):
//   - One consumer warpgroup (its 64 rows are the chunk's 64 tokens) and one
//     producer warp. TMA brings each chunk's q and k tiles (3-D [BH, T, 128]
//     tensor maps, zero-filled past T inside a head) and v tile (64 x 64)
//     into a ring of W_STAGES stages ahead of the walk, each stage with a
//     "full" and an "empty" mbarrier.
//   - S lives in the warpgroup's registers for the whole walk (two m64n64
//     accumulators: Dk rows 0-63 and 64-127), from S0. After each update its
//     bf16 halves hi = bf16(S) and lo = bf16(S - hi) are written to shared
//     memory as the MN-major B operand of q S (128-byte swizzled rows, the
//     layout TMA lands), behind a proxy fence and a warpgroup barrier. z
//     lives in shared memory.
//   - A = q k^T is m64n64k16 with both operands K-major. The mask and den's
//     row sums run in registers; q . z (z before the chunk) on the CUDA
//     cores while A is on the tensor cores.
//   - num = A v + q S is four wgmma chains into one fp32 accumulator: A's
//     bf16 halves as the register A operand (the m64n64 accumulator's
//     16-column slice is the A fragment of the k16 slice) against v
//     MN-major, then q against S's two halves. A and S are fp32 in the TPU
//     kernel's products; rounded once to bf16, A misses chip_smoke.py's out
//     limit and S its limit on num, the backward's residual
//     (tests/test_torch_causal_dot_split.py emulates all three on the CPU);
//     with the halves each is carried to about 16 bits.
//   - S += k^T v is m64n64k16 into the S registers with k^T read MN-major
//     from the k tile already in the stage (its Dk halves one box apart) and
//     v MN-major; z adds the chunk's column sums of k.
//   - Epilogue straight from the registers: out (bf16, two values a store),
//     and for training num (fp32) and den (tile 0).
//   - Dv tile and stages: 64 columns (the 128-byte swizzle's row, so S's
//     halves and the v tile read as the same MN-major layout as a TMA box),
//     3 stages of 40 KB; 157,232 bytes of shared memory and 254 registers
//     (0 spilled, nvcc -Xptxas -v on the H100): one block an SM. At
//     generate's B 4, H 16, Dv 128 the grid is 128 blocks on 132 SMs, one
//     wave; at training's B 8, two.
//   - The TMA, mbarrier and wgmma helpers and write_state (S's halves) come
//     from hopper.cuh, shared with causal_dot_bwd.cu. A wait on an
//     mbarrier that has not completed after 4 s traps: a pipeline fault is a
//     launch error, never a hung card.
//
// The simt route: the same walk with S and z in shared memory as fp32.
// Threads load q, k (2 x 64 x 129 fp32), the v tile and the masked scores
// (64 x 65 each) into shared memory (zeros past T) and do every product as
// fp32 FMAs on the CUDA cores (a non-finite masked entry becomes 0, not
// NaN); bf16 products are exact in fp32, so the result matches the fp32
// plain version up to summation order. 132,864 bytes of shared memory, above
// the 48 KB default, so the launcher raises the limit with
// cudaFuncSetAttribute; one block per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 64;          // tokens per chunk of the block's walk
constexpr int DK_MAX = 128;    // largest Dk the kernel takes
constexpr int DVT = 64;        // value columns per block
constexpr int NT = 256;        // threads per block: a 16 x 16 thread grid
constexpr int LDQ = DK_MAX + 1;  // padded row strides against bank conflicts
constexpr int LDV = DVT + 1;
constexpr int LDA = C + 1;
constexpr int SMEM_FLOATS = 2 * C * LDQ + C * LDV + C * LDA + DK_MAX * DVT + DK_MAX + C;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One block's walk. NORM: the normalized kernel (z, den, the division);
// else the raw one, which reads no z0 and writes no zf, num or den.
template <typename T, bool NORM>
__device__ __forceinline__ void walk(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ s0, const float* __restrict__ z0,
    T* __restrict__ out, float* __restrict__ sf, float* __restrict__ zf,
    float* __restrict__ num_out, float* __restrict__ den_out,
    int t_len, int dk, int dv, int n_tiles, float eps, float* smem) {
  float* qs = smem;               // [C][LDQ]
  float* ks = qs + C * LDQ;       // [C][LDQ]
  float* vs = ks + C * LDQ;       // [C][LDV]
  float* as = vs + C * LDV;       // [C][LDA] masked scores
  float* ss = as + C * LDA;       // [DK_MAX][DVT] running S tile
  float* zs = ss + DK_MAX * DVT;  // [DK_MAX] running z
  float* dens = zs + DK_MAX;      // [C] denominators of the chunk

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int j0 = tile * DVT;
  const int dvt = min(DVT, dv - j0);  // live columns of this tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t qk_base = (size_t)bh * t_len * dk;
  const size_t v_base = (size_t)bh * t_len * dv;
  const size_t s_base = (size_t)bh * dk * dv;

  for (int e = tid; e < DK_MAX * DVT; e += NT) {
    const int d = e / DVT, j = e % DVT;
    ss[e] = (s0 != nullptr && d < dk && j < dvt) ? s0[s_base + (size_t)d * dv + j0 + j] : 0.f;
  }
  for (int d = tid; NORM && d < DK_MAX; d += NT) {
    zs[d] = (z0 != nullptr && d < dk) ? z0[(size_t)bh * dk + d] : 0.f;
  }

  for (int c0 = 0; c0 < t_len; c0 += C) {
    const int rows = min(C, t_len - c0);

    // 1. the chunk's q, k rows and v tile, as fp32; zeros past T / Dk / Dv
    for (int e = tid; e < C * DK_MAX; e += NT) {
      const int r = e / DK_MAX, d = e % DK_MAX;
      float qv = 0.f, kv = 0.f;
      if (r < rows && d < dk) {
        const size_t g = qk_base + (size_t)(c0 + r) * dk + d;
        qv = to_f(q[g]);
        kv = to_f(k[g]);
      }
      qs[r * LDQ + d] = qv;
      ks[r * LDQ + d] = kv;
    }
    for (int e = tid; e < C * DVT; e += NT) {
      const int r = e / DVT, j = e % DVT;
      float vv = 0.f;
      if (r < rows && j < dvt) vv = to_f(v[v_base + (size_t)(c0 + r) * dv + j0 + j]);
      vs[r * LDV + j] = vv;
    }
    __syncthreads();

    // 2. masked scores; this thread owns rows ty + 16i and columns tx + 16j
    {
      float acc[4][4] = {};
      for (int d = 0; d < dk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // 3a. den[t] = sum_s A[t, s] + q_t . z: one warp per row, lanes split the sums
    if (NORM) {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < C; r += NT / 32) {
        float acc = 0.f;
        for (int s = lane; s < C; s += 32) acc += as[r * LDA + s];
        for (int d = lane; d < dk; d += 32) acc = fmaf(qs[r * LDQ + d], zs[d], acc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) dens[r] = acc;
      }
    }

    // 3b. num = A v + q S; this thread owns rows ty + 16i and columns tx + 16j
    float num[4][4] = {};
    for (int s = 0; s < C; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * LDA + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = vs[s * LDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) num[i][j] = fmaf(a[i], b[j], num[i][j]);
    }
    for (int d = 0; d < dk; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ss[d * DVT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) num[i][j] = fmaf(a[i], b[j], num[i][j]);
    }
    __syncthreads();  // dens complete; every read of S and z is done

    // 3c. epilogue: the division (normalized), in the input dtype; for
    // training also the fp32 numerator (every tile) and denominator (tile 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, col = tx + 16 * j;
        if (t < rows && col < dvt) {
          const size_t o = v_base + (size_t)(c0 + t) * dv + j0 + col;
          out[o] = from_f<T>(NORM ? num[i][j] / (dens[t] + eps) : num[i][j]);
          if (num_out != nullptr) num_out[o] = num[i][j];
        }
      }
    if (den_out != nullptr && tile == 0 && tid < rows) {
      den_out[(size_t)bh * t_len + c0 + tid] = dens[tid];
    }

    // 4. S += k^T v (rows ty + 16i of S, columns tx + 16j); normalized: z += sum_s k_s
    {
      float acc[8][4] = {};
      for (int s = 0; s < rows; ++s) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ks[s * LDQ + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vs[s * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ss[(ty + 16 * i) * DVT + tx + 16 * j] += acc[i][j];
    }
    if (NORM && tid < dk) {
      float acc = 0.f;
      for (int s = 0; s < rows; ++s) acc += ks[s * LDQ + tid];
      zs[tid] += acc;
    }
    __syncthreads();  // S and z updated before the next chunk reads them
  }

  for (int e = tid; e < dk * DVT; e += NT) {
    const int d = e / DVT, j = e % DVT;
    if (j < dvt) sf[s_base + (size_t)d * dv + j0 + j] = ss[e];
  }
  if (NORM && tile == 0) {
    for (int d = tid; d < dk; d += NT) zf[(size_t)bh * dk + d] = zs[d];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_norm_kernel(
    const T* q, const T* k, const T* v, const float* s0, const float* z0, T* out, float* sf,
    float* zf, float* num_out, float* den_out, int t_len, int dk, int dv, int n_tiles,
    float eps) {
  extern __shared__ float smem[];
  walk<T, true>(q, k, v, s0, z0, out, sf, zf, num_out, den_out, t_len, dk, dv, n_tiles, eps,
                smem);
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_raw_kernel(
    const T* q, const T* k, const T* v, const float* s0, T* out, float* sf, int t_len, int dk,
    int dv, int n_tiles) {
  extern __shared__ float smem[];
  walk<T, false>(q, k, v, s0, nullptr, out, sf, nullptr, nullptr, nullptr, t_len, dk, dv,
                 n_tiles, 0.f, smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* s0,
                   const float* z0, void* out, float* sf, float* zf, float* num,
                   float* den, int bh, int t, int dk, int dv, float eps, bool norm,
                   cudaStream_t stream) {
  const int n_tiles = (dv + DVT - 1) / DVT;
  const long long blocks = (long long)bh * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaError_t err;
  if (norm) {
    err = cudaFuncSetAttribute(causal_dot_norm_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    causal_dot_norm_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
        qt, kt, vt, s0, z0, ot, sf, zf, num, den, t, dk, dv, n_tiles, eps);
  } else {
    err = cudaFuncSetAttribute(causal_dot_raw_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    causal_dot_raw_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
        qt, kt, vt, s0, ot, sf, t, dk, dv, n_tiles);
  }
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, const void* s0, const void* z0, void* out,
        void* sf, void* zf, void* num, void* den, int bh, int t, int dk, int dv, int is_bf16,
        float eps, bool norm, void* stream) {
  if (bh < 1 || t < 1 || dk < 1 || dk > DK_MAX || dv < 1) return (int)cudaErrorInvalidValue;
  const float* s0f = static_cast<const float*>(s0);
  const float* z0f = static_cast<const float*>(z0);
  float* sff = static_cast<float*>(sf);
  float* zff = static_cast<float*>(zf);
  float* numf = static_cast<float*>(num);
  float* denf = static_cast<float*>(den);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, s0f, z0f, out, sff, zff, numf, denf, bh, t,
                                      dk, dv, eps, norm, st)
              : launch<float>(q, k, v, s0f, z0f, out, sff, zff, numf, denf, bh, t, dk, dv,
                              eps, norm, st);
  return (int)err;
}

// ---------------------------------------------------------------------------
// The wgmma route of both kernels: bf16 at Dk 128, Dv a multiple of 64. TMA
// into a ring of shared-memory stages, wgmma from there.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WC = 64;    // tokens a chunk: the rows of the consumer warpgroup
constexpr int WDK = 128;  // the Dk this route takes
constexpr int WDV = 64;   // value columns a block
constexpr int W_STAGES = 3;
// a stage: the chunk's q and k tiles (64 x 128) and v tile (64 x 64)
constexpr int W_STAGE_BYTES = 2 * TILE_BYTES + HALF_BYTES;
constexpr int S_BYTES = WDK * WDV * 2;  // one bf16 half of the state tile, [Dk][64]
constexpr int W_THREADS = 128 + 32;     // one consumer warpgroup, one producer warp
// the stages and the two halves of S at a 1024-byte-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes), then z and the barriers
constexpr int W_SMEM = 1024 + W_STAGES * W_STAGE_BYTES + 2 * S_BYTES + WDK * 4 + 2 * W_STAGES * 8;

// The block's shared memory: the ring's stages (q, k, v), S's bf16 halves
// (MN-major [Dk][64], as the B operand of q S), z, then a "full" and an
// "empty" barrier a stage.
struct NormRing {
  uint32_t base;
  __device__ __forceinline__ uint32_t q(int s) const { return base + s * W_STAGE_BYTES; }
  __device__ __forceinline__ uint32_t k(int s) const { return q(s) + TILE_BYTES; }
  __device__ __forceinline__ uint32_t v(int s) const { return q(s) + 2 * TILE_BYTES; }
  __device__ __forceinline__ uint32_t s_hi() const { return base + W_STAGES * W_STAGE_BYTES; }
  __device__ __forceinline__ uint32_t s_lo() const { return s_hi() + S_BYTES; }
  __device__ __forceinline__ uint32_t z() const { return s_lo() + S_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return z() + WDK * 4 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(W_STAGES + s); }
};

// One block's walk: value columns [j0, j0 + 64) of head bh, the whole
// sequence in chunks of 64. The maps read q, k [BH, T, 128] and v [BH, T, Dv]
// in boxes of 64 rows x 64 columns. NORM: the normalized kernel (z, den, the
// division, and for training num and den); else the raw one, which reads no
// z0, computes no den, divides by nothing (out = A v + q S) and writes no
// zf, num or den, and writes S_T only where sf is not null (the public op's
// dq pass throws it away).
template <bool NORM>
__device__ __forceinline__ void wgmma_walk(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ s0, const float* __restrict__ z0, bf16* __restrict__ out,
    float* __restrict__ sf, float* __restrict__ zf, float* __restrict__ num_out,
    float* __restrict__ den_out, int t_len, int dv, int n_tiles, float eps) {
  extern __shared__ unsigned char w_smem[];  // the simt kernels declare their own float[]
  NormRing r;
  r.base = (smem_u32(w_smem) + 1023) & ~1023u;
  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int j0 = tile * WDV;
  const int n_chunks = (t_len + WC - 1) / WC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(r.full(s), 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(r.empty(s), 1);  // the consumer warpgroup's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // the producer warp: its first lane issues the copies
    if (threadIdx.x == 128) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % W_STAGES;
        if (c >= W_STAGES) mbar_wait(r.empty(s), ((c / W_STAGES) + 1) & 1);
        mbar_expect_tx(r.full(s), W_STAGE_BYTES);
        tma_tile(r.q(s), qmap, r.full(s), c * WC, bh);
        tma_tile(r.k(s), kmap, r.full(s), c * WC, bh);
        tma_3d(r.v(s), vmap, r.full(s), j0, c * WC, bh);
      }
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rw = 16 * warp + lane / 4;  // this thread's rows of a chunk: rw, rw + 8
  unsigned char* s_hi = at<unsigned char>(r.s_hi(), w_smem);
  unsigned char* s_lo = at<unsigned char>(r.s_lo(), w_smem);
  float* zs = at<float>(r.z(), w_smem);
  const size_t s_base = (size_t)bh * WDK * dv + j0;

  // S in registers for the whole walk, from S0: element j of sa (sb) is
  // row rw + 8 ((j / 2) % 2) (plus 64) and column 8 (j / 4) + 2 (lane % 4) + j % 2
  float sa[32], sb[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int m = rw + 8 * ((j / 2) % 2), n = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    sa[j] = s0 != nullptr ? s0[s_base + (size_t)m * dv + n] : 0.f;
    sb[j] = s0 != nullptr ? s0[s_base + (size_t)(m + 64) * dv + n] : 0.f;
  }
  if (NORM) zs[tid] = z0 != nullptr ? z0[(size_t)bh * WDK + tid] : 0.f;
  write_state(sa, sb, s_hi, s_lo);
  fence_async_smem();
  named_barrier(1, 128);

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % W_STAGES, c0 = c * WC;
    mbar_wait(r.full(s), (c / W_STAGES) & 1);
    const uint32_t qs = r.q(s), ks = r.k(s), vs = r.v(s);
    const unsigned char* qt = at<unsigned char>(qs, w_smem);
    const unsigned char* kt = at<unsigned char>(ks, w_smem);

    // A = q k^T: both operands K-major
    float a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = 0.f;
    fence_acc(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WDK / 16; ++kk) wgmma_m64n64k16(a, kmajor(qs, kk), kmajor(ks, kk));
    wgmma_commit();

    // meanwhile the denominator's q . z (z before this chunk) on the CUDA
    // cores: the four lanes of a row take 32 of its 128 d each
    float den[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; NORM && h < 2; ++h) {
      const int t = rw + 8 * h;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d0 = 32 * (lane % 4) + 8 * e;
        const uint4 raw = *reinterpret_cast<const uint4*>(qt + tile_offset(t, d0));
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(x[u]);
          acc = fmaf(f.x, zs[d0 + 2 * u], acc);
          acc = fmaf(f.y, zs[d0 + 2 * u + 1], acc);
        }
      }
      den[h] = acc;
    }
    wgmma_wait<0>();
    fence_acc(a);

    // the causal mask s <= t (element j: row rw + 8 ((j / 2) % 2), column
    // 8 (j / 4) + 2 (lane % 4) + j % 2), den's row sums, A's bf16 halves
    float rs[2] = {0.f, 0.f};
    uint32_t ahi[16], alo[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int h = (j / 2) % 2, t = rw + 8 * h, col = 8 * (j / 4) + 2 * (lane % 4);
      if (col > t) a[j] = 0.f;
      if (col + 1 > t) a[j + 1] = 0.f;
      rs[h] += a[j] + a[j + 1];
      split_pair(a[j], a[j + 1], ahi[j / 2], alo[j / 2]);
    }

    // num = A v + q S: A's halves from registers against v MN-major, then q
    // (K-major) against S's halves (MN-major), into one fp32 accumulator
    float num[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) num[j] = 0.f;
    fence_acc(num);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(num, ahi + 4 * kk, mnmajor(vs, kk));
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(num, alo + 4 * kk, mnmajor(vs, kk));
#pragma unroll
    for (int kk = 0; kk < WDK / 16; ++kk)
      wgmma_m64n64k16<0, 1>(num, kmajor(qs, kk), mnmajor(r.s_hi(), kk));
#pragma unroll
    for (int kk = 0; kk < WDK / 16; ++kk)
      wgmma_m64n64k16<0, 1>(num, kmajor(qs, kk), mnmajor(r.s_lo(), kk));
    wgmma_commit();
#pragma unroll
    for (int h = 0; NORM && h < 2; ++h) den[h] = quad_sum(den[h]) + quad_sum(rs[h]);
    wgmma_wait<0>();
    fence_acc(num);

    // epilogue: out = num / (den + eps) (raw: num); for training also num
    // and den
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = c0 + rw + 8 * h;
      if (t >= t_len) continue;
      const float inv = NORM ? 1.f / (den[h] + eps) : 1.f;
      const size_t o = ((size_t)bh * t_len + t) * dv + j0 + 2 * (lane % 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float n0 = num[4 * jj + 2 * h], n1 = num[4 * jj + 2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + o + 8 * jj) =
            __floats2bfloat162_rn(n0 * inv, n1 * inv);
        if (NORM && num_out != nullptr)
          *reinterpret_cast<float2*>(num_out + o + 8 * jj) = make_float2(n0, n1);
      }
      if (NORM && den_out != nullptr && tile == 0 && lane % 4 == 0)
        den_out[(size_t)bh * t_len + t] = den[h];
    }
    named_barrier(1, 128);  // every read of z and of S's halves in this chunk is done

    // z += the chunk's column sums of k (zeros past T)
    if (NORM) {
      float acc = 0.f;
      for (int t = 0; t < WC; ++t)
        acc += __bfloat162float(*reinterpret_cast<const bf16*>(kt + tile_offset(t, tid)));
      zs[tid] += acc;
    }
    // S += k^T v: k^T read MN-major from the k tile (its Dk halves one box
    // apart), v MN-major
    fence_acc(sa);
    fence_acc(sb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk)
      wgmma_m64n64k16<1, 1>(sa, mnmajor(ks, kk), mnmajor(vs, kk));
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk)
      wgmma_m64n64k16<1, 1>(sb, mnmajor(ks + HALF_BYTES, kk), mnmajor(vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sa);
    fence_acc(sb);
    write_state(sa, sb, s_hi, s_lo);
    fence_async_smem();
    named_barrier(1, 128);  // S's halves and z complete; the stage's reads done
    if (tid == 0) mbar_arrive(r.empty(s));
  }

  // the final state, fp32 from the registers; z from tile 0
#pragma unroll
  for (int j = 0; (NORM || sf != nullptr) && j < 32; j += 2) {
    const int m = rw + 8 * ((j / 2) % 2), n = 8 * (j / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(sf + s_base + (size_t)m * dv + n) = make_float2(sa[j], sa[j + 1]);
    *reinterpret_cast<float2*>(sf + s_base + (size_t)(m + 64) * dv + n) =
        make_float2(sb[j], sb[j + 1]);
  }
  if (NORM && tile == 0) zf[(size_t)bh * WDK + tid] = zs[tid];
}

__global__ void __launch_bounds__(W_THREADS, 1) causal_dot_norm_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ s0,
    const float* __restrict__ z0, bf16* __restrict__ out, float* __restrict__ sf,
    float* __restrict__ zf, float* __restrict__ num_out, float* __restrict__ den_out,
    int t_len, int dv, int n_tiles, float eps) {
  wgmma_walk<true>(&qmap, &kmap, &vmap, s0, z0, out, sf, zf, num_out, den_out, t_len, dv,
                   n_tiles, eps);
}

__global__ void __launch_bounds__(W_THREADS, 1) causal_dot_raw_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ s0,
    bf16* __restrict__ out, float* __restrict__ sf, int t_len, int dv, int n_tiles) {
  wgmma_walk<false>(&qmap, &kmap, &vmap, s0, nullptr, out, sf, nullptr, nullptr, nullptr, t_len,
                    dv, n_tiles, 0.f);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* s0,
                         const float* z0, void* out, float* sf, float* zf, float* num, float* den,
                         int bh, int t, int dv, float eps, bool norm, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int n_tiles = dv / WDV;
  const long long blocks = (long long)bh * n_tiles;
  if (blocks > 0x7fffffffLL || !tma_ok(q) || !tma_ok(k) || !tma_ok(v) ||
      !encode_heads(&maps[0], q, WDK, t, bh) || !encode_heads(&maps[1], k, WDK, t, bh) ||
      !encode_heads(&maps[2], v, dv, t, bh))
    return cudaErrorInvalidValue;
  const void* kernel = norm ? reinterpret_cast<const void*>(causal_dot_norm_wgmma_kernel)
                            : reinterpret_cast<const void*>(causal_dot_raw_wgmma_kernel);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  if (norm)
    causal_dot_norm_wgmma_kernel<<<(unsigned)blocks, W_THREADS, W_SMEM, stream>>>(
        maps[0], maps[1], maps[2], s0, z0, static_cast<bf16*>(out), sf, zf, num, den, t, dv,
        n_tiles, eps);
  else
    causal_dot_raw_wgmma_kernel<<<(unsigned)blocks, W_THREADS, W_SMEM, stream>>>(
        maps[0], maps[1], maps[2], s0, static_cast<bf16*>(out), sf, t, dv, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: bf16 when is_bf16 else fp32. s0, z0: nullptr for a zero
// initial state. num [BH, T, Dv], den [BH, T] (fp32): nullptr unless the
// caller trains. Returns the cudaError_t of the launch (0 on success).
extern "C" int causal_dot_norm_fwd(const void* q, const void* k, const void* v,
                                   const void* s0, const void* z0, void* out, void* sf,
                                   void* zf, void* num, void* den, int bh, int t, int dk,
                                   int dv, int is_bf16, float eps, void* stream) {
  return run(q, k, v, s0, z0, out, sf, zf, num, den, bh, t, dk, dv, is_bf16, eps, true,
             stream);
}

// The raw kernel. q, k [BH, T, Dk], v, out [BH, T, Dv]: bf16 when is_bf16
// else fp32. s0 [BH, Dk, Dv] fp32, nullptr for a zero initial state; sf
// [BH, Dk, Dv] fp32 out. Returns the cudaError_t of the launch (0 on success).
extern "C" int causal_dot_fwd(const void* q, const void* k, const void* v, const void* s0,
                              void* out, void* sf, int bh, int t, int dk, int dv, int is_bf16,
                              void* stream) {
  return run(q, k, v, s0, nullptr, out, sf, nullptr, nullptr, nullptr, bh, t, dk, dv, is_bf16,
             0.f, false, stream);
}

// The wgmma route of causal_dot_norm_fwd: q, k [BH, T, 128], v, out [BH, T,
// Dv] bf16 with Dv a multiple of 64, bases 16-byte aligned; s0, z0, sf, zf,
// num, den as causal_dot_norm_fwd. Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for anything it does not take.
extern "C" int causal_dot_norm_fwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* s0, const void* z0, void* out, void* sf,
                                         void* zf, void* num, void* den, int bh, int t, int dv,
                                         float eps, void* stream) {
  if (bh < 1 || t < 1 || dv < WDV || dv % WDV != 0 || !tma_ok(out))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(q, k, v, static_cast<const float*>(s0), static_cast<const float*>(z0),
                           out, static_cast<float*>(sf), static_cast<float*>(zf),
                           static_cast<float*>(num), static_cast<float*>(den), bh, t, dv, eps,
                           true, static_cast<cudaStream_t>(stream));
}

// The wgmma route of causal_dot_fwd: q, k [BH, T, 128], v, out [BH, T, Dv]
// bf16 with Dv a multiple of 64, bases 16-byte aligned; s0 [BH, 128, Dv]
// fp32 or nullptr; sf [BH, 128, Dv] fp32, or nullptr to skip S_T. Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue for
// anything it does not take.
extern "C" int causal_dot_fwd_wgmma(const void* q, const void* k, const void* v, const void* s0,
                                    void* out, void* sf, int bh, int t, int dv, void* stream) {
  if (bh < 1 || t < 1 || dv < WDV || dv % WDV != 0 || !tma_ok(out))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(q, k, v, static_cast<const float*>(s0), nullptr, out,
                           static_cast<float*>(sf), nullptr, nullptr, nullptr, bh, t, dv, 0.f,
                           false, static_cast<cudaStream_t>(stream));
}
