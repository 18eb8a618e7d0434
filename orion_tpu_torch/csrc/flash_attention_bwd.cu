// Flash attention, backward, for Hopper (sm_90a): one pass for dq and one for
// dk / dv, as the TPU backward, each in two variants.
//
// Replaces, in orion_tpu/ops/pallas/flash_attention.py (both launched by
// _flash_bwd_flat):
//   - flash_dq_wgmma_kernel, flash_dq_kernel   <- _dq_kernel, the dq pass;
//   - flash_dkv_wgmma_kernel, flash_dkv_kernel <- _dkv_kernel, the dk / dv pass.
//
// With q [BH, Tq, D], k, v [BH, Tk, D], the output's cotangent g [BH, Tq, D]
// (cast to the input dtype), the forward's lse and delta = rowsum(g . out)
// (minus the lse's cotangent, when it has one), both fp32 [BH, Tq]:
//
//   P[t, s]  = exp(scale q_t . k_s - lse_t) where row t sees key s, else 0
//   dS[t, s] = P[t, s] (g_t . v_s - delta_t) scale
//   dq = dS k,   dk = dS^T q,   dv = P^T g                    (input dtype)
//
// with the mask of the forward (flash_attention.cu): s < Tk, t + q_offset >=
// s + shift when causal, t + q_offset - s < window when banded, every loop
// bound and tile predicate moved with shift and q_offset. A row that sees no
// key has lse -1e30 from the forward: its P is 0 wherever the mask is taken,
// and the exponent is never taken unmasked for it (no tile holding it lies
// wholly inside the band), so dq, dk and dv stay finite. P is recomputed from lse, so no T x T
// matrix is kept between the passes. On the TPU each pass carries its fp32
// accumulator in VMEM scratch across a sequential grid axis; here a loop
// inside the block replaces that axis, the accumulators stay in registers,
// and each block owns its output rows, so the sums need no atomics and run
// in a fixed order.
//
// Two variants, chosen by the wrapper before the launch
// (ops/kernels/flash_attention.py, flash_bwd_variant). Each wgmma kernel has
// two instances, chosen by its launcher, as the forward's: OFFSET false
// compiles the plain mask and band exactly as before the offsets existed
// (the dk/dv kernel's consumers sit at the registers setmaxnreg grants, and
// the offsets' terms made them spill), OFFSET true the moved ones:
//
//   wgmma (flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel): bf16 at D 128 with
//     16-byte-aligned bases, every model's training shape. TMA into a ring of
//     shared-memory stages, Hopper's wgmma from there. The main path's route.
//   simt (flash_dq_kernel, flash_dkv_kernel): everything else -- fp32 (the
//     tiny models) and other head widths (D 32, 64). fp32 FMAs on the CUDA
//     cores from shared-memory tiles that the threads fill synchronously.
//
// Bound at the hybrid_1b3 training shape (B 8, H 16, T 2048, D 128, w 1024,
// bf16): 201.4 M (q, k) pairs.
//   dq:    q k^T, g v^T and dS k, 6 D = 768 operations a pair: 154.7 GFLOP,
//          0.156 ms at 989 TFLOP/s; it reads q, k, v, g (268.4 MB) and lse,
//          delta (2.1 MB) and writes dq (67.1 MB): 337.6 MB, 0.101 ms.
//   dk/dv: q k^T, g v^T, P^T g and dS^T q, 8 D = 1024 a pair: 206.2 GFLOP,
//          0.209 ms; reads the same 270.5 MB, writes dk, dv (134.2 MB):
//          404.8 MB, 0.121 ms.
// Both are bound by operations, and only the tensor cores reach that bound,
// through wgmma. The wgmma route:
//
//   - dq: one block per (b*h, 128 q rows), two consumer warpgroups of 64 rows
//     each and one producer warp. q and g of the block's rows load once by
//     TMA; the (k, v) tiles of the band, 64 keys each, stream through a ring
//     of STAGES stages, from max(0, q0 - w + 1) / 64 to (q0 + 127) / 64.
//     Per tile and warpgroup: S = q k^T and dP = g v^T as m64n64k16 products
//     from shared memory (both operands K-major), P and dS in the
//     accumulators' registers, then dq += dS k as m64n128k16 with dS as the
//     A operand from registers and k read MN-major (the transpose bit on B)
//     from the same tile that fed q k^T.
//   - dk, dv: one block per (b*h, 128 keys), the same roles, but the
//     producer is a whole warpgroup (its first warp works) that hands
//     registers to the consumers with setmaxnreg: a consumer thread holds
//     128 accumulators beside S^T, dP^T and their halves. k and v load
//     once; the (q, g) tiles of the band stream through the ring, with their
//     64 lse and delta values, which the producer warp's lanes write into
//     the stage (the stage completes on their 32 arrivals and the tiles'
//     bytes), from k0 / 64 to (k0 + 127 + w - 1) / 64. Per tile: S^T = k q^T
//     and dP^T = v g^T, then dv += P^T g and dk += dS^T q, g and q read
//     MN-major.
//   - P and dS are fp32 in the TPU kernels' second products (ds @ k in f32).
//     A wgmma takes bf16 operands, and P or dS rounded once to bf16 misses
//     the limits by 4-10x, so each second product runs twice, on
//     hi = bf16(x) and lo = bf16(x - hi), into the same fp32 accumulator:
//     x is then carried to about 16 bits. TF32 is no way out: it takes only
//     K-major operands, and these three read theirs MN-major.
//   - The accumulator of S (m64n64) converts into the A fragment of
//     m64n128k16 in registers: the 16-column slice kk of the accumulator is
//     exactly the fragment of the k16 slice kk, no trip through shared
//     memory.
//   - Masks only where needed: a tile wholly inside the band and inside Tq
//     and Tk skips the mask; a warpgroup whose 64 x 64 tile lies wholly
//     outside the band skips the tile's products (it still waits on the
//     stage and releases it).
//   - Tails: the tensor maps are 3-D [BH, T, D], so a box that runs past T
//     is zero-filled inside its own head; the mask sets P = 0 past Tk, and
//     rows past Tq (dq) or Tk (dk, dv) are not stored.
//   - Operands land 128-byte swizzled, in boxes of 64 rows x 64 d (one
//     128-byte row each); a 64-row tile is two boxes, 16 KB. The descriptors
//     read them K-major (a 16-deep slice 32 bytes along the row, the next
//     64 d one box on) or MN-major (a 16-deep slice 16 rows, 2048 bytes, on;
//     the next 64 columns one box on).
//   - Epilogue straight from the registers, rounded once to bf16, two values
//     a store.
//   - A wait on an mbarrier that has not completed after 4 s of the card's
//     clock traps: a pipeline fault is a launch error, never a hung card.
//   The TMA, mbarrier and wgmma helpers, the operand layouts of a 64 x 128
//   tile and split_pair come from hopper.cuh, shared with gmm.cu,
//   flash_attention.cu and causal_dot_norm.cu.
//
// The simt route: dq: one block per (b*h, 64-row q tile); per k tile S, P,
// dP = g v^T and dS in registers, dS through shared memory into dq += dS k.
// dk, dv: one block per (b*h, 64-row k tile); per q tile the transposed S^T
// = k q^T and dP^T = v g^T, P^T and dS^T through shared memory into dv +=
// P^T g and dk += dS^T q. All products accumulate in fp32 on the CUDA
// cores. 256 threads as a 16 x 16 grid: a thread owns rows ty + 16i (i < 4)
// of its block's tile, tile columns tx + 16j (j < 4) and output columns tx +
// 16j (j < 8). Shared memory: dq keeps q, g, k, v (4 x 64 x 129 fp32) and dS
// (64 x 65): 148,736 bytes; dk/dv keeps k, v, q, g, P^T and dS^T, lse and
// delta: 165,888 bytes. One block per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int D_MAX = 128;      // largest head width the kernels take
constexpr int NT = 256;         // threads per block: a 16 x 16 thread grid
constexpr int LD = D_MAX + 1;   // padded row stride against bank conflicts
constexpr int LDP = 64 + 1;
constexpr int DQ_SMEM_FLOATS = 4 * 64 * LD + 64 * LDP;
constexpr int DKV_SMEM_FLOATS = 4 * 64 * LD + 2 * 64 * LDP + 2 * BQ;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a [t, d] matrix into dst (row stride LD) as fp32,
// zeros past t and d
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int t, int d) {
  for (int e = threadIdx.x; e < 64 * D_MAX; e += NT) {
    const int r = e / D_MAX, c = e % D_MAX;
    float x = 0.f;
    if (r0 + r < t && c < d) x = to_f(src[(size_t)(r0 + r) * d + c]);
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ bool sees(int row, int col, int t_q, int t_k, int causal,
                                     int window, int shift, int q_offset) {
  return row < t_q && col < t_k && (!causal || row + q_offset >= col + shift) &&
         (window <= 0 || row + q_offset - col < window);
}

// a / b rounded down, for a of either sign (b > 0)
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// s = x y^T and u = w z^T over d: rows ty + 16i of x, w; rows tx + 16j of y, z
__device__ __forceinline__ void two_products(const float* x, const float* y, const float* w,
                                             const float* z, int d, int ty, int tx,
                                             float (&s)[4][4], float (&u)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = u[i][j] = 0.f;
  for (int e = 0; e < d; ++e) {
    float a[4], b[4], c[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = x[(ty + 16 * i) * LD + e];
      c[i] = w[(ty + 16 * i) * LD + e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = y[(tx + 16 * j) * LD + e];
      f[j] = z[(tx + 16 * j) * LD + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        u[i][j] = fmaf(c[i], f[j], u[i][j]);
      }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][8], int r0, int t,
                                           int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dst[(size_t)row * d + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int t_q, int t_k, int d, int n_qt, float scale, int causal,
    int window, int shift, int q_offset) {
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* gs = qs + BQ * LD;     // [BQ][LD]
  float* ks = gs + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* dss = vs + BK * LD;    // [BQ][LDP] dS of the tile

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* kb = k + (size_t)bh * t_k * d;
  const T* vb = v + (size_t)bh * t_k * d;

  load_tile(qs, q + (size_t)bh * t_q * d, q0, t_q, d);
  load_tile(gs, g + (size_t)bh * t_q * d, q0, t_q, d);
  float lr[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < t_q ? lse[(size_t)bh * t_q + row] : 0.f;
    dl[i] = row < t_q ? delta[(size_t)bh * t_q + row] : 0.f;
  }

  int lo = 0, hi = (t_k - 1) / BK;  // none when lo > hi
  if (window > 0) lo = max(0, q0 + q_offset - window + 1) / BK;
  if (causal) hi = min(hi, floor_div(q0 + q_offset + BQ - 1 - shift, BK));

  float acc[4][8] = {};
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of ks, vs, dss are done
    load_tile(ks, kb, k0, t_k, d);
    load_tile(vs, vb, k0, t_k, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products(qs, ks, gs, vs, d, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        const float p =
            sees(row, col, t_q, t_k, causal, window, shift, q_offset)
                ? expf(s[i][j] * scale - lr[i]) : 0.f;
        const float ds = p * (dp[i][j] - dl[i]) * scale;
        dss[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    __syncthreads();  // dS complete

    for (int c = 0; c < BK; ++c) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  store_rows(dq + (size_t)bh * t_q * d, acc, q0, t_q, d, ty, tx);
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k, int d, int n_kt, float scale,
    int causal, int window, int shift, int q_offset) {
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* qs = vs + BK * LD;     // [BQ][LD]
  float* gs = qs + BQ * LD;     // [BQ][LD]
  float* pts = gs + BQ * LD;    // [BK][LDP] P^T of the tile
  float* dsts = pts + BK * LDP; // [BK][LDP] dS^T of the tile
  float* lses = dsts + BK * LDP;  // [BQ]
  float* dls = lses + BQ;         // [BQ]

  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * t_q * d;
  const T* gb = g + (size_t)bh * t_q * d;

  load_tile(ks, k + (size_t)bh * t_k * d, k0, t_k, d);
  load_tile(vs, v + (size_t)bh * t_k * d, k0, t_k, d);

  // the band of query tiles that see this k tile: from the first whose rows
  // reach k0 + shift - q_offset (none when lo > hi)
  int lo = causal ? max(0, k0 + shift - q_offset) / BQ : 0;
  int hi = (t_q - 1) / BQ;
  if (window > 0) hi = min(hi, floor_div(k0 + BK - 1 + window - 1 - q_offset, BQ));

  float acc_dk[4][8] = {}, acc_dv[4][8] = {};
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads of qs, gs, pts, dsts are done
    load_tile(qs, qb, q0, t_q, d);
    load_tile(gs, gb, q0, t_q, d);
    if (tid < BQ) {
      const int row = q0 + tid;
      lses[tid] = row < t_q ? lse[(size_t)bh * t_q + row] : 0.f;
      dls[tid] = row < t_q ? delta[(size_t)bh * t_q + row] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v g^T: rows are this block's keys, columns queries
    float st[4][4], dpt[4][4];
    two_products(ks, qs, vs, gs, d, ty, tx, st, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + ty + 16 * i, row = q0 + tx + 16 * j;
        const float p = sees(row, col, t_q, t_k, causal, window, shift, q_offset)
                            ? expf(st[i][j] * scale - lses[tx + 16 * j]) : 0.f;
        pts[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        dsts[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dpt[i][j] - dls[tx + 16 * j]) * scale;
      }
    __syncthreads();  // P^T and dS^T complete

    for (int r = 0; r < BQ; ++r) {
      float a[4], c[4], b[8], f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = pts[(ty + 16 * i) * LDP + r];
        c[i] = dsts[(ty + 16 * i) * LDP + r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = gs[r * LD + tx + 16 * j];
        f[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_dv[i][j] = fmaf(a[i], b[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(c[i], f[j], acc_dk[i][j]);
        }
    }
  }
  store_rows(dk + (size_t)bh * t_k * d, acc_dk, k0, t_k, d, ty, tx);
  store_rows(dv + (size_t)bh * t_k * d, acc_dv, k0, t_k, d, ty, tx);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, void* dq, int bh, int t_q,
                      int t_k, int d, float scale, int causal, int window, int shift,
                      int q_offset, cudaStream_t stream) {
  const int n_qt = (t_q + BQ - 1) / BQ;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = DQ_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dq), t_q, t_k, d, n_qt, scale,
      causal, window, shift, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int t_q, int t_k, int d, float scale, int causal, int window,
                       int shift, int q_offset, cudaStream_t stream) {
  const int n_kt = (t_k + BK - 1) / BK;
  const long long blocks = (long long)bh * n_kt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = DKV_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t_q,
      t_k, d, n_kt, scale, causal, window, shift, q_offset);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wgmma route: bf16 at D 128. TMA into a ring of shared-memory stages,
// wgmma from there.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WD = 128;                    // the head width this route takes
constexpr int WT = 64;                     // rows of a streamed tile, and of a warpgroup
constexpr int WROWS = 128;                 // a block's own rows: two warpgroups of 64
constexpr int STAGES = 3;  // 2, 3 and 4 time alike at hybrid_1b3's training shape
// a stage: two tiles, then 64 lse (times log2 e) and 64 delta values (dk/dv),
// padded to keep the next stage 1024-byte aligned
constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;
constexpr int RESIDENT_BYTES = 4 * TILE_BYTES;  // the block's own rows of two tensors
constexpr int WG_THREADS = 2 * 128 + 32;        // two consumer warpgroups, one producer warp
// dk/dv holds 128 accumulators a thread beside S^T, dP^T and their bf16
// halves, more than the 168 registers ptxas grants 288 threads (it counts
// whole warpgroups: 56 bytes spilled). So its producer is a whole warpgroup
// that gives registers back (setmaxnreg) and its consumers take them: at 232
// a consumer thread still spills, at 240 not.
constexpr int DKV_THREADS = 3 * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
// the resident tiles and the stages at a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then the barriers
constexpr int WG_SMEM = 1024 + RESIDENT_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
constexpr float LOG2E = 1.4426950408889634f;

// Whether query t sees key s: the plain mask (the instance with OFFSET false
// compiles exactly this, as before the rings' offsets existed).
__device__ __forceinline__ bool visible(int t, int s, int t_q, int t_k, int causal, int window) {
  return t < t_q && s < t_k && (!causal || s <= t) && (window <= 0 || t - s < window);
}

// For the 64 x 64 tile of queries [t0, t0 + 64) and keys [s0, s0 + 64):
// whether no pair is visible (its products are skipped), and whether every
// pair is (its mask is skipped).
__device__ __forceinline__ bool tile_hidden(int t0, int s0, int t_q, int t_k, int causal,
                                            int window) {
  return t0 >= t_q || s0 >= t_k || (causal && t0 + 63 < s0) ||
         (window > 0 && t0 - (s0 + 63) >= window);
}
__device__ __forceinline__ bool tile_inside(int t0, int s0, int t_q, int t_k, int causal,
                                            int window) {
  return t0 + 64 <= t_q && s0 + 64 <= t_k && (!causal || s0 + 63 <= t0) &&
         (window <= 0 || t0 + 63 - s0 < window);
}

// The same with the mask moved (the instance with OFFSET true, the rings'
// blocks): query t at absolute position t + q_offset, causal as rows >= cols
// + shift (the forward's). A halo block's tile with q_offset >= Tk lies wholly below
// the causal diagonal: only the window bounds it.
__device__ __forceinline__ bool visible_at(int t, int s, int t_q, int t_k, int causal,
                                           int window, int shift, int q_offset) {
  return t < t_q && s < t_k && (!causal || s + shift <= t + q_offset) &&
         (window <= 0 || t + q_offset - s < window);
}
__device__ __forceinline__ bool tile_hidden_at(int t0, int s0, int t_q, int t_k, int causal,
                                               int window, int shift, int q_offset) {
  return t0 >= t_q || s0 >= t_k || (causal && t0 + q_offset + 63 < s0 + shift) ||
         (window > 0 && t0 + q_offset - (s0 + 63) >= window);
}
__device__ __forceinline__ bool tile_inside_at(int t0, int s0, int t_q, int t_k, int causal,
                                               int window, int shift, int q_offset) {
  return t0 + 64 <= t_q && s0 + 64 <= t_k && (!causal || s0 + 63 + shift <= t0 + q_offset) &&
         (window <= 0 || t0 + q_offset + 63 - s0 < window);
}

// The block's shared memory: the resident tiles (index 0..3), the ring's
// stages (tiles a and b, then the row statistics), then a "full" and an
// "empty" barrier a stage and one for the resident tiles.
struct Ring {
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t resident(int i) const { return base + i * TILE_BYTES; }
  __device__ __forceinline__ uint32_t a(int s) const {
    return base + RESIDENT_BYTES + s * STAGE_BYTES;
  }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + TILE_BYTES; }
  __device__ __forceinline__ uint32_t stats(int s) const { return a(s) + 2 * TILE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
  __device__ __forceinline__ uint32_t res() const { return bars + 8 * 2 * STAGES; }
};

// full_count: the arrivals that, with the stage's bytes, complete a stage.
__device__ __forceinline__ Ring make_ring(unsigned char* smem, uint32_t full_count) {
  Ring r;
  r.base = (smem_u32(smem) + 1023) & ~1023u;
  r.bars = r.base + RESIDENT_BYTES + STAGES * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), full_count);
      mbar_init(r.empty(s), 2);  // one arrive from each consumer warpgroup
    }
    mbar_init(r.res(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The stage of streamed tile i, once the consumers have released its previous
// contents (the producer's side).
__device__ __forceinline__ int free_stage(const Ring& r, int i) {
  const int s = i % STAGES;
  if (i >= STAGES) mbar_wait(r.empty(s), ((i / STAGES) + 1) & 1);
  return s;
}

// acc[64] (m64n128 layout) of a warpgroup into rows [r0, r0 + 64) of out
// [t, 128], rows < t, rounded once to bf16, two values a store.
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[64], bf16* __restrict__ out,
                                                int r0, int t) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = r0 + 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (row < t)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * WD + col) =
          __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
    if (row + 8 < t)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * WD + col) =
          __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// dq of one block: q rows [q0, q0 + 128) of head bh; warpgroup wg owns rows
// q0 + 64 wg. The maps read [BH, T, 128] in boxes of 64 rows x 64 d.
template <bool OFFSET>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int t_q, int t_k, int n_qt, float scale, int causal, int window, int shift_arg,
    int q_offset_arg) {
  // OFFSET false: shift and q_offset are 0 at compile time (the plain mask)
  const int shift = OFFSET ? shift_arg : 0, q_offset = OFFSET ? q_offset_arg : 0;
  extern __shared__ unsigned char wg_smem[];  // the simt kernels declare theirs float[]
  const Ring r = make_ring(wg_smem, 1);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * WROWS;
  // the k tiles of the band of rows [q0, q0 + 128); none when lo > hi
  int lo = 0, hi = (t_k - 1) / WT;
  if (OFFSET) {
    if (window > 0) lo = max(0, q0 + q_offset - window + 1) / WT;
    if (causal) hi = min(hi, floor_div(q0 + q_offset + WROWS - 1 - shift, WT));
  } else {
    if (window > 0) lo = max(0, q0 - window + 1) / WT;
    if (causal) hi = min(hi, (q0 + WROWS - 1) / WT);
  }
  const int n = hi - lo + 1;
  if (threadIdx.x >= 256) {  // the producer warp: its first lane issues the copies
    if (threadIdx.x == 256) {
      mbar_expect_tx(r.res(), RESIDENT_BYTES);
      for (int w = 0; w < 2; ++w) {
        tma_tile(r.resident(w), &qmap, r.res(), q0 + WT * w, bh);
        tma_tile(r.resident(2 + w), &gmap, r.res(), q0 + WT * w, bh);
      }
      for (int i = 0; i < n; ++i) {
        const int s = free_stage(r, i);
        mbar_expect_tx(r.full(s), 2 * TILE_BYTES);
        tma_tile(r.a(s), &kmap, r.full(s), (lo + i) * WT, bh);
        tma_tile(r.b(s), &vmap, r.full(s), (lo + i) * WT, bh);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = q0 + WT * wg;
  const int row = r0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h;
    lse2[h] = t < t_q ? lse[(size_t)bh * t_q + t] * LOG2E : 0.f;
    dl[h] = t < t_q ? delta[(size_t)bh * t_q + t] : 0.f;
  }
  const uint32_t qs = r.resident(wg), gs = r.resident(2 + wg);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(r.res(), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(r.full(s), (i / STAGES) & 1);
    const int k0 = (lo + i) * WT;
    if (!(OFFSET ? tile_hidden_at(r0, k0, t_q, t_k, causal, window, shift, q_offset)
                 : tile_hidden(r0, k0, t_q, t_k, causal, window))) {
      const uint32_t ks = r.a(s), vs = r.b(s);
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_m64n64k16(sc, kmajor(qs, kk), kmajor(ks, kk));
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_m64n64k16(dp, kmajor(gs, kk), kmajor(vs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const bool edge =
          !(OFFSET ? tile_inside_at(r0, k0, t_q, t_k, causal, window, shift, q_offset)
                   : tile_inside(r0, k0, t_q, t_k, causal, window));
      // element j: row + 8 ((j / 2) % 2), key k0 + 8 (j / 4) + 2 (lane % 4) + j % 2
      uint32_t dhi[16], dlo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2, key = k0 + 8 * (j / 4) + 2 * (lane % 4);
        float p0 = exp2f(fmaf(sc[j], sl2, -lse2[h]));
        float p1 = exp2f(fmaf(sc[j + 1], sl2, -lse2[h]));
        if (edge) {
          if (OFFSET) {
            if (!visible_at(row + 8 * h, key, t_q, t_k, causal, window, shift, q_offset))
              p0 = 0.f;
            if (!visible_at(row + 8 * h, key + 1, t_q, t_k, causal, window, shift, q_offset))
              p1 = 0.f;
          } else {
            if (!visible(row + 8 * h, key, t_q, t_k, causal, window)) p0 = 0.f;
            if (!visible(row + 8 * h, key + 1, t_q, t_k, causal, window)) p1 = 0.f;
          }
        }
        split_pair(p0 * (dp[j] - dl[h]) * scale, p1 * (dp[j + 1] - dl[h]) * scale, dhi[j / 2],
                   dlo[j / 2]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk) wgmma_m64n128k16<1>(acc, dhi + 4 * kk, mnmajor(ks, kk));
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk) wgmma_m64n128k16<1>(acc, dlo + 4 * kk, mnmajor(ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(r.empty(s));
  }
  store_rows_bf16(acc, dq + (size_t)bh * t_q * WD, r0, t_q);
}

// dk, dv of one block: keys [k0, k0 + 128) of head bh; warpgroup wg owns keys
// k0 + 64 wg. The producer warp's lanes write each streamed q tile's lse
// (times log2 e) and delta into its stage, so a stage completes on the
// warp's 32 arrivals and the tiles' bytes.
template <bool OFFSET>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int t_q, int t_k, int n_kt, float scale, int causal, int window,
    int shift_arg, int q_offset_arg) {
  // OFFSET false: shift and q_offset are 0 at compile time (the plain mask)
  const int shift = OFFSET ? shift_arg : 0, q_offset = OFFSET ? q_offset_arg : 0;
  extern __shared__ unsigned char wg_smem[];  // the simt kernels declare theirs float[]
  const Ring r = make_ring(wg_smem, 32);
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * WROWS;
  // the q tiles of the band of keys [k0, k0 + 128); none when lo > hi
  int lo, hi = (t_q - 1) / WT;
  if (OFFSET) {  // from the first q tile whose rows reach k0 + shift - q_offset
    lo = causal ? max(0, k0 + shift - q_offset) / WT : 0;
    if (window > 0) hi = min(hi, floor_div(k0 + WROWS - 1 + window - 1 - q_offset, WT));
  } else {
    lo = causal ? k0 / WT : 0;
    if (window > 0) hi = min(hi, (k0 + WROWS - 1 + window - 1) / WT);
  }
  const int n = hi - lo + 1;
  if (threadIdx.x >= 256) {  // the producer warpgroup: its first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x - 256;
    if (lane == 0) {
      mbar_expect_tx(r.res(), RESIDENT_BYTES);
      for (int w = 0; w < 2; ++w) {
        tma_tile(r.resident(w), &kmap, r.res(), k0 + WT * w, bh);
        tma_tile(r.resident(2 + w), &vmap, r.res(), k0 + WT * w, bh);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = free_stage(r, i);
      const int q_row = (lo + i) * WT;
      float* st = at<float>(r.stats(s), wg_smem);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = q_row + lane + 32 * h;
        st[lane + 32 * h] = t < t_q ? lse[(size_t)bh * t_q + t] * LOG2E : 0.f;
        st[64 + lane + 32 * h] = t < t_q ? delta[(size_t)bh * t_q + t] : 0.f;
      }
      if (lane == 0) {  // its arrival, with the tiles' bytes
        mbar_expect_tx(r.full(s), 2 * TILE_BYTES);
        tma_tile(r.a(s), &qmap, r.full(s), q_row, bh);
        tma_tile(r.b(s), &gmap, r.full(s), q_row, bh);
      } else {
        mbar_arrive(r.full(s));
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int c0 = k0 + WT * wg;
  const int key = c0 + 16 * warp + lane / 4;  // this thread's keys: key, key + 8
  const float sl2 = scale * LOG2E;
  const uint32_t ks = r.resident(wg), vs = r.resident(2 + wg);
  float acc_dk[64], acc_dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  mbar_wait(r.res(), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(r.full(s), (i / STAGES) & 1);
    const int q_row = (lo + i) * WT;
    if (!(OFFSET ? tile_hidden_at(q_row, c0, t_q, t_k, causal, window, shift, q_offset)
                 : tile_hidden(q_row, c0, t_q, t_k, causal, window))) {
      const uint32_t qs = r.a(s), gs = r.b(s);
      const float* st = at<float>(r.stats(s), wg_smem);
      float sc[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_m64n64k16(sc, kmajor(ks, kk), kmajor(qs, kk));
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_m64n64k16(dp, kmajor(vs, kk), kmajor(gs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const bool edge =
          !(OFFSET ? tile_inside_at(q_row, c0, t_q, t_k, causal, window, shift, q_offset)
                   : tile_inside(q_row, c0, t_q, t_k, causal, window));
      // element j: key + 8 ((j / 2) % 2), query q_row + 8 (j / 4) + 2 (lane % 4) + j % 2
      uint32_t phi[16], plo[16], dhi[16], dlo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2, col = 8 * (j / 4) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(st + col);
        const float2 dl = *reinterpret_cast<const float2*>(st + 64 + col);
        float p0 = exp2f(fmaf(sc[j], sl2, -l2.x));
        float p1 = exp2f(fmaf(sc[j + 1], sl2, -l2.y));
        if (edge) {
          if (OFFSET) {
            const int kh = key + 8 * h;
            if (!visible_at(q_row + col, kh, t_q, t_k, causal, window, shift, q_offset))
              p0 = 0.f;
            if (!visible_at(q_row + col + 1, kh, t_q, t_k, causal, window, shift, q_offset))
              p1 = 0.f;
          } else {
            if (!visible(q_row + col, key + 8 * h, t_q, t_k, causal, window)) p0 = 0.f;
            if (!visible(q_row + col + 1, key + 8 * h, t_q, t_k, causal, window)) p1 = 0.f;
          }
        }
        split_pair(p0, p1, phi[j / 2], plo[j / 2]);
        split_pair(p0 * (dp[j] - dl.x) * scale, p1 * (dp[j + 1] - dl.y) * scale, dhi[j / 2],
                   dlo[j / 2]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk)
        wgmma_m64n128k16<1>(acc_dv, phi + 4 * kk, mnmajor(gs, kk));
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk)
        wgmma_m64n128k16<1>(acc_dv, plo + 4 * kk, mnmajor(gs, kk));
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk)
        wgmma_m64n128k16<1>(acc_dk, dhi + 4 * kk, mnmajor(qs, kk));
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk)
        wgmma_m64n128k16<1>(acc_dk, dlo + 4 * kk, mnmajor(qs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc_dk);
      fence_acc(acc_dv);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(r.empty(s));
  }
  store_rows_bf16(acc_dk, dk + (size_t)bh * t_k * WD, c0, t_k);
  store_rows_bf16(acc_dv, dv + (size_t)bh * t_k * WD, c0, t_k);
}

// The four tensor maps of a wgmma launch, or false.
bool encode_all(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                const void* g, int bh, int t_q, int t_k) {
  return tma_ok(q) && tma_ok(k) && tma_ok(v) && tma_ok(g) &&
         encode_heads(&maps[0], q, WD, t_q, bh) && encode_heads(&maps[1], k, WD, t_k, bh) &&
         encode_heads(&maps[2], v, WD, t_k, bh) && encode_heads(&maps[3], g, WD, t_q, bh);
}

cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* g,
                            const float* lse, const float* delta, void* dq, int bh, int t_q,
                            int t_k, float scale, int causal, int window, int shift,
                            int q_offset, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int n_qt = (t_q + WROWS - 1) / WROWS;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7fffffffLL || !encode_all(maps, q, k, v, g, bh, t_q, t_k))
    return cudaErrorInvalidValue;
  // the instance with the mask moved only for the rings' blocks
  const auto kernel =
      shift || q_offset ? flash_dq_wgmma_kernel<true> : flash_dq_wgmma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, WG_THREADS, WG_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(dq), t_q, t_k, n_qt,
      scale, causal, window, shift, q_offset);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* g,
                             const float* lse, const float* delta, void* dk, void* dv, int bh,
                             int t_q, int t_k, float scale, int causal, int window,
                             int shift, int q_offset, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int n_kt = (t_k + WROWS - 1) / WROWS;
  const long long blocks = (long long)bh * n_kt;
  if (blocks > 0x7fffffffLL || !encode_all(maps, q, k, v, g, bh, t_q, t_k))
    return cudaErrorInvalidValue;
  // the instance with the mask moved only for the rings' blocks
  const auto kernel =
      shift || q_offset ? flash_dkv_wgmma_kernel<true> : flash_dkv_wgmma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, DKV_THREADS, WG_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t_q, t_k, n_kt, scale, causal, window, shift, q_offset);
  return cudaGetLastError();
}

}  // namespace

// q, g, dq [BH, Tq, D], k, v, dk, dv [BH, Tk, D]: bf16 when is_bf16 else
// fp32. lse, delta [BH, Tq] fp32. window <= 0: no window. shift, q_offset >=
// 0 move the mask, as the forward's. Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dq, int bh,
                                  int t_q, int t_k, int d, int is_bf16, float scale,
                                  int causal, int window, int shift, int q_offset,
                                  void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX || shift < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, g, lsef, deltaf, dq, bh, t_q, t_k, d,
                                         scale, causal, window, shift, q_offset, st)
              : launch_dq<float>(q, k, v, g, lsef, deltaf, dq, bh, t_q, t_k, d, scale,
                                 causal, window, shift, q_offset, st);
  return (int)err;
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int t_q, int t_k, int d, int is_bf16, float scale,
                                   int causal, int window, int shift, int q_offset,
                                   void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX || shift < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, g, lsef, deltaf, dk, dv, bh, t_q, t_k, d,
                                          scale, causal, window, shift, q_offset, st)
              : launch_dkv<float>(q, k, v, g, lsef, deltaf, dk, dv, bh, t_q, t_k, d, scale,
                                  causal, window, shift, q_offset, st);
  return (int)err;
}

// The wgmma route: q, g, dq [BH, Tq, 128], k, v, dk, dv [BH, Tk, 128], all
// bf16, bases 16-byte aligned; lse, delta as above. Each returns the
// cudaError_t of its launch (0 on success); cudaErrorInvalidValue for
// anything it does not take.
extern "C" int flash_attention_dq_wgmma(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dq, int bh, int t_q, int t_k, float scale,
                                        int causal, int window, int shift, int q_offset,
                                        void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || shift < 0 || q_offset < 0 || !tma_ok(dq))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dq_wgmma(q, k, v, g, static_cast<const float*>(lse),
                              static_cast<const float*>(delta), dq, bh, t_q, t_k, scale, causal,
                              window, shift, q_offset, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_dkv_wgmma(const void* q, const void* k, const void* v,
                                         const void* g, const void* lse, const void* delta,
                                         void* dk, void* dv, int bh, int t_q, int t_k,
                                         float scale, int causal, int window, int shift,
                                         int q_offset, void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || shift < 0 || q_offset < 0 || !tma_ok(dk) || !tma_ok(dv))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dkv_wgmma(q, k, v, g, static_cast<const float*>(lse),
                               static_cast<const float*>(delta), dk, dv, bh, t_q, t_k, scale,
                               causal, window, shift, q_offset, static_cast<cudaStream_t>(stream));
}
