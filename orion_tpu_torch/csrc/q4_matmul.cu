// Int4 dequant-matmul for Hopper (sm_90a): decode's dense products against
// nibble-packed int4 weights, in two variants.
//
// Replaces the TPU kernel orion_tpu/quant.py::_q4_matmul_kernel (launched by
// q4_matmul). Both variants write
//     y[b, j] = (sum_i x[b, i] * w[i, j]) * s[j]          (x's dtype)
// for x [B, d] (B <= 64), the packed weight p [d/2, out] int8 (packed row k
// holds w[2k, j] in its low nibble and w[2k + 1, j] in its high one, both
// signed, -8..7) and s [out] fp32: fp32 products and sums, the scale applied
// once, one rounding to the output dtype.
//
// Bound. Decode's products are GEMVs at B 4: each packed byte is read once
// and feeds 2 B products, so the weight bytes bound the call (lm_1b3's gate /
// up / down: 5.64 MB, 1.7 us at 3.35 TB/s; wq..wo 2.1 MB, 0.63 us). At those
// sizes the launch, the memory latency and how many bytes are in flight set
// the time, and an int -> float conversion a nibble costs as much as the
// bytes.
//
// The wrapper (ops/kernels/q4_matmul.py, q4_matmul_variant) chooses before
// the launch:
//
//   mma (q4_matmul_mma_kernel): bf16 x with d a multiple of 8, out a multiple
//     of 16, 16-byte-aligned bases: every decode shape of the bf16 models.
//   simt (q4_matmul_kernel): everything else -- fp32 x (the tiny models),
//     other widths, unaligned bases.
//
// The mma route.
//   - A cluster of CL blocks (1, 2, 4 or 8) owns a strip of 64 output
//     channels; its blocks split the strip's packed rows, in boxes of 64
//     rows, into CL contiguous ranges. CL doubles while the grid has fewer
//     than two blocks an SM and each block keeps two boxes or more: wq..wo
//     (out 2048, 1024 packed rows) 32 strips x 8, gate/up (5504, 1024) 86 x
//     4, down (2048, 2752) 32 x 8.
//   - One producer warp streams the block's boxes of p (a 2-D uint8 tensor
//     map [d/2, out], boxes of 64 rows x 64 channels, zeros past either edge)
//     by TMA into a ring of up to 8 stages of 4 KB, each with a "full" and an
//     "empty" mbarrier. Its barriers lie at offsets that need no kernel
//     parameter, so its first copies leave before anything else: at decode
//     shapes every box of a block is in flight at once. The map depends on
//     p's pointer and shape only: the wrapper encodes it once for a weight
//     (q4_plan) and passes it at each call.
//   - Eight consumer warps stage the block's rows of x in shared memory (a
//     bf16 pair a word, 16-byte loads all issued before the first store),
//     each warp takes one of a box's eight k16 slices, and every product
//     runs on the tensor cores: mma.sync m16n8k16, the weights as A (a row
//     is a channel), x as B (a column is a row of x; rows past B read as
//     0), fp32 accumulators. A packed byte is one channel's k pair (2k, 2k +
//     1): exactly one bf16x2 register of the A fragment. A lane reads 8
//     neighbouring channels of packed rows r and r + 4 as two 8-byte words
//     and forms its four m16 tiles' fragments from them, channels 8g + 2mt
//     (fragment row g) and 8g + 2mt + 1 (row g + 8) of tile mt.
//   - The unpack is bit operations, no conversion: prmt puts byte c of the
//     word and of the word >> 4 into bytes 0 and 2, lop3 keeps bits 0-3 and
//     16-19 and xors in bf16x2 (136, 136): the xor turns each signed nibble
//     v into v + 8 in the mantissa of 128, so each half reads 136 + v, and
//     one bf16x2 fma subtracts 136. Exact: bf16 x int4 products are exact in
//     fp32, so only the order of the fp32 sums differs from the plain
//     version.
//   - The warps' partial sums [B][64] meet in the block's shared memory and
//     are added in warp order; each block sends every sum by st.async to the
//     block of the cluster that owns it (a block owns 1/CL of the strip's
//     outputs), into that block's inbox slot of its rank, completing bytes on
//     the owner's inbox mbarrier (set up before a relaxed cluster arrive; the
//     senders wait on the cluster barrier once, before their first send).
//     Each owner waits for its inbox, adds the slots in rank order
//     (deterministic, no atomics, no second launch), multiplies by s and
//     rounds once. No block touches another's shared memory after its inbox
//     is full, so none waits for the others to leave.
//   - Rows of x past 8 take more m16n8 products (NTILES n-tiles of 8); at
//     large B x d, x is staged in chunks of up to 4096 words.
//   - A wait on an mbarrier that has not completed after 4 s traps
//     (hopper.cuh): a pipeline fault is a launch error, never a hung card.
//   - Programmatic dependent launch: every block lets the next launch on
//     the stream start at once (griddepcontrol.launch_dependents). A launch
//     made with `early` set may itself start before the kernel ahead of it
//     has ended: its producer streams p in at once, its consumers read s,
//     then wait (griddepcontrol.wait) for that kernel before they read x,
//     and no thread writes y before the wait. The wrapper sets `early` only
//     for a weight it checked at an earlier call and that has not changed
//     since, so p and s are never the output of the kernel ahead.
//   - On the H100 the kernel is held by latency, not by bytes or
//     arithmetic (chip_smoke.py's timings move little with the bytes).
//     `profile_port.py --q4-probe` stamps a copy of the kernel with the
//     card's timer: at lm_1b3's decode shapes a block's first box of p
//     arrives 2-3 us after the first block starts, the products and the
//     cluster's exchange take 1-3 us more, and the launch before it costs
//     about 1 us between kernels; the unpack is a small share.

// The simt route. A block owns a strip of 32 output channels and every row of x. Its
// 256 threads split the packed rows 32 ways (8 warps x 4 lane-rows, k-slice
// ks = 4 warp + lane / 8); within a slice, a lane reads 32-bit words: four
// neighbouring channels' bytes of one packed row, so a warp reads four 32-byte
// row segments per load. A thread issues all 16 of its words of a chunk at
// once, before the chunk's x is staged: decode finds the weights in HBM, and
// the loads in flight, not the arithmetic, set the time. The nibbles are unpacked in 32-bit registers by
// arithmetic shifts (the nibble shifted to bits 28..31, then >> 28 extends
// its sign). x's rows are staged in shared memory as fp32 (16-byte loads, a
// thread's all issued before its first store), 1024 inputs (512 packed rows)
// at a time, NR rows at a time (NR = 1, 2, 4 or 8 by B; more rows loop over
// groups of 8, reading p again, from L2). Each thread keeps
// NR x 4 fp32 accumulators; at the end the 32 slices' partial sums meet in
// shared memory and are added in slice order (a fixed order: no atomics),
// multiplied by s and rounded once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads per block: 8 warps
constexpr int COLS = 32;    // output channels per block: 8 lanes x 4 bytes
constexpr int KS = 32;      // k-slices per block: 8 warps x 4 lane-rows
constexpr int KC = 512;     // packed rows staged per chunk (1024 inputs of x)
constexpr int MAXR = 8;     // rows of x per pass
constexpr int SMEM_FLOATS = MAXR * 2 * KC;  // 32 KB: the x chunk, then the partial sums
static_assert(KS * MAXR * COLS <= SMEM_FLOATS, "partial sums exceed the staging buffer");

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// 8 consecutive elements of x as fp32, by 16-byte loads (src 16-byte aligned).
__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const bf16* h = reinterpret_cast<const bf16*>(&w);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __bfloat162float(h[c]);
}
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Stage one chunk of x into sm[r * 2 KC + i] as fp32: rows 0..nr-1 of xc
// (row stride d), inputs 0..len-1; zeros elsewhere. Each thread owns groups
// of 8 inputs and issues all its loads before its first store, so a chunk
// costs one or two memory latencies, not one for every element.
template <typename T, int NR>
__device__ __forceinline__ void stage_x(const T* __restrict__ xc, float* __restrict__ sm, int nr,
                                        int d, int len, bool vec8) {
  constexpr int GROUPS = NR * 2 * KC / 8;
  constexpr int PER = (GROUPS + NT - 1) / NT;
  float v[PER][8];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = (j * NT + threadIdx.x) * 8, r = e / (2 * KC), i = e % (2 * KC);
    const T* src = xc + (size_t)r * d + i;
    if (vec8 && r < nr && i + 8 <= len) {
      load8(src, v[j]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[j][c] = (r < nr && i + c < len) ? to_f(src[c]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = (j * NT + threadIdx.x) * 8;
    if (e < NR * 2 * KC) {
#pragma unroll
      for (int c = 0; c < 8; ++c) sm[e + c] = v[j][c];
    }
  }
}

// The 4 bytes of channels col..col+3 of one packed row as a word (byte c in
// bits 8c..8c+7); channels past ``left`` read as 0 (both nibbles 0).
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ src, int left, int vec) {
  if (vec && left >= 4) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < left) w |= (uint32_t)(uint8_t)src[c] << (8 * c);
  return w;
}

template <typename T, int NR>
__global__ void __launch_bounds__(NT) q4_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ p, const float* __restrict__ s,
    T* __restrict__ y, int b, int d, int out, int vec) {
  __shared__ float sm[SMEM_FLOATS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = warp * 4 + lane / 8;                      // this thread's k-slice
  const int col = blockIdx.x * COLS + 4 * (lane % 8);      // its first channel
  const int kp = d / 2;
  // whole 16-byte loads of x: every row and chunk start 16-byte aligned
  const bool vec8 = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  for (int r0 = 0; r0 < b; r0 += NR) {
    const int nr = min(NR, b - r0);
    float acc[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int kb = 0; kb < kp; kb += KC) {
      const int kn = min(KC, kp - kb);
      // this slice's KC / KS packed rows of the chunk, every load issued at
      // once and before x's staging, so their latencies overlap; a word past
      // kn is 0 and meets x's staged zeros
      uint32_t words[KC / KS];
#pragma unroll
      for (int u = 0; u < KC / KS; ++u) {
        const int k = ks + u * KS;
        words[u] = (col < out && k < kn)
                       ? load_word(p + (size_t)(kb + k) * out + col, out - col, vec) : 0u;
      }
      __syncthreads();  // the previous chunk's (or pass's) reads of sm are done
      stage_x<T, NR>(x + (size_t)r0 * d + 2 * kb, sm, nr, d, 2 * kn, vec8);
      __syncthreads();
      if (col < out) {
#pragma unroll
        for (int u = 0; u < KC / KS; ++u) {
          const int k = ks + u * KS;
          const uint32_t w = words[u];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float lo = (float)((int)(w << (28 - 8 * c)) >> 28);
            const float hi = (float)((int)(w << (24 - 8 * c)) >> 28);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const float xe = sm[r * 2 * KC + 2 * k], xo = sm[r * 2 * KC + 2 * k + 1];
              acc[r][c] = fmaf(xo, hi, fmaf(xe, lo, acc[r][c]));
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the x chunk
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sm[(ks * NR + r) * COLS + 4 * (lane % 8) + c] = acc[r][c];
    __syncthreads();
    if (threadIdx.x < NR * COLS) {
      const int r = threadIdx.x / COLS, c = threadIdx.x % COLS;
      const int oc = blockIdx.x * COLS + c;
      float sum = 0.f;
      for (int k = 0; k < KS; ++k) sum += sm[(k * NR + r) * COLS + c];
      if (r < nr && oc < out) y[(size_t)(r0 + r) * out + oc] = from_f<T>(sum * s[oc]);
    }
  }
}

template <typename T, int NR>
cudaError_t launch_rows(const void* x, const void* p, const float* s, void* y, int b, int d,
                        int out, int vec, cudaStream_t stream) {
  const dim3 grid((out + COLS - 1) / COLS);
  q4_matmul_kernel<T, NR><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(p), s, static_cast<T*>(y), b, d, out,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* p, const float* s, void* y, int b, int d, int out,
                   int vec, cudaStream_t stream) {
  if (b <= 1) return launch_rows<T, 1>(x, p, s, y, b, d, out, vec, stream);
  if (b <= 2) return launch_rows<T, 2>(x, p, s, y, b, d, out, vec, stream);
  if (b <= 4) return launch_rows<T, 4>(x, p, s, y, b, d, out, vec, stream);
  return launch_rows<T, 8>(x, p, s, y, b, d, out, vec, stream);
}

// ---------------------------------------------------------------------------
// The mma route: bf16 x with d a multiple of 8, out a multiple of 16,
// 16-byte-aligned bases. TMA into an mbarrier ring, mma.sync from there, the
// cluster's partial sums through distributed shared memory.
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int M_SW = 64;                       // output channels a strip: a box's bytes a row
constexpr int M_BR = 64;                       // packed rows a box: eight k16 slices
constexpr int M_BOX = M_SW * M_BR;             // bytes a box, one stage of the ring
constexpr int M_STAGES = 8;                    // most stages of the ring
constexpr int M_WARPS = 8;                     // consumer warps: a k16 slice of a box each
constexpr int M_THREADS = 32 * (M_WARPS + 1);  // and one producer warp
constexpr int M_XWORDS = 4096;                 // words of x (bf16 pairs) staged at once
constexpr int M_MAX_CL = 8;                    // most blocks a cluster (the portable limit)
constexpr int M_SMEM_MAX = 200 * 1024;         // the dynamic shared memory a launch may ask
constexpr uint32_t M_NIBBLES = 0x000F000Fu;    // a nibble's bits in each bf16 half
constexpr uint32_t M_MAGIC = 0x43084308u;      // bf16x2 (136, 136)
constexpr uint32_t M_ONE = 0x3F803F80u;        // bf16x2 (1, 1)
constexpr uint32_t M_OFFSET = 0xC308C308u;     // bf16x2 (-136, -136)

// Byte C of w -- one channel's packed k pair -- as the bf16x2 (low nibble,
// high nibble), each -8..7, exactly; hi = w >> 4. prmt puts byte C of w and
// byte C of hi into bytes 0 and 2 (the low nibble in bits 0-3, the high one
// in bits 16-19); lop3 keeps those bits and xors in M_MAGIC, which flips
// each nibble's sign bit (v + 8) under the exponent and high mantissa bit of
// 136; the fma subtracts 136.
template <int C>
__device__ __forceinline__ uint32_t unpack_pair(uint32_t w, uint32_t hi) {
  constexpr uint32_t SEL = C | (C << 4) | ((4 + C) << 8) | ((4 + C) << 12);
  uint32_t t, r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(t) : "r"(w), "r"(hi), "r"(SEL));
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(t), "r"(M_NIBBLES), "r"(M_MAGIC));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(t) : "r"(r), "r"(M_ONE), "r"(M_OFFSET));
  return t;
}

// The A fragment of one m16 tile: channels C / 2 (row g) and C / 2 + 1 (row
// g + 8) of a lane's word pair, at packed rows r (w0: k columns 2t, 2t + 1)
// and r + 4 (w4: k columns 2t + 8, 2t + 9).
template <int C>
__device__ __forceinline__ void fragment(uint32_t (&a)[4], uint32_t w0, uint32_t w4) {
  const uint32_t h0 = w0 >> 4, h4 = w4 >> 4;
  a[0] = unpack_pair<C>(w0, h0);
  a[1] = unpack_pair<C + 1>(w0, h0);
  a[2] = unpack_pair<C>(w4, h4);
  a[3] = unpack_pair<C + 1>(w4, h4);
}

// d[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}
// The cluster barrier in two halves: every thread of the cluster's blocks
// arrives once; a thread that waits (acquire) returns when all have
// arrived. The arrive is relaxed: what it publishes, the inbox barrier's
// initialization, fence.mbarrier_init.release.cluster has released (a
// release arrive would wait here for the block's copies in flight).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// The shared::cluster address of shared address addr in the cluster's block
// `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
// v into the fp32 at shared::cluster address `remote`, completing 4 bytes of
// the transaction on the mbarrier at shared::cluster address `bar` of the
// same block.
__device__ __forceinline__ void st_async(uint32_t remote, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   remote),
               "f"(v), "r"(bar)
               : "memory");
}

// Programmatic dependent launch. A launch whose `early` flag is set may
// start while the kernel before it on the stream is still running, once
// every block of that kernel has let it (griddep_launch), or has exited.
// griddep_wait returns when the kernel before has completed and its writes
// are visible; without the early start it returns at once.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct MmaArgs {
  const bf16* x;   // [b, d]
  const float* s;  // [out]
  bf16* y;         // [b, out]
  int b, d, kp, out;
  int boxes;   // boxes of M_BR packed rows: ceil(kp / M_BR)
  int stages;  // stages of the ring
  int xk;      // packed rows of x staged at once: a multiple of M_BR
};

// Shared memory (from a 128-byte-aligned base): a "full" and an "empty"
// barrier for each of M_STAGES stages and the inbox's barrier (at offsets
// that need no kernel parameter: the producer sets them up and issues its
// first copies before anything else), the ring's stages, x's staged rows
// (b rows of xk + 4 words: the 4 spread a warp's reads of 8 rows over the
// banks), the warps' partial sums [M_WARPS][b][M_SW], the inbox of the
// cluster's partial sums [CL][b M_SW / CL], then the strip's scales.
constexpr int M_BAR_BYTES = 256;  // the barriers, padded to the ring's alignment
static_assert((2 * M_STAGES + 1) * 8 <= M_BAR_BYTES, "the barriers overflow their room");
__host__ __device__ __forceinline__ int mma_x_offset(int stages) {
  return M_BAR_BYTES + stages * M_BOX;
}
__host__ __device__ __forceinline__ int mma_red_offset(int stages, int b, int xk) {
  return mma_x_offset(stages) + b * (xk + 4) * 4;
}
__host__ __device__ __forceinline__ int mma_inbox_offset(int stages, int b, int xk) {
  return mma_red_offset(stages, b, xk) + M_WARPS * b * M_SW * 4;
}
__host__ __device__ __forceinline__ int mma_scale_offset(int stages, int b, int xk) {
  return mma_inbox_offset(stages, b, xk) + b * M_SW * 4;
}
__host__ __device__ __forceinline__ int mma_smem_bytes(int stages, int b, int xk) {
  return 128 + mma_scale_offset(stages, b, xk) + M_SW * 4;
}

// Rows [kg, kg + len) (global packed rows) of x's b rows into xs as bf16
// pairs, zeros past kp: groups of four words (16 bytes; d % 8 == 0, kg and
// len multiples of 4), every load of a thread issued before its first
// store. b len <= M_XWORDS.
__device__ __forceinline__ void stage_words(const MmaArgs& a, uint32_t* xs, int kg, int len, int tid) {
  constexpr int PER = M_XWORDS / 4 / (32 * M_WARPS);
  const int groups = len / 4, total = a.b * groups;
  uint4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * 32 * M_WARPS;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (e < total) {
      const int n = e / groups, kw = kg + 4 * (e % groups);
      if (kw < a.kp) v[j] = *reinterpret_cast<const uint4*>(a.x + (size_t)n * a.d + 2 * kw);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * 32 * M_WARPS;
    if (e < total)
      *reinterpret_cast<uint4*>(xs + (e / groups) * (a.xk + 4) + 4 * (e % groups)) = v[j];
  }
}

// One block: channels [c0, c0 + 64) of the strip blockIdx.x / CL, packed
// rows of boxes [box0, box0 + nb) (its rank's share); NTILES n-tiles of 8
// rows of x.
template <int NTILES>
__global__ void __launch_bounds__(M_THREADS, 1) q4_matmul_mma_kernel(
    const __grid_constant__ CUtensorMap pmap, const MmaArgs a) {
  extern __shared__ unsigned char m_smem[];
  const uint32_t base = (smem_u32(m_smem) + 127) & ~127u;
  unsigned char* sm = m_smem + (base - smem_u32(m_smem));
  uint32_t* xs = reinterpret_cast<uint32_t*>(sm + mma_x_offset(a.stages));
  float* red = reinterpret_cast<float*>(sm + mma_red_offset(a.stages, a.b, a.xk));
  float* inbox = reinterpret_cast<float*>(sm + mma_inbox_offset(a.stages, a.b, a.xk));
  float* scale = reinterpret_cast<float*>(sm + mma_scale_offset(a.stages, a.b, a.xk));
  // stage s: its "full" barrier bars + 8 s, its "empty" one empty + 8 s, its box ring + s M_BOX
  const uint32_t bars = base, empty = base + 8 * M_STAGES, inbox_bar = base + 16 * M_STAGES;
  const uint32_t ring = base + M_BAR_BYTES;
  const int rank = (int)cluster_rank(), cl = (int)cluster_blocks();
  const int c0 = (int)(blockIdx.x / cl) * M_SW;
  const int box0 = rank * a.boxes / cl, nb = (rank + 1) * a.boxes / cl - box0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = nb * M_BR;  // the block's packed rows (zeros past kp)
  const int outs = a.b * M_SW, share = outs / cl;  // the strip's outputs, and each block's

  // the next launch may start now: it reads no output of this one before
  // its griddep_wait
  griddep_launch();
  // the producer's first lane sets up the ring and fills it at once: the
  // weights, which no kernel before writes (the wrapper launches a weight
  // that changed without the early start), so they stream in while the
  // kernel before this one ends. The consumers read the strip's scales (a
  // weight too), wait for that kernel, then stage x's first chunk.
  if (warp == M_WARPS && lane == 0) {
#pragma unroll
    for (int s = 0; s < M_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);         // full: the producer's arrive and the box's bytes
      mbar_init(empty + 8 * s, M_WARPS);  // empty: each consumer warp's arrive
    }
    mbar_init(inbox_bar, 1);  // the inbox: the arrive below, and the cluster's share bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < nb && i < a.stages; ++i) {
      mbar_expect_tx(bars + 8 * i, M_BOX);
      tma_2d(ring + i * M_BOX, &pmap, bars + 8 * i, c0, (box0 + i) * M_BR);
    }
    mbar_expect_tx(inbox_bar, share * cl * 4);
  } else if (warp < M_WARPS) {
    const float sv = tid < M_SW && c0 + tid < a.out ? a.s[c0 + tid] : 0.f;
    griddep_wait();  // x may be the kernel before's output
    stage_words(a, xs, box0 * M_BR, min(a.xk, rows), tid);
    if (tid < M_SW) scale[tid] = sv;
  }
  __syncthreads();
  // every inbox barrier is set up: the cluster's blocks may send once all arrive
  cluster_arrive();

  if (warp == M_WARPS) {  // the producer warp: its first lane refills the ring
    if (lane == 0) {
      for (int i = a.stages; i < nb; ++i) {
        const int s = i % a.stages;
        mbar_wait(empty + 8 * s, ((i / a.stages) + 1) & 1);
        mbar_expect_tx(bars + 8 * s, M_BOX);
        tma_2d(ring + s * M_BOX, &pmap, bars + 8 * s, c0, (box0 + i) * M_BR);
      }
    }
    griddep_wait();  // y below: written only after the kernel before has completed
  } else {
    const int g = lane / 4, t = lane % 4;
    float acc[4][NTILES][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    int xb = 0;  // the first of the block's packed rows staged in xs
    for (int i = 0; i < nb; ++i) {
      if (i * M_BR - xb >= a.xk) {  // the next chunk of x
        named_barrier(1, 32 * M_WARPS);
        xb += a.xk;
        stage_words(a, xs, box0 * M_BR + xb, min(a.xk, rows - xb), tid);
        named_barrier(1, 32 * M_WARPS);
      }
      const int s = i % a.stages;
      mbar_wait(bars + 8 * s, (i / a.stages) & 1);
      // this warp's k16 slice of the box: packed rows r and r + 4
      const unsigned char* tile = sm + M_BAR_BYTES + s * M_BOX;
      const int r = 8 * warp + t;
      const uint2 w0 = *reinterpret_cast<const uint2*>(tile + r * M_SW + 8 * g);
      const uint2 w4 = *reinterpret_cast<const uint2*>(tile + (r + 4) * M_SW + 8 * g);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage is free again
      const int kx = i * M_BR - xb + r;
      uint32_t bx[NTILES][2];
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const int n = 8 * nt + g;
        bx[nt][0] = n < a.b ? xs[n * (a.xk + 4) + kx] : 0u;
        bx[nt][1] = n < a.b ? xs[n * (a.xk + 4) + kx + 4] : 0u;
      }
      uint32_t af[4][4];
      fragment<0>(af[0], w0.x, w4.x);
      fragment<2>(af[1], w0.x, w4.x);
      fragment<0>(af[2], w0.y, w4.y);
      fragment<2>(af[3], w0.y, w4.y);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) mma_16816(acc[mt][nt], af[mt], bx[nt][0], bx[nt][1]);
    }
    // the warp's partial sums: acc[mt][nt] holds channels 8g + 2mt (elements
    // 0, 1) and 8g + 2mt + 1 (2, 3) of rows 8nt + 2t (0, 2) and 8nt + 2t + 1
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const int ch = 8 * g + 2 * mt, n = 8 * nt + 2 * t;
        if (n < a.b)
          *reinterpret_cast<float2*>(red + (warp * a.b + n) * M_SW + ch) =
              make_float2(acc[mt][nt][0], acc[mt][nt][2]);
        if (n + 1 < a.b)
          *reinterpret_cast<float2*>(red + (warp * a.b + n + 1) * M_SW + ch) =
              make_float2(acc[mt][nt][1], acc[mt][nt][3]);
      }
    named_barrier(1, 32 * M_WARPS);
    // the block's partial sum of output e (row n = e / 64, channel e % 64):
    // its warps in order, sent by st.async to the block that owns e (rank e
    // / share), into that block's inbox slot of this rank, counted on that
    // block's inbox barrier
    cluster_wait();
    const uint32_t inbox_addr = smem_u32(inbox);
    for (int e = tid; e < outs; e += 32 * M_WARPS) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < M_WARPS; ++w) v += red[w * outs + e];
      const uint32_t owner = e / share;
      st_async(map_rank(inbox_addr + (rank * share + e % share) * 4, owner), v,
               map_rank(inbox_bar, owner));
    }
  }

  // this block's share of the strip's outputs, once the cluster's partial
  // sums are in: added in rank order, times s, rounded once. No block reads
  // or writes another's shared memory after its inbox is full, so none
  // waits for the others to leave.
  for (int j = tid; j < share; j += M_THREADS) {
    mbar_wait(inbox_bar, 0);
    float sum = 0.f;
    for (int q = 0; q < cl; ++q) sum += inbox[q * share + j];
    const int e = rank * share + j, ch = e % M_SW;
    if (c0 + ch < a.out)
      a.y[(size_t)(e / M_SW) * a.out + c0 + ch] = __float2bfloat16_rn(sum * scale[ch]);
  }
}

// What a weight keeps between calls: its tensor map and shape.
struct Q4Plan {
  CUtensorMap map;  // p as uint8 [kp, out], boxes of M_BR rows x M_SW channels
  int kp, out;
};

struct MmaGeometry {
  int strips, cl, stages, xk, smem;
};

// The launch's shape: strips of M_SW channels, cl blocks a strip (doubled
// while the grid has fewer than two blocks an SM and each block keeps two
// boxes or more), the ring's stages and x's chunk.
MmaGeometry mma_geometry(int b, int kp, int out, int sms) {
  MmaGeometry g;
  const int boxes = (kp + M_BR - 1) / M_BR;
  g.strips = (out + M_SW - 1) / M_SW;
  g.cl = 1;
  while (g.cl < M_MAX_CL && g.strips * g.cl < 2 * sms && boxes >= 4 * g.cl) g.cl *= 2;
  const int nb_max = (boxes + g.cl - 1) / g.cl;
  const int chunk = M_XWORDS / (M_BR * b) > 1 ? M_XWORDS / (M_BR * b) : 1;  // boxes of x
  g.stages = nb_max < M_STAGES ? nb_max : M_STAGES;
  g.xk = (nb_max < chunk ? nb_max : chunk) * M_BR;
  g.smem = mma_smem_bytes(g.stages, b, g.xk);
  return g;
}

template <int NTILES>
cudaError_t launch_mma(const Q4Plan& plan, const void* x, const void* s, void* y, int b,
                       int early, cudaStream_t stream) {
  static int sms = 0;
  static uint64_t ready = 0;  // devices whose shared-memory limit is raised, a bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(q4_matmul_mma_kernel<NTILES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, M_SMEM_MAX);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  const MmaGeometry g = mma_geometry(b, plan.kp, plan.out, sms);
  if (g.smem > M_SMEM_MAX) return cudaErrorInvalidValue;
  MmaArgs args;
  args.x = static_cast<const bf16*>(x);
  args.s = static_cast<const float*>(s);
  args.y = static_cast<bf16*>(y);
  args.b = b;
  args.d = 2 * plan.kp;
  args.kp = plan.kp;
  args.out = plan.out;
  args.boxes = (plan.kp + M_BR - 1) / M_BR;
  args.stages = g.stages;
  args.xk = g.xk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.strips * g.cl));
  cfg.blockDim = dim3(M_THREADS);
  cfg.dynamicSmemBytes = (size_t)g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = early ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  void* params[2] = {const_cast<CUtensorMap*>(&plan.map), &args};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(q4_matmul_mma_kernel<NTILES>),
                            params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [B, d] (bf16 when is_bf16 else fp32), p [d/2, out] int8, s [out] fp32,
// y [B, out] in x's dtype; all contiguous on one device. vec: out % 4 == 0
// and p 4-byte aligned (whole words of p may be read). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int q4_matmul(const void* x, const void* p, const void* s, void* y, int b, int d,
                         int out, int is_bf16, int vec, void* stream) {
  if (b < 1 || b > 64 || d < 2 || d % 2 != 0 || out < 1) return (int)cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<bf16>(x, p, sf, y, b, d, out, vec, st)
                                  : launch<float>(x, p, sf, y, b, d, out, vec, st);
  return (int)err;
}

// The size of a weight's plan (its tensor map and shape), for the caller's
// buffer.
extern "C" int q4_plan_bytes() { return (int)sizeof(Q4Plan); }

// Fill `plan` (q4_plan_bytes() bytes, any alignment) for the packed weight
// p [kp, out] int8: out a multiple of 16, p 16-byte aligned. Host work only;
// the plan stays valid while p's pointer and shape do. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for what the mma route
// does not take).
extern "C" int q4_plan(void* plan, const void* p, int kp, int out) {
  if (kp < 1 || out < 16 || out % 16 != 0 || !tma_ok(p)) return (int)cudaErrorInvalidValue;
  Q4Plan q;
  memset(&q, 0, sizeof q);
  const cuuint64_t dims[2] = {(cuuint64_t)out, (cuuint64_t)kp};
  const cuuint64_t strides[1] = {(cuuint64_t)out};
  const cuuint32_t box[2] = {M_SW, M_BR};
  const cuuint32_t ones[2] = {1, 1};
  const PFN_cuTensorMapEncodeTiled fn = encode_fn();
  if (fn == nullptr ||
      fn(&q.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  q.kp = kp;
  q.out = out;
  memcpy(plan, &q, sizeof q);
  return 0;
}

// The mma route's launch geometry for b rows of x against p [kp, out] on a
// card of `sms` SMs, as launch_mma takes it: g[0..4] = strips, blocks a
// cluster, stages of the ring, packed rows of x staged at once, dynamic
// shared memory bytes. For the wrapper's tests. Returns 0.
extern "C" int q4_geometry(int b, int kp, int out, int sms, int* g) {
  const MmaGeometry m = mma_geometry(b, kp, out, sms);
  g[0] = m.strips;
  g[1] = m.cl;
  g[2] = m.stages;
  g[3] = m.xk;
  g[4] = m.smem;
  return 0;
}

// The mma route: x [b, 2 kp] bf16 (kp a multiple of 4, 16-byte aligned), s
// [out] fp32, y [b, out] bf16, p as `plan` describes it, 1 <= b <= 64.
// early: the launch may start, and stream p and s in, before the kernel
// ahead of it on the stream has completed (programmatic dependent launch),
// so p and s must not be that kernel's output. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int q4_matmul_mma(const void* plan, const void* x, const void* s, void* y, int b,
                             int early, void* stream) {
  Q4Plan q;  // the tensor map 64-byte aligned, as a kernel parameter wants it
  memcpy(&q, plan, sizeof q);
  if (b < 1 || b > 64 || q.kp % 4 != 0 || !tma_ok(x)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b <= 8) err = launch_mma<1>(q, x, s, y, b, early, st);
  else if (b <= 16) err = launch_mma<2>(q, x, s, y, b, early, st);
  else if (b <= 32) err = launch_mma<4>(q, x, s, y, b, early, st);
  else err = launch_mma<8>(q, x, s, y, b, early, st);
  return (int)err;
}
