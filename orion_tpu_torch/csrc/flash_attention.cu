// Flash attention, forward, for Hopper (sm_90a): causal, bidirectional or
// banded (sliding-window) online-softmax attention, in two variants.
//
// Replaces the TPU kernel orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_flat). For q [BH, Tq, D], k, v [BH, Tk, D] (bf16 or
// fp32, contiguous, D <= 128) it writes
//
//     out[t] = sum_s P[t, s] v_s                      (input dtype)
//     lse[t] = m_t + log(l_t)                         (fp32 [BH, Tq])
//     P[t, s] = exp(scale q_t . k_s - m_t) / l_t over the keys s that row t
//               sees: s < Tk, t + q_offset >= s + shift when causal,
//               t + q_offset - s < window when banded (_tile_mask)
//
// with m_t the row's largest score and l_t its sum of exp. shift and
// q_offset (both >= 0, 0 outside the sequence-parallel rings) move the mask:
// shift 1 is the strict triangle of a striped ring block whose key stripe is
// ahead of the query stripe, q_offset the distance of a halo block's queries
// past its keys (orion_tpu/parallel/ring.py). Every loop bound and tile
// predicate below moves with them (_skip_tile). A row that sees no key --
// which they make common: a strict triangle's row 0, a halo's rows past the
// window -- writes out 0 and lse -1e30 (the TPU kernel's `safe` division;
// its partly masked tiles give -1e30 + log(count), the same fp32 value), at
// or below the ring merge's guard of -5e29, never -inf or NaN.
//
// On the TPU the key axis is a sequential grid axis and VMEM scratch carries
// m, l and the accumulator from one grid step to the next. Blocks on an H100
// run in no order, so here a block owns its query rows and loops over the
// 64-row k/v tiles itself, with m, l and the accumulator in registers for
// the whole loop. With a window the loop runs only over the tiles of the
// band, from max(0, q0 - w + 1) / 64 to the block's last row / 64: the
// banded grid of _banded_ok, which on the TPU is a BlockSpec index map. So
// sliding-window attention costs O(T w), not O(T^2).
//
// Two variants, chosen by the wrapper before the launch
// (ops/kernels/flash_attention.py, flash_fwd_variant). The wgmma kernel has
// two instances, chosen by its launcher: OFFSET false (shift and q_offset
// both 0: every model's path) compiles the plain mask exactly as before the
// offsets existed -- the extra terms in the mask and the band cost its
// consumer registers, and at 128 a thread any more spill -- and OFFSET true
// (the rings' blocks) the moved mask (`visible_at`, `tile_*_at`):
//
//   wgmma (flash_fwd_wgmma_kernel): bf16 at D 128 with 16-byte-aligned
//     bases, every model's shape. TMA into a ring of shared-memory stages,
//     Hopper's wgmma from there. The main path's route.
//   simt (flash_fwd_kernel): everything else -- fp32 (the tiny models) and
//     other head widths (D 32, 64). fp32 FMAs on the CUDA cores from
//     shared-memory tiles that the threads fill synchronously.
//
// Bound. Row t of a causal band of width w sees min(t + 1, w) keys. At the
// hybrid_1b3 training shape (B 8, H 16, T 2048, D 128, w 1024, bf16) that is
// 201.4 M (q, k) pairs; q k^T and P v cost 4 D = 512 operations a pair:
// 103.1 GFLOP, 0.104 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// q, k, v read and out, lse written, 269.5 MB or 0.080 ms at 3.35 TB/s. At
// the generate shape (B 4, T 1536) it is 67.1 M pairs, 34.4 GFLOP (0.035 ms)
// against 101.2 MB (0.030 ms). Both are bound by operations, and only the
// tensor cores reach that bound, through wgmma. The wgmma route:
//
//   - One block per (b*h, 192 q rows): three consumer warpgroups of 64 rows
//     each and a producer warpgroup. The block's q rows load once by TMA; the
//     band's (k, v) tiles, 64 keys each, stream through a ring of STAGES
//     stages, each with a "full" mbarrier (the producer arms it with the
//     stage's bytes, TMA completes it) and an "empty" one (each consumer
//     warpgroup arrives once its products have read the stage).
//   - Per tile and warpgroup: S = q k^T as m64n64k16 products from shared
//     memory (both operands K-major); the online softmax in registers, in
//     base 2 (scores times scale log2 e): m, l, alpha = 2^(m - m'), the
//     accumulator rescaled by alpha; then acc += P v as m64n128k16 with P as
//     the A operand from registers and v read MN-major (the transpose bit on
//     B) from the stage.
//   - P is fp32 in the TPU kernel's P v (_fwd_kernel keeps it so). A wgmma
//     takes bf16 operands, and P rounded once to bf16 misses chip_smoke.py's
//     out limit (tests/test_torch_flash_split.py emulates both on the CPU),
//     so P v runs twice, on hi = bf16(P) and lo = bf16(P - hi), into the
//     same fp32 accumulator: P is then carried to about 16 bits.
//   - The accumulator of S (m64n64) converts into the A fragment of
//     m64n128k16 in registers: its 16-column slice kk is exactly the
//     fragment of the k16 slice kk, no trip through shared memory.
//   - Masks only where needed: a tile wholly inside the band and inside Tq
//     and Tk skips the mask (masked scores are -inf, so they add 0 to l); a
//     warpgroup whose 64 x 64 tile lies wholly outside the band skips the
//     tile's products (it still waits on the stage and releases it).
//   - Tails: the tensor maps are 3-D [BH, T, D], so a box that runs past T is
//     zero-filled inside its own head; the mask drops keys past Tk, and rows
//     past Tq are not stored.
//   - Epilogue straight from the registers: out = acc / l (1 where l = 0),
//     rounded once to bf16, two values a store; lse = m + log l, -1e30 where
//     the row saw no key.
//   - The TMA, mbarrier and wgmma helpers and the operand layouts of a 64 x
//     128 tile come from hopper.cuh, shared with flash_attention_bwd.cu,
//     gmm.cu and causal_dot_norm.cu. A wait on an mbarrier that has not
//     completed after 4 s of the card's clock traps: a pipeline fault is a
//     launch error, never a hung card.
//   - Time goes to the softmax (its arithmetic is 0.19 of 0.50 ms at
//     hybrid_1b3's training shape with two consumer warpgroups) more than to
//     the tensor cores or the loads, so the block keeps three warpgroups in
//     flight, to run one's products under the others' softmax, and takes
//     2^x from the SFU (fast_exp2). At 512 threads the producer warpgroup
//     hands registers to the consumers with setmaxnreg (24 / 160).
//   - Build (nvcc -Xptxas -v on the H100): 128 registers at launch, 160 a
//     consumer thread, 0 spilled; 181,320 bytes of shared memory (the
//     block's q rows, 48 KB, and 4 stages of 32 KB): one block an SM. With
//     two consumer warpgroups, a ring of 2 to 4 stages, q as the register A
//     operand of S, two 64-key tiles a softmax round, the next tile's S
//     issued before the softmax, and warpgroups taking turns to issue all
//     timed alike or slower (PERF.md, Findings).
//
// The simt route: one block per (b*h, 64-row q tile). Per k tile:
//   1. load the k and v tiles into shared memory as fp32 (zeros past Tk);
//   2. S = scale q k^T (64 x 64), masked by a select to -1e30;
//   3. m' = max(m, rowmax S); alpha = exp(m - m'); P = exp(S - m') on the
//      kept entries, 0 elsewhere; l = alpha l + rowsum P; acc = alpha acc;
//   4. acc += P v, with P kept in fp32 as _fwd_kernel does.
// The epilogue divides by l (1 where l = 0) and writes out and lse. All
// products accumulate in fp32 on the CUDA cores; bf16 products are exact in
// fp32, so the result matches the fp32 plain version up to summation order.
// 256 threads as a 16 x 16 grid: a thread owns rows ty + 16i (i < 4), score
// columns tx + 16j (j < 4) and output columns tx + 16j (j < 8); the 16
// threads of a row are 16 neighbouring lanes, so the row max and sum are
// shuffles within a half warp. Shared memory: q, k (2 x 64 x 129 fp32), v
// (64 x 128) and P (64 x 65): 115,456 bytes, above the 48 KB default, so
// the launcher raises the limit with cudaFuncSetAttribute. One block per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile of the block's loop
constexpr int D_MAX = 128;      // largest head width the kernel takes
constexpr int NT = 256;         // threads per block: a 16 x 16 thread grid
constexpr int LD = D_MAX + 1;   // padded row stride against bank conflicts
constexpr int LDP = BK + 1;
constexpr int SMEM_FLOATS = 2 * BQ * LD + BK * D_MAX + BQ * LDP;
constexpr float NEG = -1e30f;   // the masked score, as the TPU kernel's _NEG

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a [t, d] matrix into dst (row stride ld) as fp32,
// zeros past t and d
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int t, int d) {
  for (int e = threadIdx.x; e < 64 * D_MAX; e += NT) {
    const int r = e / D_MAX, c = e % D_MAX;
    float x = 0.f;
    if (r0 + r < t && c < d) x = to_f(src[(size_t)(r0 + r) * d + c]);
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ bool sees(int row, int col, int t_k, int causal, int window, int shift,
                                     int q_offset) {
  return col < t_k && (!causal || row + q_offset >= col + shift) &&
         (window <= 0 || row + q_offset - col < window);
}

// a / b rounded down, for a of either sign (b > 0)
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// max / sum over the 16 neighbouring lanes that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse,
    int t_q, int t_k, int d, int n_qt, float scale, int causal, int window, int shift,
    int q_offset) {
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* ks = qs + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][D_MAX]
  float* ps = vs + BK * D_MAX;   // [BQ][LDP] probabilities of the tile

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * t_q * d;
  const T* kb = k + (size_t)bh * t_k * d;
  const T* vb = v + (size_t)bh * t_k * d;

  load_tile(qs, LD, qb, q0, t_q, d);

  // the band of key tiles this q tile sees (none when lo > hi)
  int lo = 0, hi = (t_k - 1) / BK;
  if (window > 0) lo = max(0, q0 + q_offset - window + 1) / BK;
  if (causal) hi = min(hi, floor_div(q0 + q_offset + BQ - 1 - shift, BK));

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    load_tile(ks, LD, kb, k0, t_k, d);
    load_tile(vs, D_MAX, vb, k0, t_k, d);
    __syncthreads();

    // 2. scores
    float s[4][4] = {};
    for (int e = 0; e < d; ++e) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // 3. online softmax update
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool keep[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = sees(row, k0 + tx + 16 * j, t_k, causal, window, shift, q_offset);
        s[i][j] = keep[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // P complete

    // 4. acc += P v, in fp32
    for (int c = 0; c < BK; ++c) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = vs[c * D_MAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: out = acc / l (a row without keys has l = 0 and writes 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_q) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((size_t)bh * t_q + row) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_f<T>(acc[i][j] / safe);
    }
    if (tx == 0) lse[(size_t)bh * t_q + row] = m[i] + logf(safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int bh, int t_q, int t_k, int d, float scale, int causal, int window,
                   int shift, int q_offset, cudaStream_t stream) {
  const int n_qt = (t_q + BQ - 1) / BQ;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_q, t_k, d, n_qt, scale, causal, window, shift, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma route: bf16 at D 128. TMA into a ring of shared-memory stages,
// wgmma from there.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WD = 128;     // the head width this route takes
constexpr int WT = 64;      // keys of a streamed tile, and rows of a warpgroup
constexpr int WROWS = 192;  // a block's query rows: three warpgroups of 64
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;     // a k and a v tile
constexpr int RESIDENT_BYTES = 3 * TILE_BYTES;  // the block's q rows
// three consumer warpgroups and a producer warpgroup whose first lane issues
// the copies: at 512 threads ptxas grants 128 registers a thread, so the
// producer gives registers back (setmaxnreg) and the consumers take them
constexpr int WG_THREADS = 4 * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;  // 128 x 24 + 384 x 160 <= 65,536
// the q tiles and the stages at a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then the barriers
constexpr int WG_SMEM = 1024 + RESIDENT_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
// + shift (the simt kernel's `sees`). A halo block's tile with q_offset >= Tk lies wholly below
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

// The block's shared memory: the q tiles (index 0-2), the ring's stages (a
// k and a v tile each), then a "full" and an "empty" barrier a stage and one
// for the q tiles.
struct Ring {
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t resident(int i) const { return base + i * TILE_BYTES; }
  __device__ __forceinline__ uint32_t k(int s) const {
    return base + RESIDENT_BYTES + s * STAGE_BYTES;
  }
  __device__ __forceinline__ uint32_t v(int s) const { return k(s) + TILE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
  __device__ __forceinline__ uint32_t res() const { return bars + 8 * 2 * STAGES; }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem) {
  Ring r;
  r.base = (smem_u32(smem) + 1023) & ~1023u;
  r.bars = r.base + RESIDENT_BYTES + STAGES * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(r.empty(s), 3);  // one arrive from each consumer warpgroup
    }
    mbar_init(r.res(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// 2^x on the SFU: ex2.approx.ftz, within 2^-22 relative, 2^-inf = 0. P is
// carried to about 2^-17 by its two bf16 halves, so the approximation does
// not show; exp2f costs the softmax a few percent more.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out, lse of one block: q rows [q0, q0 + 192) of head bh; warpgroup wg owns
// rows q0 + 64 wg. The maps read [BH, T, 128] in boxes of 64 rows x 64 d.
template <bool OFFSET>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, float* __restrict__ lse,
    int t_q, int t_k, int n_qt, float scale, int causal, int window, int shift_arg,
    int q_offset_arg) {
  // OFFSET false: shift and q_offset are 0 at compile time, and the kernel
  // is the plain mask's (no register spent on them)
  const int shift = OFFSET ? shift_arg : 0, q_offset = OFFSET ? q_offset_arg : 0;
  extern __shared__ unsigned char wg_smem[];  // the simt kernel declares its own float[]
  const Ring r = make_ring(wg_smem);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * WROWS;
  // the k tiles of the band of rows [q0, q0 + 192); none when lo > hi
  int lo = 0, hi = (t_k - 1) / WT;
  if (OFFSET) {
    if (window > 0) lo = max(0, q0 + q_offset - window + 1) / WT;
    if (causal) hi = min(hi, floor_div(q0 + q_offset + WROWS - 1 - shift, WT));
  } else {
    if (window > 0) lo = max(0, q0 - window + 1) / WT;
    if (causal) hi = min(hi, (q0 + WROWS - 1) / WT);
  }
  const int n = hi - lo + 1;
  if (threadIdx.x >= 384) {  // the producer warpgroup: its first lane issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 384) {
      mbar_expect_tx(r.res(), RESIDENT_BYTES);
      for (int w = 0; w < 3; ++w) tma_tile(r.resident(w), &qmap, r.res(), q0 + WT * w, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(r.empty(s), ((i / STAGES) + 1) & 1);
        mbar_expect_tx(r.full(s), STAGE_BYTES);
        tma_tile(r.k(s), &kmap, r.full(s), (lo + i) * WT, bh);
        tma_tile(r.v(s), &vmap, r.full(s), (lo + i) * WT, bh);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int r0 = q0 + WT * wg;
  const int row = r0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const float sl2 = scale * LOG2E;
  const uint32_t qs = r.resident(wg);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // per row half h (rows row, row + 8): the largest score so far (base 2)
  // and the sum of 2^(score - m) over the keys seen
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(r.res(), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(r.full(s), (i / STAGES) & 1);
    const int k0 = (lo + i) * WT;
    if (!(OFFSET ? tile_hidden_at(r0, k0, t_q, t_k, causal, window, shift, q_offset)
                 : tile_hidden(r0, k0, t_q, t_k, causal, window))) {
      const uint32_t ks = r.k(s), vs = r.v(s);
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_m64n64k16(sc, kmajor(qs, kk), kmajor(ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      const bool edge =
          !(OFFSET ? tile_inside_at(r0, k0, t_q, t_k, causal, window, shift, q_offset)
                   : tile_inside(r0, k0, t_q, t_k, causal, window));
      // element j: row + 8 ((j / 2) % 2), key k0 + 8 (j / 4) + 2 (lane % 4) + j % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j / 2) % 2, key = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        sc[j] *= sl2;
        if (edge && !(OFFSET ? visible_at(row + 8 * h, key, t_q, t_k, causal, window, shift,
                                          q_offset)
                             : visible(row + 8 * h, key, t_q, t_k, causal, window)))
          sc[j] = -INFINITY;
        mx[h] = fmaxf(mx[h], sc[j]);
      }
      float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        base[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: P = 0
        alpha[h] = fast_exp2(m[h] - base[h]);
        m[h] = m_new;
      }
      uint32_t phi[16], plo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j / 2) % 2;
        const float p0 = fast_exp2(sc[j] - base[h]), p1 = fast_exp2(sc[j + 1] - base[h]);
        sum[h] += p0 + p1;
        split_pair(p0, p1, phi[j / 2], plo[j / 2]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] *= alpha[(j / 2) % 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk) wgmma_m64n128k16<1>(acc, phi + 4 * kk, mnmajor(vs, kk));
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk) wgmma_m64n128k16<1>(acc, plo + 4 * kk, mnmajor(vs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(r.empty(s));
  }
  // epilogue: out = acc / l (a row without keys has l = 0 and writes 0)
  bf16* ob = out + (size_t)bh * t_q * WD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h;
    if (t >= t_q) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)t * WD + col) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[(size_t)bh * t_q + t] = l[h] == 0.f ? -1e30f : m[h] * LN2 + logf(l[h]);
  }
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int bh, int t_q, int t_k, float scale, int causal, int window,
                         int shift, int q_offset, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int n_qt = (t_q + WROWS - 1) / WROWS;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7fffffffLL || !tma_ok(q) || !tma_ok(k) || !tma_ok(v) ||
      !encode_heads(&maps[0], q, WD, t_q, bh) || !encode_heads(&maps[1], k, WD, t_k, bh) ||
      !encode_heads(&maps[2], v, WD, t_k, bh))
    return cudaErrorInvalidValue;
  // the instance with the mask moved only for the rings' blocks
  const auto kernel = shift || q_offset ? flash_fwd_wgmma_kernel<true>
                                        : flash_fwd_wgmma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, WG_THREADS, WG_SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, t_q, t_k, n_qt, scale, causal,
      window, shift, q_offset);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Tq, D], k, v [BH, Tk, D], out [BH, Tq, D]: bf16 when is_bf16 else
// fp32. lse [BH, Tq] fp32. window <= 0: no window. shift, q_offset >= 0 move
// the mask (0 but in the rings' blocks). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int t_q, int t_k, int d, int is_bf16,
                                   float scale, int causal, int window, int shift, int q_offset,
                                   void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX || shift < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  float* lsef = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, lsef, bh, t_q, t_k, d, scale, causal,
                                      window, shift, q_offset, st)
              : launch<float>(q, k, v, out, lsef, bh, t_q, t_k, d, scale, causal, window, shift,
                              q_offset, st);
  return (int)err;
}

// The wgmma route: q, out [BH, Tq, 128], k, v [BH, Tk, 128], all bf16, bases
// 16-byte aligned; lse [BH, Tq] fp32. Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for anything it does not take.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int bh, int t_q, int t_k, float scale,
                                         int causal, int window, int shift, int q_offset,
                                         void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || shift < 0 || q_offset < 0 || !tma_ok(out))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(q, k, v, out, static_cast<float*>(lse), bh, t_q, t_k, scale, causal,
                           window, shift, q_offset, static_cast<cudaStream_t>(stream));
}
