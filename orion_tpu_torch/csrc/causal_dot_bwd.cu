// Causal linear attention, backward, for Hopper (sm_90a): one kernel per
// pass of the TPU backwards, each in two variants.
//
// Replaces, in orion_tpu/ops/pallas/causal_dot.py (the normalized ones glued
// by _fused_bwd_core):
//   - causal_dot_dq_den_kernel  <- _bwd_dq_den_kernel (launched by
//     _cdp_dq_den_flat), the normalized forward-walking dq pass;
//   - causal_dot_rev_den_kernel <- _bwd_rev_core (launched by
//     _cdp_rev_den_flat), the normalized reverse-walking dk / dv / dS0 /
//     dz0 pass;
//   - causal_dot_rev_raw_kernel <- _bwd_rev_kernel (launched by
//     _cdp_rev_flat), the unnormalized public op's reverse pass: the same
//     walk with the denominator terms compiled out (no gden, no zr, no dz0),
//     writing fp32 dk, dv and dS0 (_cdp_rev_flat's out_shape). The raw op's
//     dq pass is its forward kernel (causal_dot_norm.cu, causal_dot_raw_kernel)
//     on (g, v, k) with S0^T carried in, as in _cdp_bwd.
//
// With g = d out / d num (cast to the input dtype), gden = d out / d den
// (fp32 [BH, T]), the forward's initial state (S0 [BH, Dk, Dv], z0 [BH, Dk])
// and the cotangents of its final state (gsf [BH, Dk, Dv], gzf [BH, Dk]):
//
//   dq[t] = sum_{s<=t} (g_t . v_s) k_s + g_t S0^T-carried + gden_t (z0 + sum_{s<=t} k_s)
//   dk[t] = sum_{s>=t} (v_t . g_s + gden_s) q_s + v_t R_t + zr_t
//   dv[t] = sum_{s>=t} (k_t . q_s) g_s + k_t R_t^T
//   R     = gsf^T + sum_{s in later chunks} g_s (x) q_s        (Dv x Dk)
//   zr    = gzf   + sum_{s in later chunks} gden_s q_s          (Dk)
//   dS0   = R_final^T, dz0 = zr_final                           (fp32)
//
// All three outputs are one "chunk walk": for row operands x, y [T, dx], a
// column tile w [T, 64] and a state tile St [dx, 64],
//
//   A[t, s] = mask(t, s) ? x_t . y_s (+ gden_t for dq, + gden_s for dk) : 0
//   out     = A w + x St (+ gden_t z for dq, + z for dk)
//   St     += y^T w,  z += sum_s (1 for dq, gden_s for dk) w_s
//
// dq: x = g, y = v, w = k, St = S^T, causal mask, forward walk.
// dk: x = v, y = g, w = q, St = R,   anti-causal mask (s >= t), reverse walk.
// dv: x = k, y = q, w = g, St = R^T, anti-causal mask, reverse walk.
// Folding gden into the masked scores gives the in-chunk prefix (dq) and
// suffix (dk) sums of the denominator term with no extra pass. Masking is
// a select, never a multiply, as the TPU kernel's jnp.where: a non-finite
// masked entry becomes 0, not NaN.
//
// The TPU walks the chunks on a sequential grid axis with the state in VMEM
// scratch. Here one block owns one (b*h, 64-column tile of the output) and
// walks the chunks in a loop with its state tile St (128 x 64 fp32) and z:
// the forward kernel's shape (causal_dot_norm.cu). Each pass has two
// variants, chosen by the wrapper before the launch (ops/kernels/causal_dot.py,
// causal_dot_dq_den_variant, causal_dot_rev_den_variant and
// causal_dot_rev_variant):
//
//   wgmma (causal_dot_dq_den_wgmma_kernel, causal_dot_rev_den_wgmma_kernel,
//     causal_dot_rev_raw_wgmma_kernel): bf16 with a contracted width of 128
//     (Dv for dq; Dk = Dv = 128 for the reverse passes), the output's width a
//     multiple of 64, 16-byte-aligned bases: every model's shape, and the
//     public op's backward at D 128.
//   simt (causal_dot_dq_den_kernel, causal_dot_rev_den_kernel,
//     causal_dot_rev_raw_kernel): everything else -- fp32 (the tiny models)
//     and other widths.
//
// The wgmma route is row 1's walk (causal_dot_norm_wgmma_kernel) with the
// roles above, which bounds it the same way: the loads and the chunk-to-chunk
// chain, not the tensor cores (about 40 wgmma a chunk).
//   - One consumer warpgroup (its 64 rows are the chunk's 64 tokens) and one
//     producer warp. TMA brings each chunk's x and y tiles (64 x 128, 3-D
//     [BH, T, 128] tensor maps zero-filled past T inside a head) and its w
//     tile (64 x 64) into a ring of W_STAGES stages, each with a "full" and
//     an "empty" mbarrier. dk and dv walk last chunk first, so the first
//     tile they load is the ragged one.
//   - St lives in the warpgroup's registers for the whole walk (two m64n64
//     accumulators: rows 0-63 and 64-127), seeded from S0^T (dq), gsf^T (dk)
//     or gsf as laid out (dv), zeros for a null pointer. After each update
//     its bf16 halves go to shared memory as the MN-major B operand of x St
//     (write_state, hopper.cuh), behind a proxy fence and a warpgroup
//     barrier. z (dq) and zr (dk) live in shared memory, and so does the
//     chunk's gden, double-buffered: loaded from device memory a chunk ahead,
//     0 past T.
//   - A = x y^T is m64n64k16 with both operands K-major. gden is added, the
//     mask applied as a select and A split into bf16 halves in registers.
//   - out = A w + x St is four wgmma chains into one fp32 accumulator: A's
//     halves as the register A operand against w MN-major, then x against
//     St's two halves. A and St are fp32 in the TPU kernel's products;
//     rounded once to bf16, A misses chip_smoke.py's dq limit and St, with a
//     state, all three (tests/test_torch_causal_dot_bwd_split.py emulates
//     the walk on the CPU); with the halves each is carried to about 16
//     bits.
//   - Epilogue straight from the registers: + gden_t z (dq) or + zr (dk),
//     stored in bf16, two values a store (row 5: fp32 pairs, 8 bytes a store;
//     the four lanes of a row fill one 32-byte sector).
//   - St += y^T w is m64n64k16 into the St registers with y^T read MN-major
//     from the y tile already in the stage (its halves one box apart) and w
//     MN-major; z += the column sums of w (dq), zr += sum_s gden_s w_s (dk)
//     on the CUDA cores from the w tile.
//   - At the end the dk blocks write dz0 and the dv blocks dS0, fp32.
//   - 3 stages of 40 KB, St's halves 32 KB: 157,488 bytes of shared memory,
//     one block an SM. At B 8, H 16, D 128 the dq launch is 256 blocks (two
//     waves on 132 SMs), each reverse launch 512 (four).
//   - The raw reverse pass (row 5, causal_dot_rev_raw_wgmma_kernel) is the
//     same walk in its dk and dv roles with DEN off (no gden in A, no zr, no
//     dz0) and fp32 outputs (wgmma_walk<ROLE, DEN, TO>), R seeded by dSf^T.
//     Its limits are fp32 ones (chip_smoke.py: 1e-4 |ref| + 1e-4 max|ref|),
//     and two halves still meet them with room: rounded once, A misses them
//     6.6-11x and R 2.2-15x (tests/test_torch_causal_dot_bwd_split.py).
//
// The simt route. Each block keeps its state tile (128 x 64 fp32, 32 KB)
// and z in shared memory. dk needs R's columns and dv needs R's rows, so the
// reverse pass gives each its own blocks, each carrying the state tile it
// needs (R for dk, R^T for dv): one launch, 2 x B*H*2 blocks at Dk = Dv =
// 128, four waves on 132 SMs. The alternative, one block per b*h holding
// all of R (64 KB), leaves 128 blocks for 132 SMs and serializes dk and dv
// inside each; splitting keeps every block the forward's proven size and
// puts four times the blocks in flight. The ragged tail is masked inside
// the kernel: rows past T load as zeros, and the reverse walk starts on
// the ragged last chunk. All products accumulate in fp32 on the CUDA cores;
// bf16 products are exact in fp32.
//
// Shared memory: x, y (2 x 64 x 129 fp32), w and the scores (64 x 65
// each), the state tile (128 x 64), z and gden: 132,864 bytes, above the
// 48 KB default, so the launchers raise the limit with cudaFuncSetAttribute.
//
// Bounds at B 8, H 16, T 1024, D 128, bf16 (the lm_1b3 training shape):
//   raw rev:  reads q, k, v, g (134.2 MB) and dSf (8.4 MB), writes fp32 dk,
//             dv (134.2 MB) and dS0 (8.4 MB): 285.2 MB, 0.085 ms; 25.8
//             GFLOP, 0.026 ms. Bound by bytes: its fp32 outputs are half its
//             bytes.
//   dq pass:  reads g, v, k (100.7 MB) and gden (0.5 MB), writes dq (33.6
//             MB): 134.7 MB, 0.040 ms at 3.35 TB/s; 12.9 GFLOP, 0.013 ms
//             at the 989 TFLOP/s bf16 peak. Bound by bytes.
//   rev pass: reads q, k, v, g (134.2 MB) and gden, writes dk, dv (67.1 MB)
//             and dS0, dz0 (8.5 MB): 210 MB, 0.063 ms; 25.8 GFLOP, 0.026
//             ms. Bound by bytes.
// The simt kernels are not: they do their multiply-adds on the fp32 CUDA
// cores from shared memory, so shared-memory load issue bounds them (28-37x
// their byte bounds at this shape in bf16). The wgmma kernels above are the
// route toward the byte bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 64;           // tokens per chunk of the block's walk
constexpr int DX_MAX = 128;     // largest contracted width (Dv for dq and dk, Dk for dv)
constexpr int DWT = 64;         // output columns per block
constexpr int NT = 256;         // threads per block: a 16 x 16 thread grid
constexpr int LDX = DX_MAX + 1;  // padded row strides against bank conflicts
constexpr int LDW = DWT + 1;
constexpr int LDA = C + 1;
constexpr int SMEM_FLOATS = 2 * C * LDX + C * LDW + C * LDA + DX_MAX * DWT + DWT + C;

enum Role { ROLE_DQ = 0, ROLE_DK = 1, ROLE_DV = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One role's operands. x, y: [BH, T, dx]; w, out: [BH, T, dw]; gd: [BH, T].
// T: the inputs' type; TO: out's (T, or fp32 for the raw reverse pass).
template <typename T, typename TO>
struct Walk {
  const T* x;
  const T* y;
  const T* w;
  const float* gd;   // the denominator's cotangent (dq, dk), else null
  const float* st0;  // initial state, null = zeros
  int st0_t;         // 1: st0 is [BH, dw, dx], read transposed; 0: [BH, dx, dw]
  const float* z0;   // [BH, dw] initial z, null = zeros
  TO* out;
  float* st_out;     // [BH, dx, dw] final state, or null
  float* z_out;      // [BH, dw] final z, or null
  int dx, dw, n_tiles;
};

// DEN: the normalized backward's denominator terms (gden, z); compiled out
// for the raw reverse pass.
template <typename T, typename TO, int ROLE, bool DEN>
__device__ __forceinline__ void walk(const Walk<T, TO>& p, int bh, int tile, int t_len,
                                     float* smem) {
  constexpr bool REV = ROLE != ROLE_DQ;
  float* xs = smem;               // [C][LDX]
  float* ys = xs + C * LDX;       // [C][LDX]
  float* ws = ys + C * LDX;       // [C][LDW] the w tile
  float* as = ws + C * LDW;       // [C][LDA] masked scores
  float* ss = as + C * LDA;       // [DX_MAX][DWT] running state tile
  float* zs = ss + DX_MAX * DWT;  // [DWT] running z
  float* gds = zs + DWT;          // [C] gden of the chunk

  const int j0 = tile * DWT;
  const int dwt = min(DWT, p.dw - j0);  // live columns of this tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t x_base = (size_t)bh * t_len * p.dx;
  const size_t w_base = (size_t)bh * t_len * p.dw;
  const size_t s_base = (size_t)bh * p.dx * p.dw;

  for (int e = tid; e < DX_MAX * DWT; e += NT) {
    const int d = e / DWT, j = e % DWT;
    float s = 0.f;
    if (p.st0 != nullptr && d < p.dx && j < dwt) {
      s = p.st0_t ? p.st0[s_base + (size_t)(j0 + j) * p.dx + d]
                  : p.st0[s_base + (size_t)d * p.dw + j0 + j];
    }
    ss[e] = s;
  }
  for (int j = tid; DEN && j < DWT; j += NT) {
    zs[j] = (p.z0 != nullptr && j < dwt) ? p.z0[(size_t)bh * p.dw + j0 + j] : 0.f;
  }

  const int n_chunks = (t_len + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = (REV ? n_chunks - 1 - ci : ci) * C;
    const int rows = min(C, t_len - c0);

    // 1. the chunk's x, y rows, w tile and gden, as fp32; zeros past T / dx / dw
    for (int e = tid; e < C * DX_MAX; e += NT) {
      const int r = e / DX_MAX, d = e % DX_MAX;
      float xv = 0.f, yv = 0.f;
      if (r < rows && d < p.dx) {
        const size_t g = x_base + (size_t)(c0 + r) * p.dx + d;
        xv = to_f(p.x[g]);
        yv = to_f(p.y[g]);
      }
      xs[r * LDX + d] = xv;
      ys[r * LDX + d] = yv;
    }
    for (int e = tid; e < C * DWT; e += NT) {
      const int r = e / DWT, j = e % DWT;
      float wv = 0.f;
      if (r < rows && j < dwt) wv = to_f(p.w[w_base + (size_t)(c0 + r) * p.dw + j0 + j]);
      ws[r * LDW + j] = wv;
    }
    if (DEN && tid < C) {
      gds[tid] = (p.gd != nullptr && tid < rows) ? p.gd[(size_t)bh * t_len + c0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. masked scores; this thread owns rows ty + 16i and columns tx + 16j
    {
      float acc[4][4] = {};
      for (int d = 0; d < p.dx; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * LDX + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ys[(tx + 16 * j) * LDX + d];
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
          float v = acc[i][j];
          if (DEN && ROLE == ROLE_DQ) v += gds[t];
          if (DEN && ROLE == ROLE_DK) v += gds[s];
          const bool keep = REV ? (s >= t) : (s <= t);
          as[t * LDA + s] = keep ? v : 0.f;
        }
    }
    __syncthreads();

    // 3. out = A w + x St (+ the carried z term); same thread tiling
    {
      float o[4][4] = {};
      for (int s = 0; s < C; ++s) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * LDA + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[s * LDW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
      }
      for (int d = 0; d < p.dx; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * LDX + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ss[d * DWT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, col = tx + 16 * j;
          if (t < rows && col < dwt) {
            float v = o[i][j];
            if (DEN && ROLE == ROLE_DQ) v = fmaf(gds[t], zs[col], v);
            if (DEN && ROLE == ROLE_DK) v += zs[col];
            p.out[w_base + (size_t)(c0 + t) * p.dw + j0 + col] = from_f<TO>(v);
          }
        }
    }
    __syncthreads();  // every read of the state and z is done

    // 4. St += y^T w (rows ty + 16i of St, columns tx + 16j); z += the chunk's w sum
    {
      float acc[8][4] = {};
      for (int s = 0; s < rows; ++s) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ys[s * LDX + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[s * LDW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ss[(ty + 16 * i) * DWT + tx + 16 * j] += acc[i][j];
    }
    if (DEN && ROLE != ROLE_DV && tid < DWT) {
      float acc = 0.f;
      for (int s = 0; s < rows; ++s) {
        acc = fmaf(ROLE == ROLE_DK ? gds[s] : 1.f, ws[s * LDW + tid], acc);
      }
      zs[tid] += acc;
    }
    __syncthreads();  // state and z updated before the next chunk reads them
  }

  if (p.st_out != nullptr) {
    for (int e = tid; e < DX_MAX * DWT; e += NT) {
      const int d = e / DWT, j = e % DWT;
      if (d < p.dx && j < dwt) p.st_out[s_base + (size_t)d * p.dw + j0 + j] = ss[e];
    }
  }
  if (DEN && p.z_out != nullptr) {
    for (int j = tid; j < dwt; j += NT) p.z_out[(size_t)bh * p.dw + j0 + j] = zs[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_dq_den_kernel(Walk<T, T> p, int t_len) {
  extern __shared__ float smem[];
  walk<T, T, ROLE_DQ, true>(p, blockIdx.x / p.n_tiles, blockIdx.x % p.n_tiles, t_len, smem);
}

// blocks [0, bh * pk.n_tiles) make dk (and dz0); the rest make dv (and dS0)
template <typename T, typename TO, bool DEN>
__device__ __forceinline__ void rev_walks(const Walk<T, TO>& pk, const Walk<T, TO>& pv, int bh,
                                          int t_len, float* smem) {
  const int nk = bh * pk.n_tiles;
  const int b = blockIdx.x;
  if (b < nk) {
    walk<T, TO, ROLE_DK, DEN>(pk, b / pk.n_tiles, b % pk.n_tiles, t_len, smem);
  } else {
    walk<T, TO, ROLE_DV, DEN>(pv, (b - nk) / pv.n_tiles, (b - nk) % pv.n_tiles, t_len, smem);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_rev_den_kernel(Walk<T, T> pk, Walk<T, T> pv,
                                                                int bh, int t_len) {
  extern __shared__ float smem[];
  rev_walks<T, T, true>(pk, pv, bh, t_len, smem);
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_rev_raw_kernel(Walk<T, float> pk,
                                                                Walk<T, float> pv, int bh,
                                                                int t_len) {
  extern __shared__ float smem[];
  rev_walks<T, float, false>(pk, pv, bh, t_len, smem);
}

template <typename T, typename TO>
Walk<T, TO> make_walk(const void* x, const void* y, const void* w, const void* gd,
                      const void* st0, int st0_t, const void* z0, void* out, void* st_out,
                      void* z_out, int dx, int dw) {
  Walk<T, TO> p;
  p.x = static_cast<const T*>(x);
  p.y = static_cast<const T*>(y);
  p.w = static_cast<const T*>(w);
  p.gd = static_cast<const float*>(gd);
  p.st0 = static_cast<const float*>(st0);
  p.st0_t = st0_t;
  p.z0 = static_cast<const float*>(z0);
  p.out = static_cast<TO*>(out);
  p.st_out = static_cast<float*>(st_out);
  p.z_out = static_cast<float*>(z_out);
  p.dx = dx;
  p.dw = dw;
  p.n_tiles = (dw + DWT - 1) / DWT;
  return p;
}

template <typename T>
cudaError_t launch_dq(const void* g, const void* v, const void* k, const void* gden,
                      const void* s0, const void* z0, void* dq, int bh, int t, int dk,
                      int dv, cudaStream_t stream) {
  // x = g, y = v [.., Dv]; w = k, out = dq [.., Dk]; S0 [BH, Dk, Dv] read as S0^T
  const Walk<T, T> p =
      make_walk<T, T>(g, v, k, gden, s0, 1, z0, dq, nullptr, nullptr, dv, dk);
  const long long blocks = (long long)bh * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_dot_dq_den_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  causal_dot_dq_den_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(p, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rev(const void* q, const void* k, const void* v, const void* g,
                       const void* gden, const void* gsf, const void* gzf, void* dk_out,
                       void* dv_out, void* ds0, void* dz0, int bh, int t, int dk, int dv,
                       cudaStream_t stream) {
  // dk: x = v, y = g [.., Dv]; w = q [.., Dk]; R = gsf^T read from [BH, Dk, Dv]
  const Walk<T, T> pk =
      make_walk<T, T>(v, g, q, gden, gsf, 1, gzf, dk_out, nullptr, dz0, dv, dk);
  // dv: x = k, y = q [.., Dk]; w = g [.., Dv]; R^T = gsf as laid out, dS0 likewise
  const Walk<T, T> pv =
      make_walk<T, T>(k, q, g, nullptr, gsf, 0, nullptr, dv_out, ds0, nullptr, dk, dv);
  const long long blocks = (long long)bh * (pk.n_tiles + pv.n_tiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_dot_rev_den_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  causal_dot_rev_den_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(pk, pv, bh, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rev_raw(const void* q, const void* k, const void* v, const void* g,
                           const void* gsf, void* dk_out, void* dv_out, void* ds0, int bh,
                           int t, int dk, int dv, cudaStream_t stream) {
  // the roles of launch_rev with the denominator terms compiled out and
  // fp32 outputs; R = gsf^T seeds the walk (zeros when gsf is null)
  const Walk<T, float> pk =
      make_walk<T, float>(v, g, q, nullptr, gsf, 1, nullptr, dk_out, nullptr, nullptr, dv, dk);
  const Walk<T, float> pv =
      make_walk<T, float>(k, q, g, nullptr, gsf, 0, nullptr, dv_out, ds0, nullptr, dk, dv);
  const long long blocks = (long long)bh * (pk.n_tiles + pv.n_tiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_dot_rev_raw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  causal_dot_rev_raw_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(pk, pv, bh, t);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma route of rows 3 and 4: bf16, a contracted width of 128, output
// columns in tiles of 64. TMA into a ring of shared-memory stages, wgmma
// from there.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WC = 64;    // tokens a chunk: the rows of the consumer warpgroup
constexpr int WDX = 128;  // the contracted width this route takes
constexpr int WDW = 64;   // output columns a block
constexpr int W_STAGES = 3;
// a stage: the chunk's x and y tiles (64 x 128) and w tile (64 x 64)
constexpr int W_STAGE_BYTES = 2 * TILE_BYTES + HALF_BYTES;
constexpr int ST_BYTES = WDX * WDW * 2;  // one bf16 half of the state tile, [128][64]
constexpr int W_THREADS = 128 + 32;      // one consumer warpgroup, one producer warp
// the stages and St's two halves at a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then z, two chunks' gden and
// the barriers
constexpr int W_SMEM =
    1024 + W_STAGES * W_STAGE_BYTES + 2 * ST_BYTES + (WDW + 2 * WC) * 4 + 2 * W_STAGES * 8;

// The block's shared memory: the ring's stages (x, y, w), St's bf16 halves
// (MN-major [128][64], as the B operand of x St), z, gden of two chunks, then
// a "full" and an "empty" barrier a stage.
struct BwdRing {
  uint32_t base;
  __device__ __forceinline__ uint32_t x(int s) const { return base + s * W_STAGE_BYTES; }
  __device__ __forceinline__ uint32_t y(int s) const { return x(s) + TILE_BYTES; }
  __device__ __forceinline__ uint32_t w(int s) const { return x(s) + 2 * TILE_BYTES; }
  __device__ __forceinline__ uint32_t st_hi() const { return base + W_STAGES * W_STAGE_BYTES; }
  __device__ __forceinline__ uint32_t st_lo() const { return st_hi() + ST_BYTES; }
  __device__ __forceinline__ uint32_t z() const { return st_lo() + ST_BYTES; }
  __device__ __forceinline__ uint32_t gd() const { return z() + WDW * 4; }
  __device__ __forceinline__ uint32_t full(int s) const { return gd() + 2 * WC * 4 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(W_STAGES + s); }
};

// One role's pointers (the tensor maps of x, y and w come beside them). TO:
// out's type, bf16 for rows 3 and 4, fp32 for the raw reverse pass (row 5).
template <typename TO>
struct WgmmaWalk {
  const float* gd;   // gden [BH, T] (dq, dk), null for dv and the raw pass
  const float* st0;  // the initial state: S0 (dq) or gsf (dk, dv) [BH, Dk, Dv]; null = zeros
  const float* z0;   // [BH, dw]: z0 (dq) or gzf (dk); null = zeros
  TO* out;           // [BH, T, dw]
  float* st_out;     // dS0 [BH, 128, dw] (dv), else null
  float* z_out;      // dz0 [BH, dw] (dk), else null
  int dw, n_tiles;
};

// Two neighbouring outputs of a row, from the accumulator's pair: bf16 (rows
// 3, 4) or fp32 (row 5), one store.
__device__ __forceinline__ void store_pair(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

// One block: output columns [j0, j0 + 64) of head bh, the whole sequence in
// chunks of 64, first to last (dq) or last to first (dk, dv). x, y: maps of
// [BH, T, 128], w: of [BH, T, dw], read in boxes of 64 rows x 64 columns.
// DEN: gden in A and a carried z (dq) or zr (dk); rows 3 and 4 take it in
// their dq and dk roles, their dv role and the raw reverse pass (row 5) not.
template <int ROLE, bool DEN, typename TO>
__device__ __forceinline__ void wgmma_walk(const CUtensorMap* xmap, const CUtensorMap* ymap,
                                           const CUtensorMap* wmap, const WgmmaWalk<TO>& p,
                                           int bh, int tile, int t_len, unsigned char* smem) {
  static_assert(DEN || ROLE != ROLE_DQ, "the dq role carries the denominator");
  static_assert(!DEN || ROLE != ROLE_DV, "the dv role has no denominator term");
  constexpr bool REV = ROLE != ROLE_DQ;
  BwdRing r;
  r.base = (smem_u32(smem) + 1023) & ~1023u;
  const int j0 = tile * WDW;
  const int n_chunks = (t_len + WC - 1) / WC;
  // the first token of the walk's c-th chunk
  const auto chunk_row = [n_chunks](int c) { return (REV ? n_chunks - 1 - c : c) * WC; };
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
        const int s = c % W_STAGES, row = chunk_row(c);
        if (c >= W_STAGES) mbar_wait(r.empty(s), ((c / W_STAGES) + 1) & 1);
        mbar_expect_tx(r.full(s), W_STAGE_BYTES);
        tma_tile(r.x(s), xmap, r.full(s), row, bh);
        tma_tile(r.y(s), ymap, r.full(s), row, bh);
        tma_3d(r.w(s), wmap, r.full(s), j0, row, bh);
      }
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rw = 16 * warp + lane / 4;  // this thread's rows of a chunk: rw, rw + 8
  unsigned char* st_hi = at<unsigned char>(r.st_hi(), smem);
  unsigned char* st_lo = at<unsigned char>(r.st_lo(), smem);
  float* zs = at<float>(r.z(), smem);
  float* gds = at<float>(r.gd(), smem);
  const float* gd = DEN ? p.gd + (size_t)bh * t_len : nullptr;
  const size_t s_base = (size_t)bh * WDX * p.dw;

  // St in registers for the whole walk: element j of sa (sb) is row rw + 8
  // ((j / 2) % 2) (plus 64) and column 8 (j / 4) + 2 (lane % 4) + j % 2. dq
  // and dk read their [dw][128] source transposed, dv its [128][dw] as laid out.
  float sa[32], sb[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int m = rw + 8 * ((j / 2) % 2), n = j0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    sa[j] = sb[j] = 0.f;
    if (p.st0 != nullptr && ROLE == ROLE_DV) {
      sa[j] = p.st0[s_base + (size_t)m * p.dw + n];
      sb[j] = p.st0[s_base + (size_t)(m + 64) * p.dw + n];
    } else if (p.st0 != nullptr) {
      sa[j] = p.st0[s_base + (size_t)n * WDX + m];
      sb[j] = p.st0[s_base + (size_t)n * WDX + m + 64];
    }
  }
  if (DEN && tid < WDW) {
    zs[tid] = p.z0 != nullptr ? p.z0[(size_t)bh * p.dw + j0 + tid] : 0.f;
    const int t = chunk_row(0) + tid;
    gds[tid] = t < t_len ? gd[t] : 0.f;
  }
  write_state(sa, sb, st_hi, st_lo);
  fence_async_smem();
  named_barrier(1, 128);

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % W_STAGES, c0 = chunk_row(c);
    const float* gcur = gds + (c & 1) * WC;  // this chunk's gden
    float gnext = 0.f;  // the next chunk's, for the other buffer
    if (DEN && tid < WC && c + 1 < n_chunks) {
      const int t = chunk_row(c + 1) + tid;
      if (t < t_len) gnext = gd[t];
    }
    mbar_wait(r.full(s), (c / W_STAGES) & 1);
    const uint32_t xs = r.x(s), ys = r.y(s), ws = r.w(s);

    // A = x y^T: both operands K-major
    float a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = 0.f;
    fence_acc(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WDX / 16; ++kk) wgmma_m64n64k16(a, kmajor(xs, kk), kmajor(ys, kk));
    wgmma_commit();
    float gt[2] = {0.f, 0.f};  // dq: gden of this thread's two rows
    if (ROLE == ROLE_DQ) {
      gt[0] = gcur[rw];
      gt[1] = gcur[rw + 8];
    }
    wgmma_wait<0>();
    fence_acc(a);

    // gden_t (dq) or gden_s (dk) added, then the mask s <= t (dq) or s >= t
    // (dk, dv) as a select (element j: row rw + 8 ((j / 2) % 2), column
    // 8 (j / 4) + 2 (lane % 4) + j % 2), then A's bf16 halves
    uint32_t ahi[16], alo[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int h = (j / 2) % 2, t = rw + 8 * h, col = 8 * (j / 4) + 2 * (lane % 4);
      float a0 = a[j], a1 = a[j + 1];
      if (ROLE == ROLE_DQ) {
        a0 += gt[h];
        a1 += gt[h];
      }
      if (DEN && ROLE == ROLE_DK) {
        a0 += gcur[col];
        a1 += gcur[col + 1];
      }
      const bool keep0 = REV ? col >= t : col <= t;
      const bool keep1 = REV ? col + 1 >= t : col + 1 <= t;
      split_pair(keep0 ? a0 : 0.f, keep1 ? a1 : 0.f, ahi[j / 2], alo[j / 2]);
    }

    // out = A w + x St: A's halves from registers against w MN-major, then x
    // (K-major) against St's halves (MN-major), into one fp32 accumulator
    float o[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] = 0.f;
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(o, ahi + 4 * kk, mnmajor(ws, kk));
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(o, alo + 4 * kk, mnmajor(ws, kk));
#pragma unroll
    for (int kk = 0; kk < WDX / 16; ++kk)
      wgmma_m64n64k16<0, 1>(o, kmajor(xs, kk), mnmajor(r.st_hi(), kk));
#pragma unroll
    for (int kk = 0; kk < WDX / 16; ++kk)
      wgmma_m64n64k16<0, 1>(o, kmajor(xs, kk), mnmajor(r.st_lo(), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);

    // epilogue: + gden_t z (dq) or + zr (dk), stored in bf16 (fp32 for row 5)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = c0 + rw + 8 * h;
      if (t >= t_len) continue;
      const size_t off = ((size_t)bh * t_len + t) * p.dw + j0 + 2 * (lane % 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        float v0 = o[4 * jj + 2 * h], v1 = o[4 * jj + 2 * h + 1];
        if (ROLE == ROLE_DQ) {
          v0 = fmaf(gt[h], zs[col], v0);
          v1 = fmaf(gt[h], zs[col + 1], v1);
        }
        if (DEN && ROLE == ROLE_DK) {
          v0 += zs[col];
          v1 += zs[col + 1];
        }
        store_pair(p.out + off + 8 * jj, v0, v1);
      }
    }
    named_barrier(1, 128);  // every read of z, gden and St's halves in this chunk is done

    // z += the chunk's column sums of w (dq), zr += sum_s gden_s w_s (dk);
    // zeros past T. Then the next chunk's gden into the other buffer.
    if (DEN && tid < WDW) {
      const unsigned char* wt = at<unsigned char>(ws, smem);
      float acc = 0.f;
      for (int t = 0; t < WC; ++t) {
        const float wv =
            __bfloat162float(*reinterpret_cast<const bf16*>(wt + tile_offset(t, tid)));
        acc = ROLE == ROLE_DQ ? acc + wv : fmaf(gcur[t], wv, acc);
      }
      zs[tid] += acc;
      gds[((c + 1) & 1) * WC + tid] = gnext;
    }
    // St += y^T w: y^T read MN-major from the y tile (its halves one box
    // apart), w MN-major
    fence_acc(sa);
    fence_acc(sb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk)
      wgmma_m64n64k16<1, 1>(sa, mnmajor(ys, kk), mnmajor(ws, kk));
#pragma unroll
    for (int kk = 0; kk < WC / 16; ++kk)
      wgmma_m64n64k16<1, 1>(sb, mnmajor(ys + HALF_BYTES, kk), mnmajor(ws, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sa);
    fence_acc(sb);
    write_state(sa, sb, st_hi, st_lo);
    fence_async_smem();
    named_barrier(1, 128);  // St's halves, z and gden complete; the stage's reads done
    if (tid == 0) mbar_arrive(r.empty(s));
  }

  // dS0 = the final St as laid out (dv), fp32 from the registers; dz0 (dk)
  if (p.st_out != nullptr) {
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int m = rw + 8 * ((j / 2) % 2), n = j0 + 8 * (j / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p.st_out + s_base + (size_t)m * p.dw + n) =
          make_float2(sa[j], sa[j + 1]);
      *reinterpret_cast<float2*>(p.st_out + s_base + (size_t)(m + 64) * p.dw + n) =
          make_float2(sb[j], sb[j + 1]);
    }
  }
  if (DEN && p.z_out != nullptr && tid < WDW) p.z_out[(size_t)bh * p.dw + j0 + tid] = zs[tid];
}

__global__ void __launch_bounds__(W_THREADS, 1) causal_dot_dq_den_wgmma_kernel(
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap kmap, const WgmmaWalk<bf16> p, int t_len) {
  extern __shared__ unsigned char w_smem[];  // the simt kernels declare their own float[]
  wgmma_walk<ROLE_DQ, true, bf16>(&gmap, &vmap, &kmap, p, blockIdx.x / p.n_tiles,
                                  blockIdx.x % p.n_tiles, t_len, w_smem);
}

// blocks [0, bh * pk.n_tiles) make dk (and dz0 with DEN); the rest make dv (and dS0)
template <bool DEN, typename TO>
__device__ __forceinline__ void rev_wgmma_walks(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                                const CUtensorMap* vmap, const CUtensorMap* gmap,
                                                const WgmmaWalk<TO>& pk, const WgmmaWalk<TO>& pv,
                                                int bh, int t_len, unsigned char* smem) {
  const int nk = bh * pk.n_tiles, b = blockIdx.x;
  if (b < nk) {
    wgmma_walk<ROLE_DK, DEN, TO>(vmap, gmap, qmap, pk, b / pk.n_tiles, b % pk.n_tiles, t_len,
                                 smem);
  } else {
    wgmma_walk<ROLE_DV, false, TO>(kmap, qmap, gmap, pv, (b - nk) / pv.n_tiles,
                                   (b - nk) % pv.n_tiles, t_len, smem);
  }
}

__global__ void __launch_bounds__(W_THREADS, 1) causal_dot_rev_den_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const WgmmaWalk<bf16> pk, const WgmmaWalk<bf16> pv, int bh, int t_len) {
  extern __shared__ unsigned char w_smem[];
  rev_wgmma_walks<true>(&qmap, &kmap, &vmap, &gmap, pk, pv, bh, t_len, w_smem);
}

// the raw reverse pass (row 5): the same walks, no denominator, fp32 dk and dv
__global__ void __launch_bounds__(W_THREADS, 1) causal_dot_rev_raw_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const WgmmaWalk<float> pk, const WgmmaWalk<float> pv, int bh, int t_len) {
  extern __shared__ unsigned char w_smem[];
  rev_wgmma_walks<false>(&qmap, &kmap, &vmap, &gmap, pk, pv, bh, t_len, w_smem);
}

template <typename TO>
WgmmaWalk<TO> make_wgmma_walk(const void* gd, const void* st0, const void* z0, void* out,
                              void* st_out, void* z_out, int dw) {
  WgmmaWalk<TO> p;
  p.gd = static_cast<const float*>(gd);
  p.st0 = static_cast<const float*>(st0);
  p.z0 = static_cast<const float*>(z0);
  p.out = static_cast<TO*>(out);
  p.st_out = static_cast<float*>(st_out);
  p.z_out = static_cast<float*>(z_out);
  p.dw = dw;
  p.n_tiles = dw / WDW;
  return p;
}

cudaError_t launch_dq_wgmma(const void* g, const void* v, const void* k, const void* gden,
                            const void* s0, const void* z0, void* dq, int bh, int t, int dk,
                            cudaStream_t stream) {
  // x = g, y = v [.., 128]; w = k, out = dq [.., Dk]; S0 [BH, Dk, 128] read as S0^T
  CUtensorMap maps[3];
  const WgmmaWalk<bf16> p = make_wgmma_walk<bf16>(gden, s0, z0, dq, nullptr, nullptr, dk);
  const long long blocks = (long long)bh * p.n_tiles;
  if (blocks > 0x7fffffffLL || !tma_ok(g) || !tma_ok(v) || !tma_ok(k) ||
      !encode_heads(&maps[0], g, WDX, t, bh) || !encode_heads(&maps[1], v, WDX, t, bh) ||
      !encode_heads(&maps[2], k, dk, t, bh))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(causal_dot_dq_den_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  causal_dot_dq_den_wgmma_kernel<<<(unsigned)blocks, W_THREADS, W_SMEM, stream>>>(
      maps[0], maps[1], maps[2], p, t);
  return cudaGetLastError();
}

// One of the two reverse wgmma kernels on q, k, v, g [BH, T, 128] with the
// roles' pointers: dk: x = v, y = g, w = q; dv: x = k, y = q, w = g.
template <typename TO>
cudaError_t launch_rev_walks(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                                            WgmmaWalk<TO>, WgmmaWalk<TO>, int, int),
                             const void* q, const void* k, const void* v, const void* g,
                             const WgmmaWalk<TO>& pk, const WgmmaWalk<TO>& pv, int bh, int t,
                             cudaStream_t stream) {
  CUtensorMap maps[4];
  const long long blocks = (long long)bh * (pk.n_tiles + pv.n_tiles);
  const void* in[4] = {q, k, v, g};
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (!tma_ok(in[i]) || !encode_heads(&maps[i], in[i], WDX, t, bh)) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, W_THREADS, W_SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], pk,
                                                          pv, bh, t);
  return cudaGetLastError();
}

cudaError_t launch_rev_wgmma(const void* q, const void* k, const void* v, const void* g,
                             const void* gden, const void* gsf, const void* gzf, void* dk_out,
                             void* dv_out, void* ds0, void* dz0, int bh, int t,
                             cudaStream_t stream) {
  // dk: R = gsf^T, zr = gzf, dz0 out. dv: R^T = gsf as laid out, dS0 likewise
  const WgmmaWalk<bf16> pk = make_wgmma_walk<bf16>(gden, gsf, gzf, dk_out, nullptr, dz0, WDX);
  const WgmmaWalk<bf16> pv = make_wgmma_walk<bf16>(nullptr, gsf, nullptr, dv_out, ds0, nullptr,
                                                   WDX);
  return launch_rev_walks(causal_dot_rev_den_wgmma_kernel, q, k, v, g, pk, pv, bh, t, stream);
}

cudaError_t launch_rev_raw_wgmma(const void* q, const void* k, const void* v, const void* g,
                                 const void* gsf, void* dk_out, void* dv_out, void* ds0, int bh,
                                 int t, cudaStream_t stream) {
  // the roles of launch_rev_wgmma without gden, gzf and dz0, writing fp32;
  // R = gsf^T seeds the walk (zeros when gsf is null)
  const WgmmaWalk<float> pk =
      make_wgmma_walk<float>(nullptr, gsf, nullptr, dk_out, nullptr, nullptr, WDX);
  const WgmmaWalk<float> pv =
      make_wgmma_walk<float>(nullptr, gsf, nullptr, dv_out, ds0, nullptr, WDX);
  return launch_rev_walks(causal_dot_rev_raw_wgmma_kernel, q, k, v, g, pk, pv, bh, t, stream);
}

}  // namespace

// g, v [BH, T, Dv], k, dq [BH, T, Dk]: bf16 when is_bf16 else fp32. gden
// [BH, T] fp32. s0 [BH, Dk, Dv], z0 [BH, Dk] fp32, nullptr for a zero
// initial state. Returns the cudaError_t of the launch (0 on success).
extern "C" int causal_dot_dq_den(const void* g, const void* v, const void* k,
                                 const void* gden, const void* s0, const void* z0, void* dq,
                                 int bh, int t, int dk, int dv, int is_bf16, void* stream) {
  if (bh < 1 || t < 1 || dk < 1 || dv < 1 || dv > DX_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dq<__nv_bfloat16>(g, v, k, gden, s0, z0, dq, bh, t, dk, dv, st)
              : launch_dq<float>(g, v, k, gden, s0, z0, dq, bh, t, dk, dv, st);
  return (int)err;
}

// q, k, dk_out [BH, T, Dk], v, g, dv_out [BH, T, Dv]: bf16 when is_bf16 else
// fp32. gden [BH, T] fp32. gsf [BH, Dk, Dv], gzf [BH, Dk] fp32, nullptr for
// zero cotangents of the final state. ds0 [BH, Dk, Dv], dz0 [BH, Dk] fp32
// outputs. Returns the cudaError_t of the launch (0 on success).
extern "C" int causal_dot_rev_den(const void* q, const void* k, const void* v, const void* g,
                                  const void* gden, const void* gsf, const void* gzf,
                                  void* dk_out, void* dv_out, void* ds0, void* dz0, int bh,
                                  int t, int dk, int dv, int is_bf16, void* stream) {
  if (bh < 1 || t < 1 || dk < 1 || dk > DX_MAX || dv < 1 || dv > DX_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_rev<__nv_bfloat16>(q, k, v, g, gden, gsf, gzf, dk_out, dv_out, ds0,
                                          dz0, bh, t, dk, dv, st)
              : launch_rev<float>(q, k, v, g, gden, gsf, gzf, dk_out, dv_out, ds0, dz0, bh,
                                  t, dk, dv, st);
  return (int)err;
}

// The raw reverse pass. q, k [BH, T, Dk], v, g [BH, T, Dv]: bf16 when
// is_bf16 else fp32. gsf [BH, Dk, Dv] fp32, the cotangent of the final state
// (R = gsf^T), nullptr for zeros. dk_out [BH, T, Dk], dv_out [BH, T, Dv] and
// ds0 [BH, Dk, Dv]: fp32 outputs. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int causal_dot_rev(const void* q, const void* k, const void* v, const void* g,
                              const void* gsf, void* dk_out, void* dv_out, void* ds0, int bh,
                              int t, int dk, int dv, int is_bf16, void* stream) {
  if (bh < 1 || t < 1 || dk < 1 || dk > DX_MAX || dv < 1 || dv > DX_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_rev_raw<__nv_bfloat16>(q, k, v, g, gsf, dk_out, dv_out, ds0, bh, t, dk,
                                              dv, st)
              : launch_rev_raw<float>(q, k, v, g, gsf, dk_out, dv_out, ds0, bh, t, dk, dv, st);
  return (int)err;
}

// The wgmma route of causal_dot_dq_den: g, v [BH, T, 128], k, dq [BH, T, Dk]
// bf16 with Dk a multiple of 64, bases 16-byte aligned; gden, s0, z0 as
// causal_dot_dq_den. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for anything it does not take.
extern "C" int causal_dot_dq_den_wgmma(const void* g, const void* v, const void* k,
                                       const void* gden, const void* s0, const void* z0,
                                       void* dq, int bh, int t, int dk, void* stream) {
  if (bh < 1 || t < 1 || dk < WDW || dk % WDW != 0 || gden == nullptr || !tma_ok(dq))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dq_wgmma(g, v, k, gden, s0, z0, dq, bh, t, dk,
                              static_cast<cudaStream_t>(stream));
}

// The wgmma route of causal_dot_rev_den: q, k, v, g, dk_out, dv_out [BH, T,
// 128] bf16, bases 16-byte aligned; gden, gsf, gzf, ds0, dz0 as
// causal_dot_rev_den. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for anything it does not take.
extern "C" int causal_dot_rev_den_wgmma(const void* q, const void* k, const void* v,
                                        const void* g, const void* gden, const void* gsf,
                                        const void* gzf, void* dk_out, void* dv_out, void* ds0,
                                        void* dz0, int bh, int t, void* stream) {
  if (bh < 1 || t < 1 || gden == nullptr || !tma_ok(dk_out) || !tma_ok(dv_out))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rev_wgmma(q, k, v, g, gden, gsf, gzf, dk_out, dv_out, ds0, dz0, bh, t,
                               static_cast<cudaStream_t>(stream));
}

// The wgmma route of causal_dot_rev: q, k, v, g [BH, T, 128] bf16, bases
// 16-byte aligned; gsf, dk_out, dv_out, ds0 as causal_dot_rev (fp32). Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue for
// anything it does not take.
extern "C" int causal_dot_rev_wgmma(const void* q, const void* k, const void* v, const void* g,
                                    const void* gsf, void* dk_out, void* dv_out, void* ds0,
                                    int bh, int t, void* stream) {
  if (bh < 1 || t < 1 || !tma_ok(dk_out) || !tma_ok(dv_out) || !tma_ok(ds0))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rev_raw_wgmma(q, k, v, g, gsf, dk_out, dv_out, ds0, bh, t,
                                   static_cast<cudaStream_t>(stream));
}
