// Fused Adafactor for Hopper (sm_90a): the three streaming passes over a
// factored fp32 weight matrix and its gradient.
//
// Replaces three TPU kernels of orion_tpu/ops/pallas/adafactor.py:
//
//   adafactor_sums  <- _sums_kernel  (launched by _pallas_sums):
//       q = g * g * s2 + eps;  sum0[j] = sum_i q[i, j],  sum1[i] = sum_j q[i, j]
//   adafactor_rms   <- _rms_kernel   (launched by _pallas_rms):
//       sum_u2 = sum_ij (g[i, j] * r[i] * c[j])^2
//   adafactor_apply <- _apply_kernel (launched by _pallas_apply):
//       p[i, j] += g[i, j] * r[i] * c[j]  if *flag != 0, in place; with the
//       flag 0 nothing is written and p stays bitwise as it was
//
// for g, p [m, n] fp32 (row-major), r [m], c [n] fp32; s2 (the caller's
// clip-and-guard scale, squared) and the flag are read from device memory,
// so a step never waits for the host. Products and sums round as the plain
// versions write them ((g * g) * s2 + eps; (g * r) * c; p + u), with
// __fmul_rn / __fadd_rn so that the compiler contracts nothing into an FMA.
//
// Bound. Bytes: G is read three times and P read and written once, 20 bytes
// an element (lm_1b3's 170 factored matrices: 1.28 G elements, 25.7 GB a
// step, 7.7 ms at 3.35 TB/s).
//
// Design. The TPU kernels carry the axis-0 sums and the squared sum across
// a sequential grid; here blocks run in no order, and no atomics are used
// (the sums would change with the blocks' order, and a resumed run would
// not be bitwise the uninterrupted one). Each pass tiles the matrix into
// 1024-column strips x row chunks (about two blocks per SM; ``tiling``
// below, the one place that chooses it). In a block,
// warp w takes rows w, w + 8, ... of its chunk; a lane takes columns
// 4 lane + 128 k (k < 8) of the strip, as float4 loads where n % 4 == 0 (else
// one float at a time), so a warp reads 512 contiguous bytes per load.
//   - sums: a row's sum is reduced across the warp (fixed butterfly) and
//     written as the strip's partial; each lane keeps its columns' sums over
//     the warp's rows in registers, and the 8 warps' column sums are added in
//     warp order into the chunk's partial. A second launch adds the strips'
//     row partials and the chunks' column partials, each in index order,
//     into one output [sum0 (n) | sum1 (m)].
//   - rms: each block's squared sum (lanes, warp butterfly, warps in order)
//     into a partial; a second one-block launch adds the partials in a fixed
//     order.
//   - apply: the same tiling, elementwise; the flag is read first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;          // threads per block: 8 warps
constexpr int WARPS = NT / 32;
constexpr int CT = 1024;         // columns per strip
constexpr int KV = CT / 128;     // float4 groups per lane per row
constexpr int TARGET_BLOCKS = 264;  // about two blocks per SM of an H100

// Columns c..c+3 of a row (zeros past n).
__device__ __forceinline__ void load4(const float* __restrict__ row, int c, int n, int vec,
                                      float (&v)[4]) {
  if (vec && c + 3 < n) {
    const float4 t = *reinterpret_cast<const float4*>(row + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (c + i < n) ? row[c + i] : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass A, tiles: rowpart [n_ct, m] (each strip's row sums), colpart [n_rc, n]
// (each chunk's column sums).
__global__ void __launch_bounds__(NT) af_sums_tile(
    const float* __restrict__ g, const float* __restrict__ s2p, float eps,
    float* __restrict__ rowpart, float* __restrict__ colpart, int m, int n, int rows_per_chunk,
    int vec) {
  __shared__ float cs[WARPS][CT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CT;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(m, r_begin + rows_per_chunk);
  const float s2 = *s2p;
  float col[KV][4];
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) col[k][i] = 0.f;

  for (int r = r_begin + warp; r < r_end; r += WARPS) {
    const float* row = g + (size_t)r * n;
    float v[KV][4];
#pragma unroll
    for (int k = 0; k < KV; ++k) load4(row, c0 + 128 * k + 4 * lane, n, vec, v[k]);
    float rs = 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c0 + 128 * k + 4 * lane + i < n) {
          const float q = __fadd_rn(__fmul_rn(__fmul_rn(v[k][i], v[k][i]), s2), eps);
          rs += q;
          col[k][i] += q;
        }
      }
    rs = warp_sum(rs);
    if (lane == 0) rowpart[(size_t)blockIdx.x * m + r] = rs;
  }
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) cs[warp][128 * k + 4 * lane + i] = col[k][i];
  __syncthreads();
  for (int c = threadIdx.x; c < CT && c0 + c < n; c += NT) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += cs[w][c];
    colpart[(size_t)blockIdx.y * n + c0 + c] = t;
  }
}

// Pass A, second launch: sums = [sum0 (n) | sum1 (m)].
__global__ void __launch_bounds__(NT) af_sums_finalize(
    const float* __restrict__ rowpart, const float* __restrict__ colpart, float* __restrict__ sums,
    int m, int n, int n_ct, int n_rc) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < m) {
    float t = 0.f;
    for (int ct = 0; ct < n_ct; ++ct) t += rowpart[(size_t)ct * m + i];
    sums[n + i] = t;
  } else if (i < m + n) {
    const int j = i - m;
    float t = 0.f;
    for (int rc = 0; rc < n_rc; ++rc) t += colpart[(size_t)rc * n + j];
    sums[j] = t;
  }
}

// Pass B, tiles: partial[rc * n_ct + ct] = the tile's sum of (g r c)^2.
__global__ void __launch_bounds__(NT) af_rms_tile(
    const float* __restrict__ g, const float* __restrict__ r, const float* __restrict__ c,
    float* __restrict__ partial, int m, int n, int rows_per_chunk, int vec) {
  __shared__ float ws[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CT;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(m, r_begin + rows_per_chunk);
  float cv[KV][4];
#pragma unroll
  for (int k = 0; k < KV; ++k) load4(c, c0 + 128 * k + 4 * lane, n, 0, cv[k]);
  float acc = 0.f;
  for (int row_i = r_begin + warp; row_i < r_end; row_i += WARPS) {
    const float* row = g + (size_t)row_i * n;
    const float rr = r[row_i];
    float v[KV][4];
#pragma unroll
    for (int k = 0; k < KV; ++k) load4(row, c0 + 128 * k + 4 * lane, n, vec, v[k]);
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = __fmul_rn(__fmul_rn(v[k][i], rr), cv[k][i]);  // 0 past n
        acc = __fadd_rn(acc, __fmul_rn(u, u));
      }
  }
  acc = warp_sum(acc);
  if (lane == 0) ws[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += ws[w];
    partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

// Pass B, second launch: out[0] = the partials' sum, in a fixed order.
__global__ void __launch_bounds__(NT) af_rms_finalize(const float* __restrict__ partial,
                                                      int count, float* __restrict__ out) {
  __shared__ float sh[NT];
  float t = 0.f;
  for (int i = threadIdx.x; i < count; i += NT) t += partial[i];
  sh[threadIdx.x] = t;
  __syncthreads();
  for (int half = NT / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

// Pass C: p += g r c in place, unless *flag == 0.
__global__ void __launch_bounds__(NT) af_apply_tile(
    const float* __restrict__ g, float* __restrict__ p, const float* __restrict__ r,
    const float* __restrict__ c, const int* __restrict__ flag, int m, int n, int rows_per_chunk,
    int vec) {
  if (*flag == 0) return;  // a non-finite step: p stays as it was
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CT;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(m, r_begin + rows_per_chunk);
  float cv[KV][4];
#pragma unroll
  for (int k = 0; k < KV; ++k) load4(c, c0 + 128 * k + 4 * lane, n, 0, cv[k]);
  for (int row_i = r_begin + warp; row_i < r_end; row_i += WARPS) {
    const float rr = r[row_i];
    const float* grow = g + (size_t)row_i * n;
    float* prow = p + (size_t)row_i * n;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int cc = c0 + 128 * k + 4 * lane;
      if (cc >= n) break;
      float gv[4], pv[4];
      load4(grow, cc, n, vec, gv);
      load4(prow, cc, n, vec, pv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = __fadd_rn(pv[i], __fmul_rn(__fmul_rn(gv[i], rr), cv[k][i]));
      if (vec && cc + 3 < n) {
        *reinterpret_cast<float4*>(prow + cc) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cc + i < n) prow[cc + i] = pv[i];
      }
    }
  }
}

// The tiling of an [m, n] matrix: n_ct = ceil(n / CT) column strips and
// n_rc row chunks of rows_per_chunk rows, about TARGET_BLOCKS blocks in all,
// every chunk at least 8 rows (one a warp).
struct Tiling {
  int n_ct, n_rc, rows_per_chunk;
};

Tiling tiling(int m, int n) {
  const int n_ct = (n + CT - 1) / CT;
  const int n_rc = std::max(1, std::min((TARGET_BLOCKS + n_ct - 1) / n_ct, (m + 7) / 8));
  const int rows = (m + n_rc - 1) / n_rc;
  return {n_ct, (m + rows - 1) / rows, rows};
}

}  // namespace

// The tiling, for the wrapper to size the scratch: out[0..2] = n_ct, n_rc,
// rows_per_chunk. The passes take the same tiling themselves. vec below: n % 4
// == 0 and g (and p) 16-byte aligned. Each pass returns the cudaError_t of its
// launches (0 on success).
extern "C" int adafactor_tiling(int m, int n, int* out) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(m, n);
  out[0] = t.n_ct;
  out[1] = t.n_rc;
  out[2] = t.rows_per_chunk;
  return 0;
}

// g [m, n], s2 [1]; scratch rowpart [n_ct * m], colpart [n_rc * n]; out sums
// [n + m] = [axis-0 sums | axis-1 sums].
extern "C" int adafactor_sums(const void* g, const void* s2, float eps, void* rowpart,
                              void* colpart, void* sums, int m, int n, int vec, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(m, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rp = static_cast<float*>(rowpart);
  float* cp = static_cast<float*>(colpart);
  af_sums_tile<<<dim3(t.n_ct, t.n_rc), NT, 0, st>>>(static_cast<const float*>(g),
                                                     static_cast<const float*>(s2), eps, rp, cp,
                                                     m, n, t.rows_per_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  af_sums_finalize<<<(m + n + NT - 1) / NT, NT, 0, st>>>(rp, cp, static_cast<float*>(sums), m, n,
                                                        t.n_ct, t.n_rc);
  return (int)cudaGetLastError();
}

// g [m, n], r [m], c [n]; scratch partial [n_ct * n_rc]; out [1].
extern "C" int adafactor_rms(const void* g, const void* r, const void* c, void* partial,
                             void* out, int m, int n, int vec, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(m, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  af_rms_tile<<<dim3(t.n_ct, t.n_rc), NT, 0, st>>>(static_cast<const float*>(g),
                                                    static_cast<const float*>(r),
                                                    static_cast<const float*>(c), part, m, n,
                                                    t.rows_per_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  af_rms_finalize<<<1, NT, 0, st>>>(part, t.n_ct * t.n_rc, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// g, p [m, n] (p updated in place), r [m], c [n], flag [1] int32.
extern "C" int adafactor_apply(const void* g, void* p, const void* r, const void* c,
                               const void* flag, int m, int n, int vec, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(m, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  af_apply_tile<<<dim3(t.n_ct, t.n_rc), NT, 0, st>>>(
      static_cast<const float*>(g), static_cast<float*>(p), static_cast<const float*>(r),
      static_cast<const float*>(c), static_cast<const int*>(flag), m, n, t.rows_per_chunk, vec);
  return (int)cudaGetLastError();
}
