// Int4 dequant-matmul for Hopper (sm_90a): decode's dense products against
// nibble-packed int4 weights.
//
// Replaces the TPU kernel orion_tpu/quant.py::_q4_matmul_kernel (launched by
// q4_matmul). It writes
//     y[b, j] = (sum_i x[b, i] * w[i, j]) * s[j]          (x's dtype)
// for x [B, d] (bf16 or fp32, B <= 64), the packed weight p [d/2, out] int8
// (packed row k holds w[2k, j] in its low nibble and w[2k + 1, j] in its high
// one, both signed, -8..7) and s [out] fp32: fp32 products and sums, the
// scale applied once, one rounding to the output dtype.
//
// Bound. Decode's products are GEMVs at B 4: each packed byte is read once
// and feeds 2 B products, so the weight bytes bound the call (lm_1b3's gate /
// up / down: 5.64 MB, 1.7 us at 3.35 TB/s; wq..wo 2.1 MB, 0.63 us). At those
// sizes a launch costs as much as the work.
//
// Design. A block owns a strip of 32 output channels and every row of x. Its
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
