// Flash attention, forward, for Hopper (sm_90a): causal, bidirectional or
// banded (sliding-window) online-softmax attention.
//
// Replaces the TPU kernel orion_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_flat). For q [BH, Tq, D], k, v [BH, Tk, D] (bf16 or
// fp32, contiguous, D <= 128) it writes
//
//     out[t] = sum_s P[t, s] v_s                      (input dtype)
//     lse[t] = m_t + log(l_t)                         (fp32 [BH, Tq])
//     P[t, s] = exp(scale q_t . k_s - m_t) / l_t over the keys s that row t
//               sees: s < Tk, s <= t when causal, t - s < window when banded
//
// with m_t the row's largest score and l_t its sum of exp. A row that sees
// no key writes out 0 and lse -1e30 (the TPU kernel's `safe` division).
//
// Design. On the TPU the key axis is a sequential grid axis and VMEM scratch
// carries m, l and the accumulator from one grid step to the next. Blocks on
// an H100 run in no order, so here one block owns one (b*h, 64-row q tile)
// and loops over the 64-row k/v tiles itself, with m, l and its slice of the
// accumulator in registers for the whole loop. With a window the loop runs
// only over the tiles of the band, from max(0, q0 - w + 1) / 64 to
// (q0 + 63) / 64: the banded grid of _banded_ok, which on the TPU is a
// BlockSpec index map. So sliding-window attention costs O(T w), not O(T^2).
// Per k tile:
//   1. load the k and v tiles into shared memory as fp32 (zeros past Tk);
//   2. S = scale q k^T (64 x 64), masked by a select to -1e30;
//   3. m' = max(m, rowmax S); alpha = exp(m - m'); P = exp(S - m') on the
//      kept entries, 0 elsewhere; l = alpha l + rowsum P; acc = alpha acc;
//   4. acc += P v, with P kept in fp32 as _fwd_kernel does (rounding P to
//      bf16 would cost more than one bf16 step of the output).
// The epilogue divides by l (1 where l = 0) and writes out and lse. All
// products accumulate in fp32 on the CUDA cores; bf16 products are exact in
// fp32, so the result matches the fp32 plain version up to summation order.
// 256 threads as a 16 x 16 grid: a thread owns rows ty + 16i (i < 4), score
// columns tx + 16j (j < 4) and output columns tx + 16j (j < 8); the 16
// threads of a row are 16 neighbouring lanes, so the row max and sum are
// shuffles within a half warp.
//
// Shared memory: q, k (2 x 64 x 129 fp32), v (64 x 128) and P (64 x 65):
// 115,456 bytes, above the 48 KB default, so the launcher raises the limit
// with cudaFuncSetAttribute. One block per SM.
//
// Bound. Row t of a causal band of width w sees min(t + 1, w) keys. At the
// hybrid_1b3 training shape (B 8, H 16, T 2048, D 128, w 1024, bf16) that is
// 201.4 M (q, k) pairs; q k^T and P v cost 4 D = 512 operations a pair:
// 103.1 GFLOP, 0.104 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// q, k, v read and out, lse written, 269.5 MB or 0.080 ms at 3.35 TB/s. At
// the generate shape (B 4, T 1536) it is 67.1 M pairs, 34.4 GFLOP (0.035 ms)
// against 101.2 MB (0.030 ms). Both are bound by operations, and only
// tensor cores reach that bound. This kernel does its multiply-adds on the
// fp32 CUDA cores (67 TFLOP/s at most), fed from shared memory with a 4 x 4
// (4 x 8 for P v) register tile a thread, so shared-memory load issue limits
// it. What the design does about the bound: it never computes a tile outside
// the band, and never writes the T x T scores to device memory. Moving the
// two products onto mma.sync / wgmma, with the loads on TMA, is the work
// that brings it toward the bound (ROADMAP.md queue B).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ bool sees(int row, int col, int t_k, int causal, int window) {
  return col < t_k && (!causal || row >= col) && (window <= 0 || row - col < window);
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
    int t_q, int t_k, int d, int n_qt, float scale, int causal, int window) {
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

  // the band of key tiles this q tile sees
  int lo = 0, hi = (t_k - 1) / BK;
  if (window > 0) lo = max(0, q0 - window + 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK);

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
        keep[j] = sees(row, k0 + tx + 16 * j, t_k, causal, window);
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
                   cudaStream_t stream) {
  const int n_qt = (t_q + BQ - 1) / BQ;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_q, t_k, d, n_qt, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Tq, D], k, v [BH, Tk, D], out [BH, Tq, D]: bf16 when is_bf16 else
// fp32. lse [BH, Tq] fp32. window <= 0: no window. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int t_q, int t_k, int d, int is_bf16,
                                   float scale, int causal, int window, void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX) return (int)cudaErrorInvalidValue;
  float* lsef = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, lsef, bh, t_q, t_k, d, scale, causal,
                                      window, st)
              : launch<float>(q, k, v, out, lsef, bh, t_q, t_k, d, scale, causal, window, st);
  return (int)err;
}
