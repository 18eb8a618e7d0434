// Flash attention, backward, for Hopper (sm_90a): two kernels, one per pass
// of the TPU backward.
//
// Replaces, in orion_tpu/ops/pallas/flash_attention.py (both launched by
// _flash_bwd_flat):
//   - flash_dq_kernel  <- _dq_kernel, the dq pass;
//   - flash_dkv_kernel <- _dkv_kernel, the dk / dv pass.
//
// With q [BH, Tq, D], k, v [BH, Tk, D], the output's cotangent g [BH, Tq, D]
// (cast to the input dtype), the forward's lse and delta = rowsum(g . out)
// (minus the lse's cotangent, when it has one), both fp32 [BH, Tq]:
//
//   P[t, s]  = exp(scale q_t . k_s - lse_t) where row t sees key s, else 0
//   dS[t, s] = P[t, s] (g_t . v_s - delta_t) scale
//   dq = dS k,   dk = dS^T q,   dv = P^T g                    (input dtype)
//
// with the mask of the forward (flash_attention.cu): s < Tk, s <= t when
// causal, t - s < window when banded. P is recomputed from lse, so no T x T
// matrix is kept between the passes.
//
// Design. On the TPU each pass carries its fp32 accumulator in VMEM scratch
// across a sequential grid axis. Here a loop inside the block replaces that
// axis, and the accumulators stay in registers:
//   - dq: one block per (b*h, 64-row q tile), looping over the k tiles of the
//     band, from max(0, q0 - w + 1) / 64 to (q0 + 63) / 64, as the forward;
//     per tile S, P, dP = g v^T and dS in registers, dS through shared memory
//     into dq += dS k.
//   - dk, dv: one block per (b*h, 64-row k tile), looping over the q tiles
//     of its band, from k0 / 64 to (k0 + 63 + w - 1) / 64; per tile the
//     transposed S^T = k q^T and dP^T = v g^T (k-major, so no transposes),
//     P^T and dS^T through shared memory into dv += P^T g and dk += dS^T q.
//     Each block owns its k rows, so the sums need no atomics.
// All products accumulate in fp32 on the CUDA cores; bf16 products are exact
// in fp32. 256 threads as a 16 x 16 grid: a thread owns rows ty + 16i
// (i < 4) of its block's tile, tile columns tx + 16j (j < 4) and output
// columns tx + 16j (j < 8).
//
// Shared memory: dq keeps q, g, k, v (4 x 64 x 129 fp32) and dS (64 x 65):
// 148,736 bytes; dk/dv keeps k, v, q, g (4 x 64 x 129), P^T and dS^T (2 x 64
// x 65), lse and delta: 165,888 bytes. Both above the 48 KB default, so the
// launchers raise the limit with cudaFuncSetAttribute. One block per SM.
//
// Bound at the hybrid_1b3 training shape (B 8, H 16, T 2048, D 128, w 1024,
// bf16): 201.4 M (q, k) pairs.
//   dq:    q k^T, g v^T and dS k, 6 D = 768 operations a pair: 154.7 GFLOP,
//          0.156 ms at 989 TFLOP/s; it reads q, k, v, g (268.4 MB) and lse,
//          delta (2.1 MB) and writes dq (67.1 MB): 337.6 MB, 0.101 ms.
//   dk/dv: q k^T, g v^T, P^T g and dS^T q, 8 D = 1024 a pair: 206.2 GFLOP,
//          0.209 ms; reads the same 270.5 MB, writes dk, dv (134.2 MB):
//          404.8 MB, 0.121 ms.
// Both are bound by operations, and only tensor cores reach that bound. These
// kernels do their multiply-adds on the fp32 CUDA cores, fed from shared
// memory, so shared-memory load issue limits them. What the design does about
// the bound: no tile outside the band is computed and no T x T matrix goes to
// device memory; mma.sync / wgmma and TMA loads are the route toward it
// (ROADMAP.md queue B).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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
                                     int window) {
  return row < t_q && col < t_k && (!causal || row >= col) &&
         (window <= 0 || row - col < window);
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
    int window) {
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

  int lo = 0, hi = (t_k - 1) / BK;
  if (window > 0) lo = max(0, q0 - window + 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK);

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
            sees(row, col, t_q, t_k, causal, window) ? expf(s[i][j] * scale - lr[i]) : 0.f;
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
    int causal, int window) {
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

  // the band of query tiles that see this k tile
  int lo = causal ? k0 / BQ : 0;
  int hi = (t_q - 1) / BQ;
  if (window > 0) hi = min(hi, (k0 + BK - 1 + window - 1) / BQ);

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
        const float p = sees(row, col, t_q, t_k, causal, window)
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
                      int t_k, int d, float scale, int causal, int window,
                      cudaStream_t stream) {
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
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int t_q, int t_k, int d, float scale, int causal, int window,
                       cudaStream_t stream) {
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
      t_k, d, n_kt, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, g, dq [BH, Tq, D], k, v, dk, dv [BH, Tk, D]: bf16 when is_bf16 else
// fp32. lse, delta [BH, Tq] fp32. window <= 0: no window. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dq, int bh,
                                  int t_q, int t_k, int d, int is_bf16, float scale,
                                  int causal, int window, void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX) return (int)cudaErrorInvalidValue;
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, g, lsef, deltaf, dq, bh, t_q, t_k, d,
                                         scale, causal, window, st)
              : launch_dq<float>(q, k, v, g, lsef, deltaf, dq, bh, t_q, t_k, d, scale,
                                 causal, window, st);
  return (int)err;
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int t_q, int t_k, int d, int is_bf16, float scale,
                                   int causal, int window, void* stream) {
  if (bh < 1 || t_q < 1 || t_k < 1 || d < 1 || d > D_MAX) return (int)cudaErrorInvalidValue;
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, g, lsef, deltaf, dk, dv, bh, t_q, t_k, d,
                                          scale, causal, window, st)
              : launch_dkv<float>(q, k, v, g, lsef, deltaf, dk, dv, bh, t_q, t_k, d, scale,
                                  causal, window, st);
  return (int)err;
}
