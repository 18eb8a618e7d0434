// Fused normalized causal linear attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel orion_tpu/ops/pallas/causal_dot.py::_kernel_norm
// (launched by _cdpn_flat). For phi-mapped q, k [BH, T, Dk] and v [BH, T, Dv]
// (bf16 or fp32, contiguous) and an optional fp32 state (S0 [BH, Dk, Dv],
// z0 [BH, Dk]) it writes
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
// Design. On the TPU the chunk axis is a sequential grid axis and VMEM
// scratch carries S from one grid step to the next. Blocks on an H100 run
// in no order, so here one block owns one (b*h, 64-column tile of Dv) and
// walks the chunks of the sequence in a loop, with its S tile (Dk x 64 fp32,
// 32 KB) and z in shared memory for the whole walk. Per chunk of C tokens:
//   1. load q, k (C x Dk) and the v tile (C x 64) into shared memory as fp32;
//      rows past T are zeros, so the ragged tail needs no host padding;
//   2. A = q k^T, masked to s <= t and kept in fp32 (as _kernel_norm does);
//   3. den[t] = sum_s A[t, s] + q_t . z ;  num = A v + q S ;
//      out = num / (den + eps), written in the input dtype;
//   4. S += k^T v, z += sum_s k_s.
// Every tile of a (b*h) recomputes A and den: Dk*C extra multiply-adds per
// token, cheap beside the loads. All products accumulate in fp32 on the
// CUDA cores; bf16 products are exact in fp32, so the result matches the
// fp32 plain version up to summation order.
//
// C = 64: shared memory holds q, k (2 x 64 x 129 fp32), the v tile and the
// masked scores (64 x 65 each), S (128 x 64) and z: 132,864 bytes, above
// the 48 KB default, so the launcher raises the limit with
// cudaFuncSetAttribute. One block per SM; at B 4, H 16, Dv 128 the grid is
// 128 blocks on 132 SMs, one wave.
//
// Bound at B 4, H 16, T 1024, D 128, bf16, no initial state: the kernel must
// read q, k, v (50.3 MB) and write out (16.8 MB) and S (4.2 MB): 71.3 MB,
// 21.3 us at 3.35 TB/s. Its arithmetic is 6.4 GFLOP (C = 64, with the full
// C x C score block), 6.5 us at the 989 TFLOP/s bf16 tensor-core peak. So the
// function is bound by bytes. This kernel is not: it does its 3.2 G
// multiply-adds on the fp32 CUDA cores, fed from shared memory with a 4 x 4
// (4 x 8 for the state update) register tile per thread, so shared-memory
// load issue limits it. Moving the four products onto mma.sync / wgmma and
// the loads onto TMA with a pipelined producer is the work that brings it
// toward the byte bound (ROADMAP.md queue B).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_norm_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ s0, const float* __restrict__ z0,
    T* __restrict__ out, float* __restrict__ sf, float* __restrict__ zf,
    float* __restrict__ num_out, float* __restrict__ den_out,
    int t_len, int dk, int dv, int n_tiles, float eps) {
  extern __shared__ float smem[];
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
  for (int d = tid; d < DK_MAX; d += NT) {
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
    {
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

    // 3c. epilogue: the division, in the input dtype; for training also
    // the fp32 numerator (every tile) and denominator (tile 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, col = tx + 16 * j;
        if (t < rows && col < dvt) {
          const size_t o = v_base + (size_t)(c0 + t) * dv + j0 + col;
          out[o] = from_f<T>(num[i][j] / (dens[t] + eps));
          if (num_out != nullptr) num_out[o] = num[i][j];
        }
      }
    if (den_out != nullptr && tile == 0 && tid < rows) {
      den_out[(size_t)bh * t_len + c0 + tid] = dens[tid];
    }

    // 4. S += k^T v (rows ty + 16i of S, columns tx + 16j), z += sum_s k_s
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
    if (tid < dk) {
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
  if (tile == 0) {
    for (int d = tid; d < dk; d += NT) zf[(size_t)bh * dk + d] = zs[d];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* s0,
                   const float* z0, void* out, float* sf, float* zf, float* num,
                   float* den, int bh, int t, int dk, int dv, float eps,
                   cudaStream_t stream) {
  const int n_tiles = (dv + DVT - 1) / DVT;
  const long long blocks = (long long)bh * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_dot_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  causal_dot_norm_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      s0, z0, static_cast<T*>(out), sf, zf, num, den, t, dk, dv, n_tiles, eps);
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
                                      dk, dv, eps, st)
              : launch<float>(q, k, v, s0f, z0f, out, sff, zff, numf, denf, bh, t, dk, dv,
                              eps, st);
  return (int)err;
}
