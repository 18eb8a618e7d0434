// Fused normalized causal linear attention, backward, for Hopper (sm_90a):
// two kernels, one per pass of the TPU backward.
//
// Replaces, in orion_tpu/ops/pallas/causal_dot.py (glued by _fused_bwd_core):
//   - causal_dot_dq_den_kernel  <- _bwd_dq_den_kernel (launched by
//     _cdp_dq_den_flat), the forward-walking dq pass;
//   - causal_dot_rev_den_kernel <- _bwd_rev_core (launched by
//     _cdp_rev_den_flat), the reverse-walking dk / dv / dS0 / dz0 pass.
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
// Design. The TPU walks the chunks on a sequential grid axis with the state
// in VMEM scratch. Here one block owns one (b*h, 64-column tile of the
// output) and walks the chunks in a loop, with its state tile (128 x 64
// fp32, 32 KB) and z in shared memory: the forward kernel's shape
// (causal_dot_norm.cu). dk needs R's columns and dv needs R's rows, so the
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
//   dq pass:  reads g, v, k (100.7 MB) and gden (0.5 MB), writes dq (33.6
//             MB): 134.7 MB, 0.040 ms at 3.35 TB/s; 12.9 GFLOP, 0.013 ms
//             at the 989 TFLOP/s bf16 peak. Bound by bytes.
//   rev pass: reads q, k, v, g (134.2 MB) and gden, writes dk, dv (67.1 MB)
//             and dS0, dz0 (8.5 MB): 210 MB, 0.063 ms; 25.8 GFLOP, 0.026
//             ms. Bound by bytes.
// These kernels are not: like the forward they do their multiply-adds on
// the fp32 CUDA cores from shared memory, so shared-memory load issue bounds
// them. Tensor-core products (mma.sync / wgmma) and TMA loads are the route
// toward the byte bound (ROADMAP.md queue B, speed of what is ported).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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
template <typename T>
struct Walk {
  const T* x;
  const T* y;
  const T* w;
  const float* gd;   // the denominator's cotangent (dq, dk), else null
  const float* st0;  // initial state, null = zeros
  int st0_t;         // 1: st0 is [BH, dw, dx], read transposed; 0: [BH, dx, dw]
  const float* z0;   // [BH, dw] initial z, null = zeros
  T* out;
  float* st_out;     // [BH, dx, dw] final state, or null
  float* z_out;      // [BH, dw] final z, or null
  int dx, dw, n_tiles;
};

template <typename T, int ROLE>
__device__ __forceinline__ void walk(const Walk<T>& p, int bh, int tile, int t_len,
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
  for (int j = tid; j < DWT; j += NT) {
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
    if (tid < C) {
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
          if (ROLE == ROLE_DQ) v += gds[t];
          if (ROLE == ROLE_DK) v += gds[s];
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
            if (ROLE == ROLE_DQ) v = fmaf(gds[t], zs[col], v);
            if (ROLE == ROLE_DK) v += zs[col];
            p.out[w_base + (size_t)(c0 + t) * p.dw + j0 + col] = from_f<T>(v);
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
    if (ROLE != ROLE_DV && tid < DWT) {
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
  if (p.z_out != nullptr) {
    for (int j = tid; j < dwt; j += NT) p.z_out[(size_t)bh * p.dw + j0 + j] = zs[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_dq_den_kernel(Walk<T> p, int t_len) {
  extern __shared__ float smem[];
  walk<T, ROLE_DQ>(p, blockIdx.x / p.n_tiles, blockIdx.x % p.n_tiles, t_len, smem);
}

// blocks [0, bh * pk.n_tiles) make dk (and dz0); the rest make dv (and dS0)
template <typename T>
__global__ void __launch_bounds__(NT) causal_dot_rev_den_kernel(Walk<T> pk, Walk<T> pv,
                                                                int bh, int t_len) {
  extern __shared__ float smem[];
  const int nk = bh * pk.n_tiles;
  const int b = blockIdx.x;
  if (b < nk) {
    walk<T, ROLE_DK>(pk, b / pk.n_tiles, b % pk.n_tiles, t_len, smem);
  } else {
    walk<T, ROLE_DV>(pv, (b - nk) / pv.n_tiles, (b - nk) % pv.n_tiles, t_len, smem);
  }
}

template <typename T>
Walk<T> make_walk(const void* x, const void* y, const void* w, const void* gd,
                  const void* st0, int st0_t, const void* z0, void* out, void* st_out,
                  void* z_out, int dx, int dw) {
  Walk<T> p;
  p.x = static_cast<const T*>(x);
  p.y = static_cast<const T*>(y);
  p.w = static_cast<const T*>(w);
  p.gd = static_cast<const float*>(gd);
  p.st0 = static_cast<const float*>(st0);
  p.st0_t = st0_t;
  p.z0 = static_cast<const float*>(z0);
  p.out = static_cast<T*>(out);
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
  const Walk<T> p = make_walk<T>(g, v, k, gden, s0, 1, z0, dq, nullptr, nullptr, dv, dk);
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
  const Walk<T> pk =
      make_walk<T>(v, g, q, gden, gsf, 1, gzf, dk_out, nullptr, dz0, dv, dk);
  // dv: x = k, y = q [.., Dk]; w = g [.., Dv]; R^T = gsf as laid out, dS0 likewise
  const Walk<T> pv =
      make_walk<T>(k, q, g, nullptr, gsf, 0, nullptr, dv_out, ds0, nullptr, dk, dv);
  const long long blocks = (long long)bh * (pk.n_tiles + pv.n_tiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_dot_rev_den_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  causal_dot_rev_den_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(pk, pv, bh, t);
  return cudaGetLastError();
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
