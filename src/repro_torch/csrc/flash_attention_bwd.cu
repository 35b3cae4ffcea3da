// Gradient of attention softmax(q k^T * scale) v over grouped KV heads.
//
// Replaces the XLA custom VJP `_flash_bwd` of
// src/repro/models/attention.py (no Pallas kernel there: the TPU runs it
// as XLA ops), the backward of repro.models.attention.blocked_attention.
// For batch b, KV head kh, query head n = kh * G + g, query row i at
// position i + q_offset, with the forward's output o (in the inputs'
// dtype), its log-sum-exp lse (f32) and the cotangent do:
//   D_i   = sum_d do_id o_id                      (f32)
//   s_ij  = bf(q_i * scale) . k_j                 (f32 sum; bf = round to
//                                                  the inputs' dtype)
//   p_ij  = exp(s_ij - lse_i), 0 where causal and j > i + q_offset
//   dv_j  = sum_(n,i) bf(p_ij) do_i
//   dp_ij = do_i . v_j
//   ds_ij = bf(p_ij (dp_ij - D_i))
//   dq_i  = (sum_j ds_ij k_j) * scale              (scale not rounded)
//   dk_j  = sum_(n,i) ds_ij bf(q_i * scale)
// dk and dv sum over the G query heads of their KV head.  Every product
// and sum is f32 on the fp32 CUDA cores; for bf16 inputs every operand
// of a product is a bf16 value, as in the JAX code, so each product is
// exact and only the order of the f32 sums differs.
//
// Layout: q, o, do and dq (B, Sq, K*G, h); k, v, dk and dv (B, Sk, K, h);
// lse and D (B, K*G, Sq) f32.  All read in place.
//
// What bounds it on an H100: at the training shape (S = 4096, h = 128)
// the five products are 10 S^2 H h / 2 FLOPs against ~10 S H h elements
// of traffic, far above the ridge: operations.  This first version is
// the simple one the port starts from: products on the fp32 cores (67
// TFLOP/s), not the tensor cores.  Two kernels, no atomics, so two
// launches on the same inputs give bit-equal gradients:
//
// flash_bwd_dq: a block of 256 threads per (b, query head, 64 query
//   rows).  Its prologue forms D for its rows (written out for the
//   other kernel); then it walks the 64-key tiles of k and v the rows
//   can see (a causal block stops at its last query's position),
//   recomputes p and dp, and accumulates dq = ds k in registers.
// flash_bwd_dkdv: a block of 256 threads per (b, KV head, 64 keys),
//   launched after flash_bwd_dq on the same stream.  It keeps its k and
//   v tiles in shared memory and dk, dv in registers, and walks the
//   64-row query tiles of all G heads that can see its keys (causal:
//   from the first row whose position reaches the tile), recomputing p,
//   dp and ds for each.
// Each thread holds a 4 x 4 block of a 64 x 64 score tile (rows
// ty + 16 i, keys tx + 16 j) and a 4 x h/16 block of a 64 x h output.
// Tiles live in shared memory as f32 (bf16 widened on load), rows
// padded by 4 floats so the float4 reads along h hit distinct banks.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 row groups (ty) x 16 column groups (tx)
constexpr int LP = BK + 4;      // row stride of the p and ds tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the identity for float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// column of a thread's t-th output element in a row of HD: float4 groups
// 4 tx + 64 c for HD >= 64, single columns tx + 16 t below
template <int HD>
__device__ __forceinline__ int col_of(int tx, int t) {
  if constexpr (HD >= 64) {
    return 64 * (t / 4) + 4 * tx + (t % 4);
  } else {
    return tx + 16 * t;
  }
}

// rows r0.. of a (rows, HD) tile at row stride `stride` elements into
// shared memory at row stride HD + 4; rows at or past `n` are zero; with
// `scaled`, each value times `mul` rounded to T (q * scale)
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int r0, int n,
                                          float mul, bool scaled) {
  constexpr int LD = HD + 4;
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r0 + r < n) {
      x = to_f(src[(size_t)(r0 + r) * stride + d]);
      if (scaled) x = round_to<T>(x * mul);
    }
    dst[r * LD + d] = x;
  }
}

// acc[i][j] = a_(ty + 16 i) . b_(tx + 16 j) over HD: rows of two tiles
// at stride HD + 4
template <int HD>
__device__ __forceinline__ void nt_product(float (&acc)[4][4],
                                           const float* a, const float* b,
                                           int ty, int tx) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                     av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][t] += sum_r w[r][ty + 16 i] x[r][col_of(tx, t)] over the 64 rows
// r of w (stride LP: w is stored [query][key], read transposed) and x
// (stride HD + 4): dv += p^T do, dk += ds^T q
template <int HD>
__device__ __forceinline__ void tn_product(float (&acc)[4][HD / 16],
                                           const float* w, const float* x,
                                           int ty, int tx) {
  constexpr int LD = HD + 4;
#pragma unroll 2
  for (int r = 0; r < 64; ++r) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = w[r * LP + ty + 16 * i];
    const float* xr = x + r * LD;
    if constexpr (HD >= 64) {
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&xr[64 * c + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] += a[i] * v.x;
          acc[i][4 * c + 1] += a[i] * v.y;
          acc[i][4 * c + 2] += a[i] * v.z;
          acc[i][4 * c + 3] += a[i] * v.w;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < HD / 16; ++t) {
        const float v = xr[col_of<HD>(tx, t)];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][t] += a[i] * v;
      }
    }
  }
}

// acc[i][t] += sum_j w[ty + 16 i][j] x[j][col_of(tx, t)] over the 64 keys
// j: dq += ds k
template <int HD>
__device__ __forceinline__ void nn_product(float (&acc)[4][HD / 16],
                                           const float* w, const float* x,
                                           int ty, int tx) {
  constexpr int LD = HD + 4;
#pragma unroll 2
  for (int j = 0; j < 64; ++j) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = w[(ty + 16 * i) * LP + j];
    const float* xr = x + j * LD;
    if constexpr (HD >= 64) {
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&xr[64 * c + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] += a[i] * v.x;
          acc[i][4 * c + 1] += a[i] * v.y;
          acc[i][4 * c + 2] += a[i] * v.z;
          acc[i][4 * c + 3] += a[i] * v.w;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < HD / 16; ++t) {
        const float v = xr[col_of<HD>(tx, t)];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][t] += a[i] * v;
      }
    }
  }
}

// whether score (row, key) of a tile takes part: both exist, and the key
// is not after the row's position when causal
__device__ __forceinline__ bool live(int row, int key, int Sq, int Sk,
                                     int causal, int q_offset) {
  return row < Sq && key < Sk && !(causal && key > row + q_offset);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * 64 * (HD + 4) + BQ * LP + 2 * BQ) * sizeof(float);
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return (size_t)(4 * 64 * (HD + 4) + 2 * BQ * LP + 2 * BQ) * sizeof(float);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ dsum, T* __restrict__ dq, int Sq, int Sk,
             int K, int G, int causal, int q_offset, float scale,
             float dq_scale) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // BQ x LD, q * scale rounded to T
  float* dos = qs + BQ * LD;     // BQ x LD
  float* ks = dos + BQ * LD;     // BK x LD
  float* vs = ks + BK * LD;      // BK x LD
  float* dss = vs + BK * LD;     // BQ x LP, ds rounded to T
  float* rl = dss + BQ * LP;     // BQ: lse
  float* rd = rl + BQ;           // BQ: D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y, b = blockIdx.z;
  const int H = K * G, kh = head / G;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)K * HD;
  const size_t qoff = (size_t)b * Sq * q_stride + (size_t)head * HD;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  const size_t roff = ((size_t)b * H + head) * Sq;

  load_tile<HD, T>(qs, q + qoff, q_stride, i0, Sq, scale, true);
  load_tile<HD, T>(dos, dout + qoff, q_stride, i0, Sq, 1.f, false);
  __syncthreads();

  // D for rows ty + 16 i: 16 lanes per row, then a half-warp sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (i0 + r < Sq) {
      const T* orow = o + qoff + (size_t)(i0 + r) * q_stride;
      for (int d = tx; d < HD; d += 16) part += dos[r * LD + d] * to_f(orow[d]);
    }
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0) {
      rd[r] = part;
      rl[r] = i0 + r < Sq ? lse[roff + i0 + r] : 0.f;
      if (i0 + r < Sq) dsum[roff + i0 + r] = part;
    }
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;

  // keys past the tile's last query position are masked for every row
  const int kv_end = causal ? min(Sk, min(i0 + BQ, Sq) + q_offset) : Sk;
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous tile's ks, vs and dss are consumed
    load_tile<HD, T>(ks, kb, kv_stride, j0, Sk, 1.f, false);
    load_tile<HD, T>(vs, vb, kv_stride, j0, Sk, 1.f, false);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<HD>(s, qs, ks, ty, tx);
    nt_product<HD>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (live(i0 + r, j0 + c, Sq, Sk, causal, q_offset)) {
          const float p = expf(s[i][j] - rl[r]);
          ds = round_to<T>(p * (dp[i][j] - rd[r]));
        }
        dss[r * LP + c] = ds;
      }
    }
    __syncthreads();
    nn_product<HD>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* drow = dq + qoff + (size_t)row * q_stride;
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      drow[col_of<HD>(tx, t)] = from_f<T>(acc[i][t] * dq_scale);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ dsum, T* __restrict__ dk,
               T* __restrict__ dv, int Sq, int Sk, int K, int G, int causal,
               int q_offset, float scale) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // BK x LD
  float* vs = ks + BK * LD;      // BK x LD
  float* qs = vs + BK * LD;      // BQ x LD, q * scale rounded to T
  float* dos = qs + BQ * LD;     // BQ x LD
  float* ps = dos + BQ * LD;     // BQ x LP, p rounded to T
  float* dss = ps + BQ * LP;     // BQ x LP, ds rounded to T
  float* rl = dss + BQ * LP;     // BQ: lse
  float* rd = rl + BQ;           // BQ: D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int H = K * G;
  const int j0 = blockIdx.x * BK;  // causal: the first key tiles see most
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)K * HD;
  const size_t kvoff = (size_t)b * Sk * kv_stride + (size_t)kh * HD;

  load_tile<HD, T>(ks, k + kvoff, kv_stride, j0, Sk, 1.f, false);
  load_tile<HD, T>(vs, v + kvoff, kv_stride, j0, Sk, 1.f, false);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) dka[i][t] = dva[i][t] = 0.f;

  // rows before the first that can see key j0 add exact zeros
  const int i_first = causal ? max(0, j0 - q_offset) / BQ * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int head = kh * G + g;
    const size_t qoff = (size_t)b * Sq * q_stride + (size_t)head * HD;
    const size_t roff = ((size_t)b * H + head) * Sq;
    for (int i0 = i_first; i0 < Sq; i0 += BQ) {
      __syncthreads();  // the previous tile's qs, dos, ps and dss are consumed
      load_tile<HD, T>(qs, q + qoff, q_stride, i0, Sq, scale, true);
      load_tile<HD, T>(dos, dout + qoff, q_stride, i0, Sq, 1.f, false);
      if (tid < BQ) {
        const bool in = i0 + tid < Sq;
        rl[tid] = in ? lse[roff + i0 + tid] : 0.f;
        rd[tid] = in ? dsum[roff + i0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      nt_product<HD>(s, qs, ks, ty, tx);
      nt_product<HD>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f;
          if (live(i0 + r, j0 + c, Sq, Sk, causal, q_offset))
            p = expf(s[i][j] - rl[r]);
          ps[r * LP + c] = round_to<T>(p);
          dss[r * LP + c] = round_to<T>(p * (dp[i][j] - rd[r]));
        }
      }
      __syncthreads();
      tn_product<HD>(dva, ps, dos, ty, tx);
      tn_product<HD>(dka, dss, qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + ty + 16 * i;
    if (key >= Sk) continue;
    T* krow = dk + kvoff + (size_t)key * kv_stride;
    T* vrow = dv + kvoff + (size_t)key * kv_stride;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      krow[col_of<HD>(tx, t)] = from_f<T>(dka[i][t]);
      vrow[col_of<HD>(tx, t)] = from_f<T>(dva[i][t]);
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int K, int G, int causal,
           int q_offset, float scale, float dq_scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<HD>();
  constexpr size_t smem_kv = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dst = static_cast<float*>(dsum);
  const dim3 grid_q((Sq + BQ - 1) / BQ, K * G, B);
  flash_bwd_dq<HD, T><<<grid_q, THREADS, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lt, dst,
      static_cast<T*>(dq), Sq, Sk, K, G, causal, q_offset, scale, dq_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((Sk + BK - 1) / BK, K, B);
  flash_bwd_dkdv<HD, T><<<grid_k, THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lt, dst, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, K, G, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_h(int h, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const void* lse, void* dsum,
               void* dq, void* dk, void* dv, int B, int Sq, int Sk, int K,
               int G, int causal, int q_offset, float scale, float dq_scale,
               cudaStream_t st) {
  switch (h) {
    case 16:
      return launch<16, T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, K, G, causal, q_offset, scale, dq_scale, st);
    case 32:
      return launch<32, T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, K, G, causal, q_offset, scale, dq_scale, st);
    case 64:
      return launch<64, T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, K, G, causal, q_offset, scale, dq_scale, st);
    case 128:
      return launch<128, T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                            Sk, K, G, causal, q_offset, scale, dq_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dsum: (B, K*G, Sq) f32 scratch, written
// by the first kernel and read by the second.  scale: h^-0.5 rounded to
// the inputs' dtype (for q * scale); dq_scale: h^-0.5 in f32.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int K, int G, int h,
                                   int dtype, int causal, int q_offset,
                                   float scale, float dq_scale,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || G < 1 || q_offset < 0 ||
      B > 65535 || K * G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_h<float>(h, q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                             Sq, Sk, K, G, causal, q_offset, scale, dq_scale,
                             st);
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(h, q, k, v, o, dout, lse, dsum, dq, dk,
                                     dv, B, Sq, Sk, K, G, causal, q_offset,
                                     scale, dq_scale, st);
  return (int)cudaErrorInvalidValue;
}
