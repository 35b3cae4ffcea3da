// Attention softmax(q k^T * scale) v over grouped KV heads, forward only.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py (wrapped there by
// ops.flash_attention), the lowering of the contract of
// repro.models.attention.blocked_attention.  For batch b, KV head kh,
// query head n = kh * G + g and query row i at position i + q_offset:
//   s_ij = bf(q_i * scale) . k_j          (f32 sum; bf = round to the
//                                          inputs' dtype, as the JAX code
//                                          scales q in that dtype)
//   s_ij = -1e30 where causal and j > i + q_offset
//   o_i  = sum_j bf(exp(s_ij - m)) v_j / max(sum_j exp(s_ij - m), 1e-30)
// with m the running row max of an online softmax over KV tiles.
//
// Layout: q and out (B, Sq, K*G, h), k and v (B, Sk, K, h), read in
// place: the KV head of query head n is n / G, so grouped-query
// attention needs no repeated or transposed copy of k and v.  Inputs
// are float32 or bfloat16 and every product and sum is f32.
//
// What bounds it on an H100: at the serving shapes (S up to 2048,
// h = 64 or 128) the work is 4 S^2 H h / 2 FLOPs against 4 S H h
// elements of traffic, far above the card's ridge, so it is bound by
// operations.  This first version runs them on the fp32 CUDA cores
// (67 TFLOP/s), not the tensor cores (989 TFLOP/s bf16): one block of
// 128 threads owns 64 query rows of one head, keeps the scaled q tile
// in shared memory, streams 64-key tiles of k and v through shared
// memory, and each thread computes a 4 x 8 block of scores (rows
// ty + 16 i, keys tx + 8 j: one row's 8 threads are adjacent lanes, so
// row max and row sum are 3 shuffles) and a 4 x h/8 block of the
// output.  Causal blocks stop at the diagonal tile and run in reverse
// order so the longest start first.  wgmma and TMA are later work.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups x 8 key groups
constexpr int LP = BK + 8;      // row stride of the probability tile
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// reductions over the 8 adjacent lanes that share a query row
__device__ __forceinline__ float row_max(float v) {
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (HD + 4) + BK * HD + BQ * LP) * sizeof(float);
}

// output column of a thread's t-th accumulator: float4 groups
// 4 tx + 32 c for h >= 32, pairs 2 tx for h = 16
template <int HD>
__device__ __forceinline__ int out_col(int tx, int t) {
  if constexpr (HD >= 32) {
    return 32 * (t / 4) + 4 * tx + (t % 4);
  } else {
    return 2 * tx + t;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Sk, int K, int G, int causal, int q_offset,
                 float scale) {
  constexpr int LD = HD + 4;     // row stride of the q and k tiles
  constexpr int DPT = HD / 8;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // BQ x LD, scaled q
  float* ks = qs + BQ * LD;      // BK x LD
  float* vs = ks + BK * LD;      // BK x HD
  float* ps = vs + BK * HD;      // BQ x LP, probabilities in T's precision

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int head = blockIdx.y;
  const int H = K * G;
  const int kh = head / G;
  const int b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)K * HD;
  const T* qb = q + ((size_t)b * Sq * H + head) * HD;
  const T* kb = k + ((size_t)b * Sk * K + kh) * HD;
  const T* vb = v + ((size_t)b * Sk * K + kh) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (q0 + r < Sq) x = round_to<T>(to_f(qb[(q0 + r) * q_stride + d]) * scale);
    qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  }

  // keys past the last query position of the tile are masked for every
  // row: their tiles add exp(-1e30 - m) == 0 and are skipped
  const int kv_end =
      causal ? min(Sk, min(q0 + BQ, Sq) + q_offset) : Sk;
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      float kx = 0.f, vx = 0.f;
      if (j0 + r < Sk) {
        kx = to_f(kb[(j0 + r) * kv_stride + d]);
        vx = to_f(vb[(j0 + r) * kv_stride + d]);
      }
      ks[r * LD + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = *reinterpret_cast<const float4*>(&ks[(tx + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                     a[i].w * c[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j0 + tx + 8 * j;
        if (col >= Sk) {
          s[i][j] = -INFINITY;  // no such key
        } else if (causal && col > qpos) {
          s[i][j] = MASKED;
        }
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ps[(ty + 16 * i) * LP + tx + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();

    const int cols = min(BK, Sk - j0);
    for (int c = 0; c < cols; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LP + c];
      const float* vrow = vs + c * HD;
      if constexpr (HD >= 32) {
#pragma unroll
        for (int g4 = 0; g4 < DPT / 4; ++g4) {
          const float4 w =
              *reinterpret_cast<const float4*>(&vrow[32 * g4 + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g4 + 0] += p[i] * w.x;
            acc[i][4 * g4 + 1] += p[i] * w.y;
            acc[i][4 * g4 + 2] += p[i] * w.z;
            acc[i][4 * g4 + 3] += p[i] * w.w;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          const float w = vrow[out_col<HD>(tx, t)];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][t] += p[i] * w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)b * Sq * H + head) * HD + row * q_stride;
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      orow[out_col<HD>(tx, t)] = from_f<T>(acc[i][t] * inv);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int K, int G, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, K * G, B);
  flash_fwd_kernel<HD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, K, G, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_h(int h, const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Sk, int K, int G, int causal, int q_offset,
               float scale, cudaStream_t st) {
  switch (h) {
    case 16:
      return launch<16, T>(q, k, v, out, B, Sq, Sk, K, G, causal, q_offset,
                           scale, st);
    case 32:
      return launch<32, T>(q, k, v, out, B, Sq, Sk, K, G, causal, q_offset,
                           scale, st);
    case 64:
      return launch<64, T>(q, k, v, out, B, Sq, Sk, K, G, causal, q_offset,
                           scale, st);
    case 128:
      return launch<128, T>(q, k, v, out, B, Sq, Sk, K, G, causal, q_offset,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int K, int G, int h, int dtype,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || G < 1 || q_offset < 0 ||
      B > 65535 || K * G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_h<float>(h, q, k, v, out, B, Sq, Sk, K, G, causal,
                             q_offset, scale, st);
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(h, q, k, v, out, B, Sq, Sk, K, G, causal,
                                     q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
