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
// dk and dv sum over the G query heads of their KV head.  For bf16
// inputs every operand of a product is a bf16 value, as in the JAX code,
// so each product is exact and only the order of the f32 sums differs.
//
// Layout: q, o, do and dq (B, Sq, K*G, h); k, v, dk and dv (B, Sk, K, h);
// lse and D (B, K*G, Sq) f32.  All read in place.
//
// What bounds it on an H100: at the training shape (S = 4096, h = 128)
// the five products are 10 S^2 H h / 2 FLOPs against ~10 S H h elements
// of traffic, far above the ridge: operations.  Two routes, chosen by
// the wrapper from dtype and h; neither uses atomics, so two launches on
// the same inputs give bit-equal gradients.
//
// Tensor cores (bf16, h = 64 or 128; entry flash_attention_bwd_tc): three
//   launches on one stream.
//   flash_bwd_prep: a warp per query row writes D and qs = bf(q * scale)
//     (a bf16 scratch of q's shape), so that neither big kernel rescales
//     a streamed tile.
//   flash_bwd_dq_wgmma: a block per (b, query head, 128 rows), longest
//     first.  Thread 0 TMA-loads the qs and do tiles once, then
//     64-key k and v tiles up to the block's last visible key round a
//     ring of stages (full / empty mbarriers).  Two consumer warpgroups
//     of 64 rows each run S = qs k^T and dP = do v^T with wgmma from
//     shared memory, form dS = bf(P (dP - D)) in registers and add
//     dq += dS k with dS as wgmma's register operand (k MN-major); dq is
//     scaled in f32 at the end.
//   flash_bwd_dkdv_wgmma: a block per (b, KV head, 128 keys), longest
//     first.  Warp 0 TMA-loads the k and v tiles once, then streams
//     (qs, do) tiles of 64 query rows of each of the G heads, from the
//     first row whose position reaches the key tile, with the rows' lse
//     (times log2 e) and D beside them.  Each consumer warpgroup owns 64
//     keys: S^T = k qs^T and dP^T = v do^T (both operands K-major in
//     shared memory), P^T = exp2(S^T log2 e - lse log2 e) masked, then
//     dv += bf(P^T) do and dk += dS^T qs with the transposed tiles as
//     register operands and do, qs MN-major.  dk and dv stay in registers
//     across all G heads and query tiles.
//   Blocks are two warpgroups and nothing else (256 threads: up to 255
//   registers a thread), so that dkdv holds dk, dv (h = 128: 128 f32 a
//   thread) and two 64 x 64 score tiles without spilling; warp 0 also
//   keeps the TMA loads in flight.  s and dp are recomputed in both big
//   kernels: 7 products against the 5 of the bound.
//
// fp32 cores (f32 at h = 16..128, bf16 at h = 16 or 32; entry
//   flash_attention_bwd): every product and sum on the fp32 CUDA cores
//   (67 TFLOP/s).  f32 stays here because TF32, the only f32 form of
//   wgmma, keeps about 3 decimal digits where the JAX code computes in
//   f32.  Two kernels:
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
// cudaStream_t, the return value is the CUDA error code of the launches
// (flash_attention_bwd_tc: 1000 + the CUresult of a failed tensor-map
// encoding, 999 if libcuda has no cuTensorMapEncodeTiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ------------------------------------------------------------ tensor cores
namespace tc {

using namespace hopper;

constexpr int BOX = 64;          // columns per TMA box: 128 bytes
// two consumer warpgroups and no producer warps: two warps on each of the
// SM's four register-file partitions leave 255 registers a thread (a
// ninth warp would cap them at 168: 3 x 32 x 168 of a partition's 16 K),
// and dkdv at h = 128 holds dk, dv (128 f32) and two 64 x 64 score tiles
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;         // streamed tile rows (both kernels)
constexpr int BLOCK = 128;       // resident rows (both kernels)
constexpr int PREP_ROWS = 8;     // query rows per prep block

// The same shared-memory plan in both big kernels: a resident tile pair
// (dkdv: k, v of 128 keys; dq: qs, do of 128 rows), a ring of streamed
// tile pairs of 64 rows (dkdv: qs, do; dq: k, v), per stage 2 x 64 f32
// of row data (dkdv: lse log2 e and D), and the barriers.
template <int HD>
struct Cfg {
  static constexpr int NB = HD / BOX;                    // boxes per row
  static constexpr int STAGES = HD == 64 ? 6 : 4;
  static constexpr int RES_BYTES = BLOCK * HD * 2;       // one resident tile
  static constexpr int TILE_BYTES = TILE * HD * 2;       // one streamed tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int ROW_FLOATS = 2 * TILE;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  static constexpr size_t SMEM = 1024 + 2 * RES_BYTES +
                                 STAGES * (STAGE_BYTES + ROW_FLOATS * 4) +
                                 8 * (1 + 2 * STAGES);
};

// d (64 x 64) = a (64 x HD) b (64 x HD)^T, both K-major in shared memory:
// HD / 16 steps of k16; step kk reads box kk / 4 at byte 32 (kk % 4) of
// each row; a's boxes a_box bytes apart, b's b_box
template <int HD>
__device__ __forceinline__ void nt_tc(float (&d)[32], uint32_t a, int a_box,
                                      uint32_t b, int b_box) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = 32 * (kk % 4);
    wgmma_ss_n64(d, desc_sw128(a + (kk / 4) * a_box + off, 16, 1024),
                 desc_sw128(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// d (64 x HD) += a (64 x 64, bf16 pairs in registers in the accumulator
// layout) b (64 x HD, MN-major in shared memory, boxes of 64 rows):
// 4 steps of k16, step kk at row 16 kk of every box
template <int HD>
__device__ __forceinline__ void nn_tc(float (&d)[HD / 2],
                                      const uint32_t (&a)[16], uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    const uint64_t db = desc_sw128(b + kk * 16 * 128, TILE * 128, 1024);
    if constexpr (HD == 64) {
      wgmma_rs_n64_tb(d, ak, db, 1);
    } else {
      wgmma_rs_n128_tb(d, ak, db, 1);
    }
  }
  wgmma_commit();
}

// D = rowsum(do o) and qs = bf(q * scale): a warp per row of (B, Sq, H)
template <int HD>
__global__ void __launch_bounds__(32 * PREP_ROWS)
flash_bwd_prep(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               __nv_bfloat16* __restrict__ qs, float* __restrict__ dsum,
               long long rows, int Sq, int H, float scale) {
  constexpr int P = HD / 64;               // bf16 pairs per lane: 1 or 2
  const long long row = (long long)blockIdx.x * PREP_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const size_t off = (size_t)row * HD + 2 * P * lane;
  __nv_bfloat162 qv[P], ov[P], dv[P];
  if constexpr (P == 2) {
    *reinterpret_cast<uint2*>(qv) = *reinterpret_cast<const uint2*>(q + off);
    *reinterpret_cast<uint2*>(ov) = *reinterpret_cast<const uint2*>(o + off);
    *reinterpret_cast<uint2*>(dv) =
        *reinterpret_cast<const uint2*>(dout + off);
  } else {
    qv[0] = *reinterpret_cast<const __nv_bfloat162*>(q + off);
    ov[0] = *reinterpret_cast<const __nv_bfloat162*>(o + off);
    dv[0] = *reinterpret_cast<const __nv_bfloat162*>(dout + off);
  }
  float part = 0.f;
  uint32_t out[P];
#pragma unroll
  for (int e = 0; e < P; ++e) {
    const float2 a = __bfloat1622float2(ov[e]);
    const float2 d = __bfloat1622float2(dv[e]);
    part += d.x * a.x + d.y * a.y;
    const float2 x = __bfloat1622float2(qv[e]);
    out[e] = pack_bf16(x.x * scale, x.y * scale);
  }
  if constexpr (P == 2) {
    *reinterpret_cast<uint2*>(qs + off) = make_uint2(out[0], out[1]);
  } else {
    *reinterpret_cast<uint32_t*>(qs + off) = out[0];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, m);
  if (lane == 0) {
    const long long n = row % H, bi = row / H;   // bi = b * Sq + i
    dsum[((bi / Sq) * H + n) * Sq + bi % Sq] = part;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qsmap,
                   const __grid_constant__ CUtensorMap domap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int G,
                   int causal, int q_offset, float dq_scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* qs = smem;                          // NB boxes of 128 x 128 B
  uint8_t* dos = qs + C::RES_BYTES;
  uint8_t* ring = dos + C::RES_BYTES;          // STAGES x (k tile, v tile)
  const uint32_t q_bar = smem_u32(
      ring + C::STAGES * (C::STAGE_BYTES + C::ROW_FLOATS * 4));
  const uint32_t full_bar = q_bar + 8;         // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * C::STAGES;  // stage s free

  const int H = gridDim.x;
  const int head = blockIdx.x;
  const int kh = head / G;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BLOCK;  // longest first
  // keys past the block's last query position are masked for every row
  const int kv_end = causal ? min(Sk, min(q0 + BLOCK, Sq) + q_offset) : Sk;
  const int ntiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 keeps the loads in flight: k and v tile t go to stage
  // t % STAGES once every thread has released tile t - STAGES there
  auto produce = [&](int t) {
    const int s = t % C::STAGES;
    mbar_wait(empty_bar + 8 * s, ((t / C::STAGES) & 1) ^ 1);
    const uint32_t kt = smem_u32(ring + s * C::STAGE_BYTES);
    const uint32_t vt = kt + C::TILE_BYTES;
    mbar_arrive_expect_tx(full_bar + 8 * s, C::STAGE_BYTES);
    for (int c = 0; c < C::NB; ++c) {
      tma_load_4d(kt + c * TILE * 128, &kmap, full_bar + 8 * s, c * BOX, kh,
                  t * TILE, b);
      tma_load_4d(vt + c * TILE * 128, &vmap, full_bar + 8 * s, c * BOX, kh,
                  t * TILE, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_bar, 2 * C::RES_BYTES);
    for (int c = 0; c < C::NB; ++c) {
      tma_load_4d(smem_u32(qs + c * BLOCK * 128), &qsmap, q_bar, c * BOX,
                  head, q0, b);
      tma_load_4d(smem_u32(dos + c * BLOCK * 128), &domap, q_bar, c * BOX,
                  head, q0, b);
    }
    for (int t = 0; t < min(ntiles, C::STAGES); ++t) produce(t);
  }
  __syncwarp();

  // warpgroup wg owns rows q0 + 64 wg .. + 63; this thread holds rows r
  // and r + 8 of them (hopper.cuh's accumulator map) and keys
  // 8 (i >> 2) + cq + (i & 1) of each tile
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r = 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane & 3);
  const int row0 = q0 + 64 * wg;
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    const size_t at = ((size_t)b * H + head) * Sq + row;
    lse2[h] = row < Sq ? lse[at] * LOG2E : 0.f;
    dd[h] = row < Sq ? dsum[at] : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  const int first_pos = row0 + q_offset;
  const int last_pos = min(row0 + 63, Sq - 1) + q_offset;
  const bool has_rows = row0 < Sq;
  const uint32_t qs_wg = smem_u32(qs + wg * 64 * 128);
  const uint32_t do_wg = smem_u32(dos + wg * 64 * 128);
  mbar_wait(q_bar, 0);

  for (int t = 0; t < ntiles; ++t) {
    // refill the stage of tile t - 1, which both warpgroups have likely
    // released by now
    if (threadIdx.x == 0 && t >= 1 && t - 1 + C::STAGES < ntiles)
      produce(t - 1 + C::STAGES);
    __syncwarp();
    const int s = t % C::STAGES;
    const int j0 = t * TILE;
    mbar_wait(full_bar + 8 * s, (t / C::STAGES) & 1);
    // a tile wholly above every row of this warpgroup adds exact zeros
    if (has_rows && !(causal && j0 > last_pos)) {
      const uint32_t kt = smem_u32(ring + s * C::STAGE_BYTES);
      const uint32_t vt = kt + C::TILE_BYTES;
      float sc[32], dp[32];
      nt_tc<HD>(sc, qs_wg, BLOCK * 128, kt, TILE * 128);   // S = qs k^T
      nt_tc<HD>(dp, do_wg, BLOCK * 128, vt, TILE * 128);   // dP = do v^T
      wgmma_wait<1>();
      reg_fence(sc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = exp2f(fmaf(sc[i], LOG2E, -lse2[(i >> 1) & 1]));
      if (j0 + TILE > Sk || row0 + 64 > Sq ||
          (causal && j0 + TILE - 1 > first_pos)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = j0 + 8 * (i >> 2) + cq + (i & 1);
          const int row = row0 + r + 8 * ((i >> 1) & 1);
          if (col >= Sk || row >= Sq || (causal && col > row + q_offset))
            sc[i] = 0.f;
        }
      }
      wgmma_wait<0>();
      reg_fence(dp);
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float d = dd[(i >> 1) & 1];
        ds[i / 2] =
            pack_bf16(sc[i] * (dp[i] - d), sc[i + 1] * (dp[i + 1] - d));
      }
      reg_fence(dqa);
      reg_fence(ds);
      nn_tc<HD>(dqa, ds, kt);                              // dq += dS k
      wgmma_wait<0>();
      reg_fence(dqa);
    }
    mbar_arrive(empty_bar + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + (((size_t)b * Sq + row) * H + head) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j + cq) =
          pack_bf16(dqa[4 * j + 2 * h] * dq_scale,
                    dqa[4 * j + 2 * h + 1] * dq_scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qsmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int G,
                     int causal, int q_offset) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* ks = smem;                          // NB boxes of 128 x 128 B
  uint8_t* vs = ks + C::RES_BYTES;
  uint8_t* ring = vs + C::RES_BYTES;           // STAGES x (qs tile, do tile)
  // STAGES x (lse log2 e of 64 rows, D of 64 rows)
  float* rows = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE_BYTES);
  const uint32_t kv_bar = smem_u32(rows + C::STAGES * C::ROW_FLOATS);
  const uint32_t full_bar = kv_bar + 8;        // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * C::STAGES;  // stage s free

  const int K = gridDim.x;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.z * BLOCK;  // causal: the first key tiles see most
  const int H = K * G;
  // rows before the first that can see key j0 add exact zeros
  const int i_first = causal ? max(0, j0 - q_offset) : 0;
  const int per_head = i_first < Sq ? (Sq - i_first + TILE - 1) / TILE : 0;
  const int ntiles = G * per_head;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 32);   // warp 0's lanes
      mbar_init(empty_bar + 8 * s, THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp 0 keeps the loads in flight: tile t (query rows i0.. of head
  // kh G + g) goes to stage t % STAGES once every thread has released
  // tile t - STAGES there.  Its lanes copy the rows' lse log2 e and D,
  // lane 0 issues the TMA loads; each lane's arrival releases its stores.
  auto produce = [&](int t) {
    const int s = t % C::STAGES;
    const int head = kh * G + t / per_head;
    const int i0 = i_first + (t % per_head) * TILE;
    mbar_wait(empty_bar + 8 * s, ((t / C::STAGES) & 1) ^ 1);
    float* rl = rows + s * C::ROW_FLOATS;
    const size_t roff = ((size_t)b * H + head) * Sq;
    for (int x = lane; x < TILE; x += 32) {
      const bool in = i0 + x < Sq;
      rl[x] = in ? lse[roff + i0 + x] * LOG2E : 0.f;
      rl[TILE + x] = in ? dsum[roff + i0 + x] : 0.f;
    }
    if (lane == 0) {
      const uint32_t qt = smem_u32(ring + s * C::STAGE_BYTES);
      const uint32_t dt = qt + C::TILE_BYTES;
      mbar_arrive_expect_tx(full_bar + 8 * s, C::STAGE_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        tma_load_4d(qt + c * TILE * 128, &qsmap, full_bar + 8 * s, c * BOX,
                    head, i0, b);
        tma_load_4d(dt + c * TILE * 128, &domap, full_bar + 8 * s, c * BOX,
                    head, i0, b);
      }
    } else {
      mbar_arrive(full_bar + 8 * s);
    }
    __syncwarp();
  };
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * C::RES_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        tma_load_4d(smem_u32(ks + c * BLOCK * 128), &kmap, kv_bar, c * BOX,
                    kh, j0, b);
        tma_load_4d(smem_u32(vs + c * BLOCK * 128), &vmap, kv_bar, c * BOX,
                    kh, j0, b);
      }
    }
    __syncwarp();
    for (int t = 0; t < min(ntiles, C::STAGES); ++t) produce(t);
  }

  // warpgroup wg owns keys kmin .. kmin + 63; this thread holds keys
  // kmin + r and kmin + r + 8 (rows of the transposed tiles) and query
  // columns 8 (i >> 2) + cq + (i & 1) of each tile
  const int wg = threadIdx.x / 128;
  const int r = 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane & 3);
  const int kmin = j0 + 64 * wg;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_wg = smem_u32(ks + wg * 64 * 128);
  const uint32_t v_wg = smem_u32(vs + wg * 64 * 128);
  mbar_wait(kv_bar, 0);

  // tile t's dv and dk products stay in flight while tile t + 1's scores
  // are issued; its stage is released (and refilled by warp 0 with tile
  // t + STAGES, once both warpgroups have released it) after they complete
  auto release = [&](int t) {
    mbar_arrive(empty_bar + 8 * (t % C::STAGES));
    if (threadIdx.x < 32 && t + C::STAGES < ntiles) produce(t + C::STAGES);
  };
  int held = -1;   // the tile whose dv, dk products may still be running
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES;
    const int i0 = i_first + (t % per_head) * TILE;
    mbar_wait(full_bar + 8 * s, (t / C::STAGES) & 1);
    // rows whose positions all lie before the warpgroup's first key, or a
    // warpgroup past the end of k, add exact zeros
    if (kmin < Sk && !(causal && i0 + TILE - 1 + q_offset < kmin)) {
      const uint32_t qt = smem_u32(ring + s * C::STAGE_BYTES);
      const uint32_t dt = qt + C::TILE_BYTES;
      const float* rl = rows + s * C::ROW_FLOATS;
      // both score tiles first, then P and dS packed pair by pair, so
      // that the f32 tiles die as the bf16 operands are formed
      float st[32], dpt[32];
      nt_tc<HD>(st, k_wg, BLOCK * 128, qt, TILE * 128);   // S^T = k qs^T
      nt_tc<HD>(dpt, v_wg, BLOCK * 128, dt, TILE * 128);  // dP^T = v do^T
      wgmma_wait<0>();                       // and the held dv, dk
      reg_fence(st);
      reg_fence(dpt);
      reg_fence(dka);
      reg_fence(dva);
      if (held >= 0) release(held);
      const bool edge = kmin + 64 > Sk || i0 + TILE > Sq ||
                        (causal && i0 + q_offset < kmin + 63);
      uint32_t pt[16], dst[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i >> 2) + cq;   // query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(rl + c);
        const float2 d2 = *reinterpret_cast<const float2*>(rl + TILE + c);
        float p0 = exp2f(fmaf(st[i], LOG2E, -l2.x));
        float p1 = exp2f(fmaf(st[i + 1], LOG2E, -l2.y));
        if (edge) {
          const int key = kmin + r + 8 * ((i >> 1) & 1);
          const int row = i0 + c;
          if (key >= Sk || row >= Sq || (causal && key > row + q_offset))
            p0 = 0.f;
          if (key >= Sk || row + 1 >= Sq ||
              (causal && key > row + 1 + q_offset))
            p1 = 0.f;
        }
        pt[i / 2] = pack_bf16(p0, p1);
        dst[i / 2] = pack_bf16(p0 * (dpt[i] - d2.x), p1 * (dpt[i + 1] - d2.y));
      }
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(pt);
      reg_fence(dst);
      nn_tc<HD>(dva, pt, dt);                             // dv += P^T do
      nn_tc<HD>(dka, dst, qt);                            // dk += dS^T qs
      held = t;
    } else {
      wgmma_wait<0>();
      reg_fence(dka);
      reg_fence(dva);
      if (held >= 0) release(held);
      held = -1;
      release(t);
    }
  }
  wgmma_wait<0>();
  reg_fence(dka);
  reg_fence(dva);
  if (held >= 0) release(held);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kmin + r + 8 * h;
    if (key >= Sk) continue;
    const size_t at = (((size_t)b * Sk + key) * K + kh) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j + cq) =
          pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j + cq) =
          pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* qs, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int K, int G,
           int causal, int q_offset, float scale, float dq_scale,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  const cuuint64_t H = (cuuint64_t)K * G, e = 2;
  // qs and do in boxes of 128 rows (dq) and 64 rows (dkdv); k and v in
  // boxes of 64 keys (dq) and 128 keys (dkdv)
  const cuuint64_t qdims[4] = {HD, H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[3] = {HD * e, H * HD * e, Sq * H * HD * e};
  const cuuint64_t kdims[4] = {HD, (cuuint64_t)K, (cuuint64_t)Sk,
                               (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, K * HD * e, Sk * K * HD * e};
  const cuuint32_t big[4] = {BOX, 1, BLOCK, 1};
  const cuuint32_t small[4] = {BOX, 1, TILE, 1};
  CUtensorMap m[8];  // dq: qs, do, k, v; dkdv: k, v, qs, do
  int res = bf16_map_4d(&m[0], qs, qdims, qstr, big);
  if (!res) res = bf16_map_4d(&m[1], dout, qdims, qstr, big);
  if (!res) res = bf16_map_4d(&m[2], k, kdims, kstr, small);
  if (!res) res = bf16_map_4d(&m[3], v, kdims, kstr, small);
  if (!res) res = bf16_map_4d(&m[4], k, kdims, kstr, big);
  if (!res) res = bf16_map_4d(&m[5], v, kdims, kstr, big);
  if (!res) res = bf16_map_4d(&m[6], qs, qdims, qstr, small);
  if (!res) res = bf16_map_4d(&m[7], dout, qdims, qstr, small);
  if (res) return res < 0 ? 999 : 1000 + res;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float* lt = static_cast<const float*>(lse);
  float* dst = static_cast<float*>(dsum);
  const long long rows = (long long)B * Sq * H;
  flash_bwd_prep<HD><<<(unsigned)((rows + PREP_ROWS - 1) / PREP_ROWS),
                       32 * PREP_ROWS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(qs), dst, rows, Sq, (int)H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)H, B, (Sq + BLOCK - 1) / BLOCK);
  flash_bwd_dq_wgmma<HD><<<grid_q, THREADS, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lt, dst, static_cast<__nv_bfloat16*>(dq), Sq,
      Sk, G, causal, q_offset, dq_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k(K, B, (Sk + BLOCK - 1) / BLOCK);
  flash_bwd_dkdv_wgmma<HD><<<grid_k, THREADS, C::SMEM, stream>>>(
      m[4], m[5], m[6], m[7], lt, dst, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, G, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// bf16 only, h = 64 or 128; q, k, v, o, dout, qs, dq, dk and dv 16-byte
// aligned (TMA, vector loads).  dsum: (B, K*G, Sq) f32 and qs: a bf16
// scratch of q's shape, both written by the first kernel; scale and
// dq_scale as for flash_attention_bwd.
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dsum, void* qs, void* dq,
                                      void* dk, void* dv, int B, int Sq,
                                      int Sk, int K, int G, int h,
                                      int causal, int q_offset, float scale,
                                      float dq_scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || G < 1 || q_offset < 0 ||
      B > 65535 || (Sq + tc::BLOCK - 1) / tc::BLOCK > 65535 ||
      (Sk + tc::BLOCK - 1) / tc::BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(qs) |
                        reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) |
                        reinterpret_cast<uintptr_t>(dv);
  if (any % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (h == 64)
    return tc::launch<64>(q, k, v, o, dout, lse, dsum, qs, dq, dk, dv, B, Sq,
                          Sk, K, G, causal, q_offset, scale, dq_scale, st);
  if (h == 128)
    return tc::launch<128>(q, k, v, o, dout, lse, dsum, qs, dq, dk, dv, B,
                           Sq, Sk, K, G, causal, q_offset, scale, dq_scale,
                           st);
  return (int)cudaErrorInvalidValue;
}
