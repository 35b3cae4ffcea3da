// Attention softmax(q k^T * scale) v over grouped KV heads, forward.
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
// with m the running row max of an online softmax over KV tiles.  Given
// an lse pointer, both kernels also write each row's log-sum-exp
//   lse_i = m + log(max(sum_j exp(s_ij - m), 1e-30))   (f32, (B, K*G, Sq))
// as `_flash_fwd_impl` returns it for the backward
// (csrc/flash_attention_bwd.cu); with a null pointer nothing else changes.
//
// Layout: q and out (B, Sq, K*G, h), k and v (B, Sk, K, h), read in
// place: the KV head of query head n is n / G, so grouped-query
// attention needs no repeated or transposed copy of k and v.
//
// What bounds it on an H100: at the serving shapes (S up to 2048,
// h = 64 or 128) the work is 4 S^2 H h / 2 FLOPs against 4 S H h
// elements of traffic, far above the card's ridge, so it is bound by
// operations.  Two kernels, chosen by the wrapper from dtype and h:
//
// flash_fwd_wgmma (bf16, h = 64 or 128): both products on the tensor
//   cores (989 TFLOP/s bf16).  A block owns 128 query rows of one head:
//   a producer warp issues TMA loads (the q tile once, then 128-key k
//   and v tiles round a ring of stages guarded by full and empty
//   mbarriers), and two consumer warpgroups of 64 rows each run
//   s = q k^T with wgmma from shared memory, the online softmax on the
//   accumulator in registers (a row's max and sum over the 4 lanes that
//   hold it), and o += p v with p as wgmma's register operand.  The q
//   tile is scaled and rounded to bf16 in shared memory once.  Tiles
//   past a causal block's last query are never loaded, tiles wholly
//   above a warpgroup's rows are not computed, and only tiles that
//   straddle the diagonal or the end of k are masked.
//
// flash_fwd_fp32cores (f32 at h = 16..128, bf16 at h = 16 or 32): every
//   product and sum on the fp32 CUDA cores (67 TFLOP/s).  f32 inputs
//   stay here because TF32, the only f32 form of wgmma, keeps about 3
//   decimal digits where the JAX reference computes in f32.  One block
//   of 128 threads owns 64 query rows, keeps the scaled q tile in
//   shared memory, streams 64-key tiles of k and v through shared
//   memory, and each thread computes a 4 x 8 block of scores (rows
//   ty + 16 i, keys tx + 8 j: one row's 8 threads are adjacent lanes, so
//   row max and row sum are 3 shuffles) and a 4 x h/8 block of the
//   output.
//
// Both stop a causal block at its last query's position and start the
// longest blocks first.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launch
// (flash_attention_fwd_tc: 1000 + the CUresult of a failed tensor-map
// encoding, 999 if libcuda has no cuTensorMapEncodeTiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace fp32c {

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
flash_fwd_fp32cores(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int K, int G,
                 int causal, int q_offset, float scale) {
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
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + head) * Sq + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int K, int G, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32cores<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, K * G, B);
  flash_fwd_fp32cores<HD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, K, G,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_h(int h, const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Sk, int K, int G, int causal,
               int q_offset, float scale, cudaStream_t st) {
  switch (h) {
    case 16:
      return launch<16, T>(q, k, v, out, lse, B, Sq, Sk, K, G, causal,
                           q_offset, scale, st);
    case 32:
      return launch<32, T>(q, k, v, out, lse, B, Sq, Sk, K, G, causal,
                           q_offset, scale, st);
    case 64:
      return launch<64, T>(q, k, v, out, lse, B, Sq, Sk, K, G, causal,
                           q_offset, scale, st);
    case 128:
      return launch<128, T>(q, k, v, out, lse, B, Sq, Sk, K, G, causal,
                            q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fp32c

namespace tc {

using namespace hopper;

constexpr int BQ = 128;               // query rows per block
constexpr int BK = 128;               // keys per k / v tile
constexpr int BOX = 64;               // columns per TMA box: 128 bytes
constexpr int CONSUMERS = 256;        // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int NB = HD / BOX;                   // boxes per row
  static constexpr int STAGES = HD == 64 ? 3 : 2;       // k / v ring
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;          // k or v tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  static constexpr size_t SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
};

// s (64 x BK) = q_wg (64 x HD) k_tile^T: HD / 16 steps of k16; step kk
// reads box kk / 4 at byte 32 (kk % 4) of each row
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint32_t q_wg,
                                           uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = 32 * (kk % 4);
    const uint64_t da =
        desc_sw128(q_wg + (kk / 4) * BQ * 128 + off, 16, 1024);
    const uint64_t db =
        desc_sw128(k_tile + (kk / 4) * BK * 128 + off, 16, 1024);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// o (64 x HD) += p (64 x BK, registers) v_tile (BK x HD, MN-major): BK / 16
// steps of k16; step kk reads rows 16 kk.. of every box, boxes BK * 128
// bytes apart
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2],
                                           const uint32_t (&p)[BK / 4],
                                           uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    const uint64_t db = desc_sw128(v_tile + kk * 16 * 128, BK * 128, 1024);
    if constexpr (HD == 64) {
      wgmma_rs_n64_tb(o, a, db, 1);
    } else {
      wgmma_rs_n128_tb(o, a, db, 1);
    }
  }
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Sk, int G, int causal, int q_offset,
                float scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* qs = smem;                          // NB boxes of BQ x 128 B
  uint8_t* ring = smem + C::Q_BYTES;           // STAGES x (k tile, v tile)
  const uint32_t q_bar = smem_u32(ring + C::STAGES * C::STAGE_BYTES);
  const uint32_t full_bar = q_bar + 8;         // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + 8 * C::STAGES;  // stage s free

  const int H = gridDim.x;
  const int head = blockIdx.x;
  const int kh = head / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int b = blockIdx.z;
  // keys past the block's last query position are masked for every row
  const int kv_end = causal ? min(Sk, min(q0 + BQ, Sq) + q_offset) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread issues every load; stage s of tile t is
    // refilled once the consumers have released tile t - STAGES
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::NB; ++c)
        tma_load_4d(smem_u32(qs + c * BQ * 128), &qmap, q_bar, c * BOX, head,
                    q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(empty_bar + 8 * s, ((t / C::STAGES) & 1) ^ 1);
        const uint32_t kt = smem_u32(ring + s * C::STAGE_BYTES);
        const uint32_t vt = kt + C::KV_BYTES;
        mbar_arrive_expect_tx(full_bar + 8 * s, C::STAGE_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_4d(kt + c * BK * 128, &kmap, full_bar + 8 * s, c * BOX, kh,
                      t * BK, b);
          tma_load_4d(vt + c * BK * 128, &vmap, full_bar + 8 * s, c * BOX, kh,
                      t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread
  // holds rows r and r + 8 of them (hopper.cuh's accumulator map)
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r = 16 * (tid / 32) + lane / 4;
  const int wg_row0 = q0 + 64 * wg;

  // q * scale rounded to bf16, in place: elementwise, so the swizzle
  // does not matter; then visible to wgmma
  mbar_wait(q_bar, 0);
#pragma unroll
  for (int c = 0; c < C::NB; ++c) {
    uint4* qv = reinterpret_cast<uint4*>(qs + c * BQ * 128 + wg * 64 * 128);
#pragma unroll
    for (int i = tid; i < 64 * 128 / 16; i += 128) {
      uint4 x = qv[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(f.x * scale, f.y * scale);
      }
      qv[i] = x;
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  const uint32_t q_wg = smem_u32(qs + wg * 64 * 128);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this lane's part
  const int first_pos = wg_row0 + q_offset;
  const int last_pos = min(wg_row0 + 63, Sq - 1) + q_offset;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES;
    const int j0 = t * BK;
    mbar_wait(full_bar + 8 * s, (t / C::STAGES) & 1);
    // a tile wholly above every row of this warpgroup adds exact zeros
    if (!(causal && j0 > last_pos)) {
      const uint32_t kt = smem_u32(ring + s * C::STAGE_BYTES);
      float sc[BK / 2];
      qk_product<HD>(sc, q_wg, kt);
      wgmma_wait<0>();
      reg_fence(sc);

      if (j0 + BK > Sk || (causal && j0 + BK - 1 > first_pos)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int pos = first_pos + r + 8 * ((i >> 1) & 1);
          if (col >= Sk) {
            sc[i] = -INFINITY;  // no such key
          } else if (causal && col > pos) {
            sc[i] = MASKED;
          }
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        alpha[h] = exp2f((m[h] - mx[h]) * LOG2E);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      uint32_t p[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const float e0 = exp2f((sc[i] - m[h]) * LOG2E);
        const float e1 = exp2f((sc[i + 1] - m[h]) * LOG2E);
        l[h] += e0 + e1;
        p[i / 2] = pack_bf16(e0, e1);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      reg_fence(o);
      reg_fence(p);
      pv_product<HD>(o, p, kt + C::KV_BYTES);
      wgmma_wait<0>();
      reg_fence(o);
    }
    mbar_arrive(empty_bar + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int row = wg_row0 + r + 8 * h;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + head) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * h] * inv,
                                   o[4 * j + 2 * h + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane & 3)) = v;
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + head) * Sq + row] =
          m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int K, int G, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const cuuint64_t H = (cuuint64_t)K * G, e = 2;
  CUtensorMap maps[3];
  const cuuint64_t qdims[4] = {HD, H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[3] = {HD * e, H * HD * e, Sq * H * HD * e};
  const cuuint32_t qbox[4] = {BOX, 1, BQ, 1};
  const cuuint64_t kdims[4] = {HD, (cuuint64_t)K, (cuuint64_t)Sk,
                               (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, K * HD * e, Sk * K * HD * e};
  const cuuint32_t kbox[4] = {BOX, 1, BK, 1};
  int res = bf16_map_4d(&maps[0], q, qdims, qstr, qbox);
  if (!res) res = bf16_map_4d(&maps[1], k, kdims, kstr, kbox);
  if (!res) res = bf16_map_4d(&maps[2], v, kdims, kstr, kbox);
  if (res) return res < 0 ? 999 : 1000 + res;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K * G, (Sq + BQ - 1) / BQ, B);
  flash_fwd_wgmma<HD><<<grid, THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), lse, Sq,
      Sk, G, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// the fp32-core kernel; dtype: 0 float32, 1 bfloat16.  lse: null, or
// (B, K*G, Sq) f32 for each row's log-sum-exp (the backward's input)
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq,
                                   int Sk, int K, int G, int h, int dtype,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || G < 1 || q_offset < 0 ||
      B > 65535 || K * G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fp32c::dispatch_h<float>(h, q, k, v, out,
                                    static_cast<float*>(lse), B, Sq, Sk, K,
                                    G, causal, q_offset, scale, st);
  if (dtype == 1)
    return fp32c::dispatch_h<__nv_bfloat16>(h, q, k, v, out,
                                            static_cast<float*>(lse), B, Sq,
                                            Sk, K, G, causal, q_offset, scale,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// bf16 only, h = 64 or 128; q, k, v and out 16-byte aligned (TMA); lse
// as for flash_attention_fwd
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B,
                                      int Sq, int Sk, int K, int G, int h,
                                      int causal, int q_offset, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || G < 1 || q_offset < 0 ||
      B > 65535 || (Sq + tc::BQ - 1) / tc::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (h == 64)
    return tc::launch<64>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Sk, K, G, causal, q_offset, scale, st);
  if (h == 128)
    return tc::launch<128>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                           Sk, K, G, causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
