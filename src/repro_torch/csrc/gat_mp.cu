// Masked multi-head GAT attention, forward only, batched.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `gat_mp_pallas` in
// src/repro/kernels/gat_mp/gat_mp.py (wrapped there by ops.gat_mp).
// For batch b, destination row i and head h:
//   s_ij  = leaky_relu(e_src[i,h] + e_dst[j,h], 0.2)   (x >= 0 branch)
//   s_ij  = -1e30 where adj[i,j] == 0
//   m, l  = max_j s_ij,  sum_j exp(s_ij - m)
//   out_i = sum_j exp(s_ij - m) / max(l, 1e-30) * z_j[h*32 : h*32+32]
// and the residuals m, l are written out as the Pallas kernel does.
// Columns j >= N do not exist here (no padding copies), so a row with
// every real column masked averages z over the N real columns.
//
// What bounds it on an H100: the Pallas kernel keeps all of z (N x D
// f32) in VMEM, which at N = 1043 is 534 KB, more than the 227 KB a
// block may use.  This kernel instead walks the source columns in tiles
// of 32 with an online softmax; each tile of z (32 x D f32, 16 KB at
// D = 128) is staged once in shared memory and read by all ROWS x H
// warps of the block.  One warp owns one (row, head) pair and its 32
// lanes own the 32 features of the head.  At the graph sizes of the
// main path (N <= ~1k, 4 heads) the dense pair count makes the exp and
// FMA work dominate over the bytes, and the adjacency is sparse, so
// the warp skips the exp work of a tile with no edge once its running
// max is finite (those terms are exact zeros) and runs the
// accumulation only over the columns whose weight is non-zero.  fp32
// CUDA cores only; the tensor-core version (wgmma) is later work.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TJ = 32;          // source columns per tile, one per lane
constexpr int ROWS = 4;         // destination rows per block
constexpr int HD = 32;          // features per head, one per lane
constexpr int MAX_HEADS = 8;    // block = 32 * MAX_HEADS * ROWS <= 1024
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * MAX_HEADS * ROWS)
gat_fwd_kernel(const float* __restrict__ z, const float* __restrict__ e_src,
               const float* __restrict__ e_dst,
               const unsigned char* __restrict__ adj, long long adj_bstride,
               float* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int N, int H) {
  __shared__ __align__(16) float zs[TJ * HD * MAX_HEADS];
  const int D = H * HD;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp % H;
  const int i = blockIdx.x * ROWS + warp / H;
  const bool row_ok = i < N;

  const float* zb = z + (size_t)b * N * D;
  const float* edb = e_dst + (size_t)b * N * H;
  const unsigned char* arow =
      adj + (long long)b * adj_bstride + (size_t)(row_ok ? i : 0) * N;
  const float es = row_ok ? e_src[((size_t)b * N + i) * H + h] : 0.f;

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += TJ) {
    const int cols = min(TJ, N - j0);
    __syncthreads();  // every warp is done with the previous tile
    const int n4 = cols * D / 4;
    const float4* src = reinterpret_cast<const float4*>(zb + (size_t)j0 * D);
    float4* dst = reinterpret_cast<float4*>(zs);
    for (int k = threadIdx.x; k < n4; k += blockDim.x) dst[k] = src[k];
    __syncthreads();
    if (!row_ok) continue;

    const int j = j0 + lane;
    const bool in_range = lane < cols;
    const bool edge = in_range && arow[j] != 0;
    // no edge in the tile and a finite running max: every term of the
    // tile is exp(-1e30 - m) == 0 exactly, so skipping changes nothing
    if (__ballot_sync(FULL, edge) == 0u && m_run > MASKED) continue;

    float s = -INFINITY;  // lanes past N take no part
    if (in_range) {
      const float pre = es + edb[(size_t)j * H + h];
      const float lr = pre >= 0.f ? pre : 0.2f * pre;
      s = edge ? lr : MASKED;
    }
    const float m_new = fmaxf(m_run, warp_max(s));
    const float corr = expf(m_run - m_new);
    const float p = in_range ? expf(s - m_new) : 0.f;
    l_run = l_run * corr + warp_sum(p);
    acc *= corr;
    unsigned live = __ballot_sync(FULL, p != 0.f);
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      acc += __shfl_sync(FULL, p, k) * zs[k * D + h * HD + lane];
    }
    m_run = m_new;
  }
  if (row_ok) {
    const size_t r = (size_t)b * N + i;
    out[r * D + h * HD + lane] = acc / fmaxf(l_run, 1e-30f);
    if (lane == 0) {
      m_out[r * H + h] = m_run;
      l_out[r * H + h] = l_run;
    }
  }
}

}  // namespace

extern "C" int gat_mp_fwd(const float* z, const float* e_src,
                          const float* e_dst, const unsigned char* adj,
                          long long adj_bstride, float* out, float* m,
                          float* l, int B, int N, int H, void* stream) {
  if (H < 1 || H > MAX_HEADS || B < 1 || N < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const dim3 block(32 * H * ROWS);
  gat_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      z, e_src, e_dst, adj, adj_bstride, out, m, l, N, H);
  return (int)cudaGetLastError();
}
