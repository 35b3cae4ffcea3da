// Masked multi-head GAT attention, forward only, batched.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `gat_mp_pallas` in
// src/repro/kernels/gat_mp/gat_mp.py:35 / :64 (wrapped there by
// ops.gat_mp).  For batch b, destination row i and head h:
//   s_ij  = leaky_relu(e_src[i,h] + e_dst[j,h], 0.2)   (x >= 0 branch)
//   s_ij  = -1e30 where adj[i,j] == 0
//   m, l  = max_j s_ij,  sum_j exp(s_ij - m)
//   out_i = sum_j exp(s_ij - m) / max(l, 1e-30) * z_j[h*32 : h*32+32]
// and the residuals m, l are written out as the Pallas kernel does.
// Columns j >= N do not exist here (no padding copies), so a row with
// every real column masked averages z over the N real columns.
//
// What bounds it on an H100: the bytes.  The masks of the main path are
// sparse (BERT: 1,762 set entries in 388 x 388, at most 10 a row), so a
// row needs its mask row once (N bytes), and per set column j the row
// z_j (4 D bytes) and e_dst[j] (4 H bytes); every other term is an
// exact zero.  The operations (about 70 per edge and head) are far
// below the bytes.  The design follows the edges: one warp owns one
// destination row and all H heads.  It reads its mask row with one
// 16-byte load per lane per 512 columns and compacts the set columns
// into a list in shared memory (a popcount and a warp prefix sum).  It
// computes the row's scores lane-parallel, 32 edges at a time, with an
// online max over those chunks (one redux.sync per head: m is an exact
// max, so it stays bit-equal to the plain version).  Then it gathers
// z_j for each listed column with one coalesced 512-byte load (a float4
// per lane at H = 4, 8 lanes a head), summing out and l in column
// order.  No tile of z is staged: a block reads only the z rows its
// edges name, from L2.  e_dst is gathered per edge as well: staging a
// batch element's N x H block of it per block would move more bytes
// than the edges need.  A row with no set column walks every column
// with weight 1 (m = -1e30, l = N).
//
// Tensor cores are not used: the reference computes in fp32 and the
// port holds out to 2e-5 with m bit-equal, which TF32 would not keep,
// and with ~1 % of alpha non-zero a dense alpha z product would do ~86x
// the work the edges need.  fp32 CUDA cores, expf (not __expf).
//
// The block shape is a template argument: WARPS destination rows (one
// warp each) per block.  Each row is one warp's and sums in column
// order whatever WARPS is, so every shape gives the same bits; the
// wrapper's tuner (core/gat_tune.py) times the shapes of FWD_WARPS and
// passes the winner.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launch
// (cudaErrorInvalidValue for a block shape outside the compiled set).

#include <cuda_runtime.h>
#include <math.h>

#include "gat_edges.cuh"

namespace {

using namespace gat;

template <int HP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
gat_fwd_kernel(const float* __restrict__ z, const float* __restrict__ e_src,
               const float* __restrict__ e_dst,
               const unsigned char* __restrict__ adj, long long adj_bstride,
               int adj_rep, int adj_count, float* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int N, int H) {
  __shared__ unsigned short cols[WARPS][SWEEP];
  __shared__ float ps[WARPS][32 * HP];  // p of chunk edge k, head h
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= N) return;             // warps are independent: no barrier
  const Slot<HP> me(lane, H);
  const int D = H * HD;
  const size_t r = (size_t)b * N + i;
  const float* zb = z + (size_t)b * N * D;
  const float* edb = e_dst + (size_t)b * N * H;

  float es[HP], m[HP], acc[HP];
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    es[h] = h < H ? e_src[r * H + h] : 0.f;
    m[h] = -INFINITY;
    acc[h] = 0.f;
  }
  float l = 0.f;                  // of this lane's head
  const MaskRow row(
      batch_mask(adj, adj_bstride, adj_rep, adj_count, b) + (size_t)i * N, N);
  int edges = 0;
  for (int s = 0; s < row.sweeps(); ++s) {
    const int cnt = row.compact(s, lane, cols[warp]);
    __syncwarp();
    const int col0 = row.col0(s);
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int n = min(32, cnt - c0);
      float sc[HP];
      const int jl = lane < n ? col0 + cols[warp][c0 + lane] : 0;
#pragma unroll
      for (int h = 0; h < HP; ++h)
        sc[h] = (lane < n && h < H) ? leaky(es[h] + edb[(size_t)jl * H + h])
                                    : -INFINITY;
      const float m_old = me.pick(m);
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        if (h >= H) continue;
        m[h] = fmaxf(m[h], warp_max(sc[h]));
        ps[warp][lane * HP + h] = lane < n ? expf(sc[h] - m[h]) : 0.f;
      }
      // rescale the running sums to the new max; exp(-inf) = 0 at the
      // first chunk
      const float c = expf(m_old - me.pick(m));
      l *= c;
#pragma unroll
      for (int q = 0; q < HP; ++q) acc[q] *= c;
      __syncwarp();
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float zv[HP];
        me.load(zb + (size_t)(col0 + cols[warp][c0 + k]) * D, zv, lane);
        const float p = ps[warp][k * HP + me.head];
        l += p;
#pragma unroll
        for (int q = 0; q < HP; ++q) acc[q] = fmaf(p, zv[q], acc[q]);
      }
      __syncwarp();               // ps and cols are rewritten next
    }
    edges += cnt;
  }
  if (edges == 0) {
    // every column masked: s = m = -1e30, so each of the N columns has
    // weight exp(0) = 1 and l = N
#pragma unroll
    for (int h = 0; h < HP; ++h) m[h] = MASKED;
    l = (float)N;
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float zv[HP];
      me.load(zb + (size_t)j * D, zv, lane);
#pragma unroll
      for (int q = 0; q < HP; ++q) acc[q] += zv[q];
    }
  }
  const float lh = fmaxf(l, 1e-30f);
  float o[HP];
#pragma unroll
  for (int q = 0; q < HP; ++q) o[q] = acc[q] / lh;
  me.store(out + r * D, o, lane);
  if (me.leader(lane)) {
    m_out[r * H + me.head] = me.pick(m);
    l_out[r * H + me.head] = l;
  }
}

template <int HP, int WARPS>
int launch(const float* z, const float* e_src, const float* e_dst,
           const unsigned char* adj, long long adj_bstride, int adj_rep,
           int adj_count, float* out, float* m, float* l, int B, int N, int H,
           cudaStream_t stream) {
  const dim3 grid((N + WARPS - 1) / WARPS, B);
  gat_fwd_kernel<HP, WARPS><<<grid, 32 * WARPS, 0, stream>>>(
      z, e_src, e_dst, adj, adj_bstride, adj_rep, adj_count, out, m, l, N,
      H);
  return (int)cudaGetLastError();
}

template <int HP>
int launch_warps(int warps, const float* z, const float* e_src,
                 const float* e_dst, const unsigned char* adj,
                 long long adj_bstride, int adj_rep, int adj_count,
                 float* out, float* m, float* l, int B, int N, int H,
                 cudaStream_t s) {
  // the compiled set, FWD_WARPS in kernels/gat_mp/ops.py
  if (warps == 2)
    return launch<HP, 2>(z, e_src, e_dst, adj, adj_bstride, adj_rep,
                         adj_count, out, m, l, B, N, H, s);
  if (warps == 4)
    return launch<HP, 4>(z, e_src, e_dst, adj, adj_bstride, adj_rep,
                         adj_count, out, m, l, B, N, H, s);
  if (warps == 8)
    return launch<HP, 8>(z, e_src, e_dst, adj, adj_bstride, adj_rep,
                         adj_count, out, m, l, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gat_mp_fwd(const float* z, const float* e_src,
                          const float* e_dst, const unsigned char* adj,
                          long long adj_bstride, int adj_rep,
                          int adj_count, float* out, float* m, float* l,
                          int B, int N, int H, int warps, void* stream) {
  if (H < 1 || H > MAX_HEADS || B < 1 || N < 1 || B > 65535 || adj_rep < 1 ||
      adj_count < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 1)
    return launch_warps<1>(warps, z, e_src, e_dst, adj, adj_bstride, adj_rep,
                           adj_count, out, m, l, B, N, H, s);
  if (H == 2)
    return launch_warps<2>(warps, z, e_src, e_dst, adj, adj_bstride, adj_rep,
                           adj_count, out, m, l, B, N, H, s);
  if (H <= 4)
    return launch_warps<4>(warps, z, e_src, e_dst, adj, adj_bstride, adj_rep,
                           adj_count, out, m, l, B, N, H, s);
  return launch_warps<8>(warps, z, e_src, e_dst, adj, adj_bstride, adj_rep,
                         adj_count, out, m, l, B, N, H, s);
}
