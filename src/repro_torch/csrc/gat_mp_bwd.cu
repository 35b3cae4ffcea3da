// Gradient of masked multi-head GAT attention, batched.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` / `gat_mp_bwd_pallas` in
// src/repro/kernels/gat_mp/gat_mp.py (the backward of ops._fused).  For
// batch b, row i (the node that aggregates), column j (the node that is
// aggregated) and head h, with alpha recomputed from the forward's
// residuals m, l exactly as the forward defined it:
//   pre_ij   = e_src[i,h] + e_dst[j,h]
//   s_ij     = leaky_relu(pre_ij, 0.2), or -1e30 where adj[i,j] == 0
//   alpha_ij = exp(s_ij - m_i) / max(l_i, 1e-30)
//   drow_i   = g_i . out_i                                (32 features)
//   dpre_ij  = leaky'(pre_ij) * alpha_ij * (g_i . z_j - drow_i), edges only
//   de_src_i = sum_j dpre_ij      dz_j = sum_i alpha_ij g_i
//   de_dst_j = sum_i dpre_ij
// A row with every column masked has m = -1e30 and l = N, so alpha is
// 1/N on EVERY column: its cotangent reaches dz of all columns while its
// dpre is zero.
//
// Design.  The TPU kernel accumulates dz and de_dst across a sequential
// grid in one VMEM buffer; blocks on the card run in no order, so the
// work is split in two launches that each own their outputs, with no
// atomics, and so give the same bits on every run:
//   row pass    -- one warp per (row i, head h), lanes = the head's 32
//                  features: drow_i, then de_src_i over the row's edges;
//   column pass -- one warp per (column j, head h): dz_j and de_dst_j
//                  over the rows that reach j (the edges, read from the
//                  mask strided, since the mask need not be symmetric,
//                  plus every all-masked row).
// Each pass walks the other axis in tiles of 32 and stages the tile of
// the operand it reads per entry (z rows in the row pass, g rows in the
// column pass; 16 KB at D = 128) in shared memory, once for the ROWS x H
// warps of the block.  A tile that no warp of the block needs (no edge,
// no all-masked row) is neither staged nor computed.
//
// What bounds it on an H100.  Per (edge, head) the function needs about
// 138 fp32 operations: recomputing alpha (add, leaky multiply, subtract,
// exp, divide: 6 with the compare), the dz multiply-add over 32 features
// (64), the 32-wide dot product g_i . z_j (64), and dpre and its two
// sums (4).  The bytes are z, out, g and dz (4 B x D per node), e_src,
// e_dst, m, l, de_src, de_dst (4 B x H per node) and the mask (1 B per
// pair).  On the main path's sparse masks (a few edges per row) the
// operations are far below the bytes, so the bound is the bytes, and
// the design reads each tile only where an edge needs it.  fp32 CUDA
// cores only; a tensor-core version (wgmma) is later work.
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, `drow` is a (B, N, H) scratch buffer, the return value
// is the CUDA error code of the launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TJ = 32;          // tile of the walked axis, one per lane
constexpr int ROWS = 4;         // rows (row pass) / columns per block
constexpr int HD = 32;          // features per head, one per lane
constexpr int MAX_HEADS = 8;    // block = 32 * MAX_HEADS * ROWS <= 1024
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void stage(float* dst_smem, const float* src,
                                      int rows, int D) {
  const int n4 = rows * D / 4;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst_smem);
  for (int k = threadIdx.x; k < n4; k += blockDim.x) d[k] = s[k];
}

__global__ void __launch_bounds__(32 * MAX_HEADS * ROWS)
gat_bwd_row_kernel(const float* __restrict__ z,
                   const float* __restrict__ e_src,
                   const float* __restrict__ e_dst,
                   const unsigned char* __restrict__ adj,
                   long long adj_bstride, const float* __restrict__ m,
                   const float* __restrict__ l,
                   const float* __restrict__ out,
                   const float* __restrict__ g, float* __restrict__ drow,
                   float* __restrict__ de_src, int N, int H) {
  __shared__ __align__(16) float zs[TJ * HD * MAX_HEADS];
  const int D = H * HD;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp % H;
  const int i = blockIdx.x * ROWS + warp / H;
  const bool row_ok = i < N;
  const size_t r = (size_t)b * N + (row_ok ? i : 0);

  const float* zb = z + (size_t)b * N * D;
  const float* edb = e_dst + (size_t)b * N * H;
  const unsigned char* arow =
      adj + (long long)b * adj_bstride + (size_t)(row_ok ? i : 0) * N;
  const float gi = row_ok ? g[r * D + h * HD + lane] : 0.f;
  const float dr = warp_sum(gi * (row_ok ? out[r * D + h * HD + lane] : 0.f));
  const float es = row_ok ? e_src[r * H + h] : 0.f;
  const float mi = row_ok ? m[r * H + h] : 0.f;
  const float li = row_ok ? fmaxf(l[r * H + h], 1e-30f) : 1.f;

  float acc = 0.f;  // this lane's columns' dpre, summed over tiles
  for (int j0 = 0; j0 < N; j0 += TJ) {
    const int cols = min(TJ, N - j0);
    const int j = j0 + lane;
    const bool edge = row_ok && lane < cols && arow[j] != 0;
    const unsigned edges = __ballot_sync(FULL, edge);
    // a barrier too: every warp is done with the previous tile
    if (!__syncthreads_or(edges != 0u)) continue;
    stage(zs, zb + (size_t)j0 * D, cols, D);
    __syncthreads();
    if (edges == 0u) continue;
    float pre = 0.f, a = 0.f;
    if (edge) {
      pre = es + edb[(size_t)j * H + h];
      a = expf((pre >= 0.f ? pre : 0.2f * pre) - mi) / li;
    }
    unsigned live = edges;
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const float dot = warp_sum(gi * zs[k * D + h * HD + lane]);
      if (lane == k) {
        const float ds = a * (dot - dr);
        acc += pre >= 0.f ? ds : 0.2f * ds;
      }
    }
  }
  const float total = warp_sum(acc);
  if (row_ok && lane == 0) {
    de_src[r * H + h] = total;
    drow[r * H + h] = dr;
  }
}

__global__ void __launch_bounds__(32 * MAX_HEADS * ROWS)
gat_bwd_col_kernel(const float* __restrict__ z,
                   const float* __restrict__ e_src,
                   const float* __restrict__ e_dst,
                   const unsigned char* __restrict__ adj,
                   long long adj_bstride, const float* __restrict__ m,
                   const float* __restrict__ l,
                   const float* __restrict__ g,
                   const float* __restrict__ drow, float* __restrict__ dz,
                   float* __restrict__ de_dst, int N, int H) {
  __shared__ __align__(16) float gs[TJ * HD * MAX_HEADS];
  const int D = H * HD;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp % H;
  const int j = blockIdx.x * ROWS + warp / H;
  const bool col_ok = j < N;
  const size_t c = (size_t)b * N + (col_ok ? j : 0);

  const float* gb = g + (size_t)b * N * D;
  const size_t nb = (size_t)b * N;
  // column j of the mask, read strided: adj[i, j] at acol[i * N]
  const unsigned char* acol =
      adj + (long long)b * adj_bstride + (col_ok ? j : 0);
  const float zj = col_ok ? z[c * D + h * HD + lane] : 0.f;
  const float ed = col_ok ? e_dst[c * H + h] : 0.f;

  float dz_acc = 0.f;
  float acc = 0.f;  // this lane's rows' dpre, summed over tiles
  for (int i0 = 0; i0 < N; i0 += TJ) {
    const int rows = min(TJ, N - i0);
    const int i = i0 + lane;
    const bool in = col_ok && lane < rows;
    const float mi = in ? m[(nb + i) * H + h] : 0.f;
    const bool edge = in && acol[(size_t)i * N] != 0;
    // a row with no edge at all (m == -1e30) weighs every column 1/N
    const bool contrib = edge || (in && !(mi > MASKED));
    const unsigned live0 = __ballot_sync(FULL, contrib);
    const unsigned edges = __ballot_sync(FULL, edge);
    if (!__syncthreads_or(live0 != 0u)) continue;
    stage(gs, gb + (size_t)i0 * D, rows, D);
    __syncthreads();
    if (live0 == 0u) continue;
    float pre = 0.f, a = 0.f, dr = 0.f;
    if (contrib) {
      pre = e_src[(nb + i) * H + h] + ed;
      const float s = edge ? (pre >= 0.f ? pre : 0.2f * pre) : MASKED;
      a = expf(s - mi) / fmaxf(l[(nb + i) * H + h], 1e-30f);
      dr = drow[(nb + i) * H + h];
    }
    unsigned live = live0;
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const float gk = gs[k * D + h * HD + lane];
      dz_acc += __shfl_sync(FULL, a, k) * gk;
      if ((edges >> k) & 1u) {
        const float dot = warp_sum(gk * zj);
        if (lane == k) {
          const float ds = a * (dot - dr);
          acc += pre >= 0.f ? ds : 0.2f * ds;
        }
      }
    }
  }
  const float total = warp_sum(acc);
  if (col_ok) {
    dz[c * D + h * HD + lane] = dz_acc;
    if (lane == 0) de_dst[c * H + h] = total;
  }
}

}  // namespace

extern "C" int gat_mp_bwd(const float* z, const float* e_src,
                          const float* e_dst, const unsigned char* adj,
                          long long adj_bstride, const float* m,
                          const float* l, const float* out, const float* g,
                          float* drow, float* dz, float* de_src,
                          float* de_dst, int B, int N, int H, void* stream) {
  if (H < 1 || H > MAX_HEADS || B < 1 || N < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const dim3 block(32 * H * ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  gat_bwd_row_kernel<<<grid, block, 0, s>>>(z, e_src, e_dst, adj,
                                            adj_bstride, m, l, out, g, drow,
                                            de_src, N, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gat_bwd_col_kernel<<<grid, block, 0, s>>>(z, e_src, e_dst, adj,
                                            adj_bstride, m, l, g, drow, dz,
                                            de_dst, N, H);
  return (int)cudaGetLastError();
}
