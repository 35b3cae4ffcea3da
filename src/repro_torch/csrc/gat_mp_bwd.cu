// Gradient of masked multi-head GAT attention, batched.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` / `gat_mp_bwd_pallas` in
// src/repro/kernels/gat_mp/gat_mp.py:98 / :146 (the backward of
// ops._fused).  For batch b, row i (the node that aggregates), column j
// (the node that is aggregated) and head h, with alpha recomputed from
// the forward's residuals m, l exactly as the forward defined it:
//   pre_ij   = e_src[i,h] + e_dst[j,h]
//   s_ij     = leaky_relu(pre_ij, 0.2), or -1e30 where adj[i,j] == 0
//   alpha_ij = exp(s_ij - m_i) / max(l_i, 1e-30)
//   drow_i   = g_i . out_i                                (32 features)
//   dpre_ij  = leaky'(pre_ij) * alpha_ij * (g_i . z_j - drow_i), edges only
//   de_src_i = sum_j dpre_ij      dz_j = sum_i alpha_ij g_i
//   de_dst_j = sum_i dpre_ij
// A row with every column masked has m = -1e30 and l = N, so alpha is
// 1/N on EVERY column: its cotangent reaches dz of all columns while its
// dpre is zero.  The mask need not be symmetric.
//
// What bounds it on an H100: the bytes.  On the main path's sparse
// masks (BERT: 4.5 set columns a row) the function needs each mask byte
// once and, per edge, the rows z_j, g_i and out_i (4 D bytes each) and
// a few per-head scalars; the ~140 fp32 operations per edge and head
// are far below that.  The design follows the edges, in ONE launch with
// no scratch and no atomics: the grid's blocks take one of two roles,
// and each output has one owner, which sums in a fixed order, so a
// relaunch gives the same bits.
//   column role (the first ceil(N/8) blocks of each batch element) --
//     a block owns 8 consecutive columns, one warp each, for dz_j and
//     de_dst_j.  It reads the mask by rows: adj[i, j0:j0+8] is 8
//     contiguous bytes in one or two aligned 16-byte words, read once
//     per row by one lane, which also marks the rows whose m is -1e30;
//     each warp's 32 rows are or'd into a tile summary.  Each warp then
//     lists its column's rows (edges, and every all-masked row) in
//     ascending order, 512 rows at a time, skipping the tiles where its
//     column has no edge and no row is masked, computes alpha
//     lane-parallel, 32 rows at a time, and walks the list gathering
//     g_i and, on an edge, out_i (512-byte coalesced loads at H = 4):
//     dz_j += alpha g_i, and for de_dst_j each lane sums its share of
//     leaky' alpha g_i . (z_j - out_i); one head sum at the end, no
//     shuffle per edge.
//   row role (the next ceil(N/8) blocks) -- one warp per row i for
//     de_src_i: the forward's walk over the row's set columns (16-byte
//     mask loads, a compacted list), alpha lane-parallel, then per edge
//     the gather of z_j and the lane's share of leaky' alpha g_i .
//     (z_j - out_i), summed in column order.
// Column blocks come first in the grid, so they, which carry the most
// work, start first.  The per-row scalars (e_src, e_dst, m, l) are
// read where alpha is computed, per edge, from L1 and L2, rather than
// staged per block (more bytes than the edges need at these densities)
// or held in registers across the walk.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W: the walk gathers two edges' rows at a time, and
// the kernel stays at 64 registers a thread at H = 4, so three blocks
// of 8 warps fit on an SM; more registers (more rows in flight) or
// 16-warp blocks were slower at the critic's B = 24, as was a block of
// 32 columns walked in turn.
//
// Tensor cores are not used: the reference computes in fp32 and the
// port holds each gradient to 1e-5 of its largest element, which TF32
// would not keep, and with ~1 % of alpha non-zero a dense product would
// do ~86x the work the edges need.  fp32 CUDA cores, expf.
//
// The block shape is a set of template arguments: WARPS columns or rows
// (one warp each) per block, RCH rows a column block lists at a time,
// BATCH edges whose rows a warp gathers at once.  Each output still has
// one warp as its owner, which walks its edges in ascending order and
// sums them one after the other, so every shape gives the same bits;
// the wrapper's tuner (core/gat_tune.py) times the shapes of BWD_SHAPES
// and passes the winner.  The text above describes the default shape,
// (8, 512, 2).
//
// C interface for ctypes: pointers are device pointers, `stream` is a
// cudaStream_t, the return value is the CUDA error code of the launch
// (cudaErrorInvalidValue for a block shape outside the compiled set).

#include <cuda_runtime.h>
#include <math.h>

#include "gat_edges.cuh"

namespace {

using namespace gat;

constexpr unsigned EDGE = 0x8000u;  // list entry: the row has an edge

// WARPS: rows or columns per block; RCH: rows a column block lists at a
// time; BATCH: edges whose rows are gathered at once
#define SHAPE_PARAMS int WARPS, int RCH, int BATCH
#define SHAPE WARPS, RCH, BATCH

template <int HP, SHAPE_PARAMS>
struct RowSmem {
  unsigned short cols[WARPS][SWEEP];
  float alpha[WARPS][32 * HP];   // alpha of chunk edge k, head h
};

template <int HP, SHAPE_PARAMS>
struct ColSmem {
  unsigned short bits[RCH];      // the block's columns set in row i
  unsigned char masked[RCH];     // row i has m = -1e30
  unsigned tile[RCH / 32];       // the bits of 32 rows, or'd; ANY_MASKED
  unsigned short rows[WARPS][RCH];
  float alpha[WARPS][32 * HP];
};

template <int HP, SHAPE_PARAMS>
union BwdSmem {
  RowSmem<HP, SHAPE> row;
  ColSmem<HP, SHAPE> col;
};

struct Args {
  const float* __restrict__ z;
  const float* __restrict__ e_src;
  const float* __restrict__ e_dst;
  const unsigned char* __restrict__ adj;
  long long adj_bstride;
  int adj_rep, adj_count;
  const float* __restrict__ m;
  const float* __restrict__ l;
  const float* __restrict__ out;
  const float* __restrict__ g;
  float* __restrict__ dz;
  float* __restrict__ de_src;
  float* __restrict__ de_dst;
  int N, H;
};

// dpre_ij = c_ij (g_i . z_j - g_i . out_i) with c = leaky'(pre) alpha,
// and the dot products are linear: a lane sums c times its own share
// sum_q g_q (z_q - out_q) over the edges, and one head sum at the end
// gives the gradient, with no shuffle per edge
__device__ __forceinline__ float dpre_weight(float alpha, unsigned posb,
                                             int k) {
  return ((posb >> k) & 1u) ? alpha : 0.2f * alpha;
}

template <int HP>
__device__ __forceinline__ float dot_diff(const float (&g)[HP],
                                          const float (&z)[HP],
                                          const float (&o)[HP]) {
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < HP; ++q) t = fmaf(g[q], z[q] - o[q], t);
  return t;
}

// per head h < H, the bits of the first n lanes whose `pos[h]` is true;
// returns the one of this lane's head
template <int HP>
__device__ __forceinline__ unsigned pos_bits(const Slot<HP>& me,
                                             const bool (&pos)[HP], int n,
                                             int lane, int H) {
  unsigned mine = 0;
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    if (h >= H) continue;
    const unsigned bits = __ballot_sync(FULL, lane < n && pos[h]);
    if (h == me.head) mine = bits;
  }
  return mine;
}

template <int HP, SHAPE_PARAMS>
__device__ void columns(const Args& a, ColSmem<HP, SHAPE>& sm, int cb) {
  constexpr unsigned ANY_MASKED = 1u << WARPS;  // tile: a row is masked
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = a.N, H = a.H, D = H * HD;
  const size_t nb = (size_t)blockIdx.y * N;
  const unsigned char* ab =
      batch_mask(a.adj, a.adj_bstride, a.adj_rep, a.adj_count, blockIdx.y);
  const int j0 = cb * WARPS;
  const int ncols = min(WARPS, N - j0);
  const int j = j0 + warp;
  const bool col_ok = warp < ncols;
  const Slot<HP> me(lane, H);

  float zj[HP], dzj[HP];
  if (col_ok) me.load(a.z + (nb + j) * D, zj, lane);
#pragma unroll
  for (int h = 0; h < HP; ++h) dzj[h] = 0.f;
  float acc = 0.f;  // this lane's share of de_dst of its head
  for (int i0 = 0; i0 < N; i0 += RCH) {
    const int nr = min(RCH, N - i0);
    __syncthreads();              // the previous chunk's lists are done
    // a warp scans 32 rows at a time, one a lane
    for (int t0 = warp * 32; t0 < nr; t0 += blockDim.x) {
      const int t = t0 + lane;
      unsigned bits = 0;
      bool masked = false;
      if (t < nr) {
        const size_t i = (size_t)(i0 + t);
        bits = nonzero_bytes(ab + i * N + j0, ncols);
#pragma unroll
        for (int h = 0; h < HP; ++h)
          if (h < H) masked |= !(a.m[(nb + i) * H + h] > MASKED);
        sm.bits[t] = (unsigned short)bits;
        sm.masked[t] = masked;
      }
      bits = __reduce_or_sync(FULL, bits);
      if (__any_sync(FULL, masked)) bits |= ANY_MASKED;
      if (lane == 0) sm.tile[t0 / 32] = bits;
    }
    __syncthreads();
    if (!col_ok) continue;
    // the column's rows in this chunk, ascending, edges flagged
    int cnt = 0;
    for (int t0 = 0; t0 < nr; t0 += 32) {
      const unsigned tile = sm.tile[t0 / 32];
      if (!((tile >> warp) & 1u) && !(tile & ANY_MASKED)) continue;
      const int t = t0 + lane;
      const bool edge = t < nr && ((sm.bits[t] >> warp) & 1u);
      const bool take = edge || (t < nr && sm.masked[t]);
      const unsigned live = __ballot_sync(FULL, take);
      if (take)
        sm.rows[warp][cnt + __popc(live & ((1u << lane) - 1u))] =
            (unsigned short)(t | (edge ? EDGE : 0u));
      cnt += __popc(live);
    }
    __syncwarp();
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int n = min(32, cnt - c0);
      bool edge = false;
      bool pos[HP];
      if (lane < n) {
        const unsigned e = sm.rows[warp][c0 + lane];
        const size_t i = nb + i0 + (e & ~EDGE);
        edge = e & EDGE;
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          pos[h] = false;
          if (h >= H) continue;
          const float pre = a.e_src[i * H + h] + a.e_dst[(nb + j) * H + h];
          const float s = edge ? leaky(pre) : MASKED;
          sm.alpha[warp][lane * HP + h] =
              expf(s - a.m[i * H + h]) / fmaxf(a.l[i * H + h], 1e-30f);
          pos[h] = pre >= 0.f;
        }
      }
      const unsigned edges = __ballot_sync(FULL, edge);
      const unsigned posb = pos_bits(me, pos, n, lane, H);
      __syncwarp();
      for (int k0 = 0; k0 < n; k0 += BATCH) {
        float gi[BATCH][HP], oi[BATCH][HP];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (k0 + u >= n) break;
          const size_t i = nb + i0 + (sm.rows[warp][c0 + k0 + u] & ~EDGE);
          me.load(a.g + i * D, gi[u], lane);
          if ((edges >> (k0 + u)) & 1u) me.load(a.out + i * D, oi[u], lane);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int k = k0 + u;
          if (k >= n) break;
          const float al = sm.alpha[warp][k * HP + me.head];
#pragma unroll
          for (int q = 0; q < HP; ++q) dzj[q] = fmaf(al, gi[u][q], dzj[q]);
          if ((edges >> k) & 1u) acc = fmaf(
              dpre_weight(al, posb, k), dot_diff(gi[u], zj, oi[u]), acc);
        }
      }
      __syncwarp();               // rows and alpha are rewritten next
    }
  }
  if (!col_ok) return;
  me.store(a.dz + (nb + j) * D, dzj, lane);
  acc = Slot<HP>::head_sum(acc);
  if (me.leader(lane)) a.de_dst[(nb + j) * H + me.head] = acc;
}

template <int HP, SHAPE_PARAMS>
__device__ void rows(const Args& a, RowSmem<HP, SHAPE>& sm, int rb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = a.N, H = a.H, D = H * HD;
  const int i = rb * WARPS + warp;
  if (i >= N) return;             // no barrier in this role
  const size_t nb = (size_t)blockIdx.y * N;
  const size_t r = nb + i;
  const Slot<HP> me(lane, H);

  float gi[HP], oi[HP];
  me.load(a.g + r * D, gi, lane);
  me.load(a.out + r * D, oi, lane);
  float acc = 0.f;  // this lane's share of de_src of its head
  const MaskRow row(batch_mask(a.adj, a.adj_bstride, a.adj_rep, a.adj_count,
                               blockIdx.y) +
                        (size_t)i * N,
                    N);
  for (int s = 0; s < row.sweeps(); ++s) {
    const int cnt = row.compact(s, lane, sm.cols[warp]);
    __syncwarp();
    const int col0 = row.col0(s);
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int n = min(32, cnt - c0);
      bool pos[HP];
      if (lane < n) {
        const size_t jr = nb + (size_t)(col0 + sm.cols[warp][c0 + lane]);
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          pos[h] = false;
          if (h >= H) continue;
          const float pre = a.e_src[r * H + h] + a.e_dst[jr * H + h];
          sm.alpha[warp][lane * HP + h] = expf(leaky(pre) - a.m[r * H + h]) /
                                          fmaxf(a.l[r * H + h], 1e-30f);
          pos[h] = pre >= 0.f;
        }
      }
      const unsigned posb = pos_bits(me, pos, n, lane, H);
      __syncwarp();
      for (int k0 = 0; k0 < n; k0 += BATCH) {
        float zv[BATCH][HP];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (k0 + u >= n) break;
          const size_t jr = nb + (size_t)(col0 + sm.cols[warp][c0 + k0 + u]);
          me.load(a.z + jr * D, zv[u], lane);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int k = k0 + u;
          if (k >= n) break;
          acc = fmaf(dpre_weight(sm.alpha[warp][k * HP + me.head], posb, k),
                     dot_diff(gi, zv[u], oi), acc);
        }
      }
      __syncwarp();               // cols and alpha are rewritten next
    }
  }
  acc = Slot<HP>::head_sum(acc);
  if (me.leader(lane)) a.de_src[r * H + me.head] = acc;
}

template <int HP, SHAPE_PARAMS>
__global__ void __launch_bounds__(32 * WARPS) gat_bwd_kernel(Args a) {
  __shared__ BwdSmem<HP, SHAPE> sm;
  const int nblk = (a.N + WARPS - 1) / WARPS;
  if ((int)blockIdx.x < nblk)
    columns<HP, SHAPE>(a, sm.col, blockIdx.x);
  else
    rows<HP, SHAPE>(a, sm.row, blockIdx.x - nblk);
}

template <int HP, SHAPE_PARAMS>
int launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(2 * ((a.N + WARPS - 1) / WARPS), B);
  gat_bwd_kernel<HP, SHAPE><<<grid, 32 * WARPS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the compiled set, BWD_SHAPES in kernels/gat_mp/ops.py
template <int HP>
int launch_shape(const Args& a, int B, int warps, int rch, int batch,
                 cudaStream_t s) {
#define SHAPE_CASE(W, R, BT)                 \
  if (warps == W && rch == R && batch == BT) \
    return launch<HP, W, R, BT>(a, B, s);
  SHAPE_CASE(8, 512, 2)
  SHAPE_CASE(8, 256, 2)
  SHAPE_CASE(4, 512, 2)
  SHAPE_CASE(4, 256, 2)
  SHAPE_CASE(8, 512, 1)
  SHAPE_CASE(4, 512, 1)
#undef SHAPE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gat_mp_bwd(const float* z, const float* e_src,
                          const float* e_dst, const unsigned char* adj,
                          long long adj_bstride, int adj_rep,
                          int adj_count, const float* m,
                          const float* l, const float* out, const float* g,
                          float* dz, float* de_src, float* de_dst, int B,
                          int N, int H, int warps, int rch, int batch,
                          void* stream) {
  if (H < 1 || H > MAX_HEADS || B < 1 || N < 1 || B > 65535 || adj_rep < 1 ||
      adj_count < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{z, e_src, e_dst, adj, adj_bstride, adj_rep, adj_count,
               m, l, out, g,
               dz, de_src, de_dst, N, H};
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 1) return launch_shape<1>(a, B, warps, rch, batch, s);
  if (H == 2) return launch_shape<2>(a, B, warps, rch, batch, s);
  if (H <= 4) return launch_shape<4>(a, B, warps, rch, batch, s);
  return launch_shape<8>(a, B, warps, rch, batch, s);
}
