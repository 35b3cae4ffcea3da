// Mamba2 SSD scan, chunked form: the backward, on the tensor cores.
//
// Replaces what JAX's autodiff of repro.models.mamba2.ssd_chunked
// (src/repro/models/mamba2.py:77) computes in XLA; the Pallas forward
// (src/repro/kernels/ssd_scan/ssd_scan.py `_kernel`) has no backward.  The
// forward (ssd_scan.cu) evaluates, per batch b, head h and chunk c of Q
// steps (cum the in-chunk cumsum of la, total its last entry, prev the
// state entering the chunk, L_ij = exp(cum_i - cum_j) for j <= i, else 0):
//   y    = (C B^T o L) xd + diag(exp(cum)) C prev
//   next = exp(total) prev + B^T diag(exp(total - cum)) xd
// From dy and the final state's cotangent (or none: zero), with
// G = dprev_{c+1} the cotangent of the state leaving chunk c, this gives
//   dprev_c = exp(total) G + C^T diag(exp(cum)) dy      (dinit = dprev_0)
//   dxd = (C B^T o L)^T dy + diag(exp(total - cum)) B G
//   dC  = W B + diag(exp(cum)) dy prev^T,   W = (dy xd^T) o L
//   dB  = W^T C + diag(exp(total - cum)) xd G^T
// (dB and dC summed over the heads, which share B and C) and
//   dcum_t = rowsum_t(W o C B^T) - colsum_t(W o C B^T)
//            + exp(cum_t) dy_t . (C_t prev) - exp(total - cum_t) xd_t . (B_t G)
//   dtotal = exp(total) <prev, G> + sum_j exp(total - cum_j) xd_j . (B_j G)
// added to the chunk's last dcum; dla is the in-chunk reverse cumsum of
// dcum.  All f32; what JAX's autodiff gives (tests/test_torch_ssd_bwd.py).
//
// What bounds it on an H100: operations, as the forward.  Five launches,
// the forward's three mirrored:
//   1. ssd_bwd_state_kernel, parallel over (b, chunk, head, 64 state
//      rows): each chunk's own part u_c = C^T diag(exp(cum)) dy.
//   2. ssd_bwd_pass_kernel, sequential over the chunks of each (b, h) in
//      reverse, a thread per state element: u_c is replaced by G_c, and
//      dprev_c = exp(total_c) G_c + u_c carried down; dinit.  The forward
//      saved each chunk's incoming state (`states`), its totals and its
//      C B^T, so nothing of the forward's pass is redone.
//   3. ssd_bwd_chunk_kernel, parallel over (chunk, b * H + h, 3 x Q/64
//      tiles): three roles a block, a 64-row tile each.  "dxd" blocks own
//      columns j of the chunk (dxd, the xd . (B G) terms); "dB" blocks own
//      columns j (this head's dB, the column sums); "dC" blocks own rows i
//      (this head's dC, the row sums, the dy . (C prev) terms).  dB and dC
//      blocks form W's 64 x 64 tiles from dy xd^T themselves (each tile
//      twice over the two roles, and once per 64 columns of d_state).
//   4. ssd_bwd_dla_kernel, per (chunk, b, h): dcum from the three roles'
//      parts, dtotal, the reverse cumsum.
//   5. ssd_bwd_heads_kernel: dB and dC, each head's part summed over the
//      heads in order.
// No atomics: every sum runs in a fixed order, so two launches on the
// same inputs give the same bits.  The head sums take per-head parts in
// scratch and a second pass (5), not one block over all heads.  Every
// product is 3xTF32 on mma.sync.m16n8k8 (ssd_common.cuh), as in the
// forward: one TF32 pass would not hold 1e-4 of the largest element.
// Operand tiles are staged in shared memory by plain loads with the
// elementwise factors (decays, masks, transposes) applied on the way in,
// one tile at a time (no cp.async pipeline yet: this is the simple
// version).  Every decay is exp of a difference, as in the forward: in a
// chunk |cum| can pass 88, where exp(cum_i) exp(-cum_j) would overflow.
// Masked entries are selected away, never multiplied by 0, so nothing of
// C B^T above the diagonal (left unwritten by the forward) is read into a
// sum.
//
// C interface for ctypes: pointers are device pointers.  xd, la, Bm, Cm
// as the forward takes them; states (B * S/Q * H * N * hd: the state
// entering each chunk), totals (B * S/Q * H) and cb (B * S/Q * QP * QP)
// as the forward leaves its scratch; dy (B, S, H, hd); dfinal (B, H, N,
// hd) or null (zero); scratch dst (B * S/Q * H * N * hd), dBh and dCh (B *
// S * H * N each), parts (3 * B * S * H); outputs dxd, dla, dB, dC and
// dinit (null: not wanted).  Returns the CUDA error code of the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int RT = 64;           // rows (and columns) of a chunk tile
constexpr int SA = RT + 4;       // stride of a [64][64] tile

struct Dims {
  int Bb, S, H, N, Q, nc, QP;
};

// f(r, c) into dst[r * ds + c] for r < ROWS, c < COLS, by every thread;
// consecutive threads take consecutive c, or consecutive r if R_FAST
// (whichever walks contiguous global memory)
template <int ROWS, int COLS, bool R_FAST, class F>
__device__ __forceinline__ void stage(float* dst, int ds, F f) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
    const int r = R_FAST ? e % ROWS : e / COLS;
    const int c = R_FAST ? e / ROWS : e % COLS;
    dst[r * ds + c] = f(r, c);
  }
}

// acc (64 rows x 16 NTW columns) += A B over K (a multiple of 8), a(m, k)
// and b(k, n) reading the staged operands.  Warp w owns rows 16 (w % 4)
// + g, + 8 and columns 8 NTW (w / 4) + 8 nt + 2 t, + 1 (g = lane / 4,
// t = lane % 4): the m16n8k8 accumulator layout.
template <int NTW, class FA, class FB>
__device__ __forceinline__ void block_mma(float (&acc)[NTW][4], int K,
                                          FA a, FB b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp & 3) * 16 + g, c0 = (warp >> 2) * NTW * 8 + g;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    AFrag fa;
    fa.set(a(ra, k + t), a(ra + 8, k + t), a(ra, k + t + 4),
           a(ra + 8, k + t + 4));
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      mma3(acc[nt], fa, b(k + t, c0 + nt * 8), b(k + t + 4, c0 + nt * 8));
  }
}

// the row and column of accumulator entry acc[nt][e]
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         (e >= 2 ? 8 : 0);
}
template <int NTW>
__device__ __forceinline__ int acc_col(int nt, int e) {
  return (threadIdx.x >> 7) * NTW * 8 + nt * 8 + 2 * (threadIdx.x & 3) +
         (e & 1);
}

template <int NTW>
__device__ __forceinline__ void zero(float (&acc)[NTW][4]) {
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// la of (b, h) for the chunk starting at step t0 into cum_s[0, QP) (zero
// past Q), then its inclusive cumsum (one warp); the block is synced
__device__ __forceinline__ void chunk_cumsum(float* cum_s, const float* la,
                                             size_t t0, int h, int H, int Q,
                                             int QP) {
  for (int i = threadIdx.x; i < QP; i += THREADS)
    cum_s[i] = i < Q ? la[(t0 + i) * H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(cum_s, QP, threadIdx.x);
  __syncthreads();
}

// per-row sums of a 64-row accumulator's entries times v(row, col): each
// thread's entries, then its quad (the lanes sharing a row), then the two
// warps sharing rows in red[2][64]; thread r < 64 gets row r's sum
template <int NTW, class V>
__device__ __forceinline__ float row_dot(const float (&acc)[NTW][4],
                                         float* red, V v) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e >> 1] += acc[nt][e] * v(acc_row(e), acc_col<NTW>(nt, e));
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    s[u] += __shfl_xor_sync(FULL, s[u], 1);
    s[u] += __shfl_xor_sync(FULL, s[u], 2);
  }
  if ((threadIdx.x & 3) == 0) {
    const int half = threadIdx.x >> 7;
    red[half * RT + acc_row(0)] = s[0];
    red[half * RT + acc_row(2)] = s[1];
  }
  __syncthreads();
  const float r = threadIdx.x < RT ? red[threadIdx.x] + red[RT + threadIdx.x]
                                   : 0.f;
  __syncthreads();
  return r;
}

// the sum of v over the block's threads, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// ------------------------------------------ 1. each chunk's own dprev part
// Block (64 state rows n0.., chunk c, b * H + h):
//   u[n, p] = sum_i C[i, n] exp(cum_i) dy[i, p]
template <int HD>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_kernel(const float* __restrict__ la, const float* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ dst,
                     Dims d) {
  constexpr int SB = HD + 8;
  extern __shared__ __align__(16) float sm[];
  float* cum_s = sm;                   // QP
  float* As = cum_s + d.QP;            // 64 x SA: [n][i]
  float* Bs = As + RT * SA;            // 64 x SB: [i][p]
  const int n0 = blockIdx.x * RT, c = blockIdx.y;
  const int b = blockIdx.z / d.H, h = blockIdx.z % d.H;
  const size_t t0 = (size_t)b * d.S + (size_t)c * d.Q;
  const int H = d.H, N = d.N, Q = d.Q;
  chunk_cumsum(cum_s, la, t0, h, H, Q, d.QP);
  for (int i = threadIdx.x; i < d.QP; i += THREADS)
    cum_s[i] = i < Q ? __expf(cum_s[i]) : 0.f;
  __syncthreads();

  float acc[HD / 16][4];
  zero(acc);
  for (int i0 = 0; i0 < Q; i0 += RT) {
    stage<RT, RT, true>(As, SA, [&](int n, int i) {
      return i0 + i < Q && n0 + n < N
                 ? Cm[(t0 + i0 + i) * N + n0 + n] * cum_s[i0 + i] : 0.f;
    });
    stage<RT, HD, false>(Bs, SB, [&](int i, int p) {
      return i0 + i < Q ? dy[((t0 + i0 + i) * H + h) * HD + p] : 0.f;
    });
    __syncthreads();
    block_mma(acc, RT, [&](int m, int k) { return As[m * SA + k]; },
              [&](int k, int n) { return Bs[k * SB + n]; });
    __syncthreads();
  }
  float* out = dst + (((size_t)b * d.nc + c) * H + h) * N * HD;
#pragma unroll
  for (int nt = 0; nt < HD / 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + acc_row(e);
      if (n < N) out[(size_t)n * HD + acc_col<HD / 16>(nt, e)] = acc[nt][e];
    }
}

// ------------------------------------- 2. passing the state's cotangent
// thread e of block (x, b * H + h) walks state element e of (b, h) over
// the chunks in reverse: dst holds u_c, which is replaced by G_c (the
// cotangent of the state leaving chunk c), and dprev_c = exp(total_c) G_c
// + u_c is carried down; dinit = dprev_0
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(float* __restrict__ dst, const float* __restrict__ totals,
                    const float* __restrict__ dfinal,
                    float* __restrict__ dinit, int nc, int H, int NH) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= NH) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  float g = dfinal ? dfinal[(size_t)bh * NH + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t row = ((size_t)b * nc + c) * H + h;
    const float u = dst[row * NH + e];
    dst[row * NH + e] = g;
    g = g * expf(totals[row]) + u;
  }
  if (dinit) dinit[(size_t)bh * NH + e] = g;
}

// --------------------------------------------- 3. the chunk's gradients
// Block (chunk c, b * H + h, z): z / (QP / 64) is the role, z % (QP / 64)
// the tile.  See the header for what each role writes; parts holds
// rowpart (rowsum + dy . (C prev) terms), colpart (- colsum) and sterm
// (the xd . (B G) terms), each (B, S, H).
template <int HD>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const float* __restrict__ xd, const float* __restrict__ la,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ states,
                     const float* __restrict__ cb, const float* __restrict__ dy,
                     const float* __restrict__ dst, float* __restrict__ dxd,
                     float* __restrict__ dBh, float* __restrict__ dCh,
                     float* __restrict__ parts, Dims d) {
  constexpr int NTW = HD / 16;
  constexpr int KC = HD < RT ? HD : RT;      // a step over hd
  constexpr int SB = (HD > RT ? HD : RT) + 8;
  extern __shared__ __align__(16) float sm[];
  const int QP = d.QP;
  float* cum_s = sm;                   // QP: cum
  float* ecum = cum_s + QP;            // QP: exp(cum)
  float* erev = ecum + QP;             // QP: exp(total - cum)
  float* As = erev + QP;               // 64 x SA
  float* Bs = As + RT * SA;            // 64 x SB
  float* Ws = Bs + RT * SB;            // 64 x SA: W's tile [i][j]
  float* Ps = Ws + RT * SA;            // 64 x SA: W o C B^T
  float* red = Ps + RT * SA;           // 2 x 64

  const int H = d.H, N = d.N, Q = d.Q;
  const int ntile = QP / RT;
  const int c = blockIdx.x, b = blockIdx.y / H, h = blockIdx.y % H;
  const int role = blockIdx.z / ntile, tile = blockIdx.z % ntile;
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t bch = ((size_t)b * d.nc + c) * H + h;
  const float* G = dst + bch * N * HD;
  const float* prev = states + bch * N * HD;
  const float* cbc = cb + ((size_t)b * d.nc + c) * QP * QP;
  float* rowpart = parts;
  float* colpart = parts + (size_t)d.Bb * d.S * H;
  float* sterm = colpart + (size_t)d.Bb * d.S * H;
  const int tid = threadIdx.x;
  auto xd_at = [&](int i, int p) { return xd[((t0 + i) * H + h) * HD + p]; };
  auto dy_at = [&](int i, int p) { return dy[((t0 + i) * H + h) * HD + p]; };

  chunk_cumsum(cum_s, la, t0, h, H, Q, QP);
  const float total = cum_s[Q - 1];
  for (int i = tid; i < QP; i += THREADS) {
    ecum[i] = i < Q ? __expf(cum_s[i]) : 0.f;
    erev[i] = i < Q ? __expf(total - cum_s[i]) : 0.f;
  }
  __syncthreads();

  auto mma_a = [&](int m, int k) { return As[m * SA + k]; };
  auto mma_b = [&](int k, int n) { return Bs[k * SB + n]; };

  // accM = dy_I xd_J^T (64 x 64), hd in steps of KC
  auto m_tile = [&](float (&accM)[4][4], int i0, int j0) {
    zero(accM);
    for (int p0 = 0; p0 < HD; p0 += KC) {
      stage<RT, KC, false>(As, SA, [&](int i, int p) {
        return i0 + i < Q ? dy_at(i0 + i, p0 + p) : 0.f;
      });
      stage<KC, RT, true>(Bs, SB, [&](int p, int j) {
        return j0 + j < Q ? xd_at(j0 + j, p0 + p) : 0.f;
      });
      __syncthreads();
      block_mma(accM, KC, mma_a, mma_b);
      __syncthreads();
    }
  };
  // Ws = accM o L, masked (j <= i < Q); Ps = Ws o C B^T if with_p
  auto w_tile = [&](const float (&accM)[4][4], int i0, int j0, bool with_p) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(e), cc = acc_col<4>(nt, e);
        const int i = i0 + r, j = j0 + cc;
        const bool ok = j <= i && i < Q;
        const float w =
            ok ? accM[nt][e] * __expf(cum_s[i] - cum_s[j]) : 0.f;
        Ws[r * SA + cc] = w;
        if (with_p) Ps[r * SA + cc] = ok ? w * cbc[(size_t)i * QP + j] : 0.f;
      }
    __syncthreads();
  };

  if (role == 0) {
    // ---------------- dxd of columns J, and the xd . (B G) terms
    const int j0 = tile * RT;
    float acc[NTW][4], acc2[NTW][4];
    zero(acc);
    zero(acc2);
    for (int i0 = j0; i0 < Q; i0 += RT) {
      // A[j][i] = (C B^T o L)[i][j]
      stage<RT, RT, true>(As, SA, [&](int j, int i) {
        const int ii = i0 + i, jj = j0 + j;
        return jj <= ii && ii < Q
                   ? cbc[(size_t)ii * QP + jj] * __expf(cum_s[ii] - cum_s[jj])
                   : 0.f;
      });
      stage<RT, HD, false>(Bs, SB, [&](int i, int p) {
        return i0 + i < Q ? dy_at(i0 + i, p) : 0.f;
      });
      __syncthreads();
      block_mma(acc, RT, mma_a, mma_b);
      __syncthreads();
    }
    for (int n0 = 0; n0 < N; n0 += RT) {     // B_J G
      stage<RT, RT, false>(As, SA, [&](int j, int n) {
        return j0 + j < Q && n0 + n < N ? Bm[(t0 + j0 + j) * N + n0 + n]
                                        : 0.f;
      });
      stage<RT, HD, false>(Bs, SB, [&](int n, int p) {
        return n0 + n < N ? G[(size_t)(n0 + n) * HD + p] : 0.f;
      });
      __syncthreads();
      block_mma(acc2, RT, mma_a, mma_b);
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + acc_row(e);
        if (j < Q)
          dxd[((t0 + j) * H + h) * HD + acc_col<NTW>(nt, e)] =
              acc[nt][e] + erev[j] * acc2[nt][e];
      }
    const float s = row_dot(acc2, red, [&](int r, int p) {
      return j0 + r < Q ? xd_at(j0 + r, p) : 0.f;
    });
    if (tid < RT && j0 + tid < Q)
      sterm[(t0 + j0 + tid) * H + h] = erev[j0 + tid] * s;
    return;
  }

  float accM[4][4], acc[4][4];
  if (role == 1) {
    // ---------------- this head's dB of columns J, the column sums
    const int j0 = tile * RT;
    float colsum = 0.f;
    for (int n0 = 0; n0 < N; n0 += RT) {
      zero(acc);
      for (int i0 = j0; i0 < Q; i0 += RT) {
        m_tile(accM, i0, j0);
        w_tile(accM, i0, j0, n0 == 0);
        if (n0 == 0 && tid < RT)
          for (int r = 0; r < RT; ++r) colsum += Ps[r * SA + tid];
        stage<RT, RT, false>(Bs, SB, [&](int i, int n) {
          return i0 + i < Q && n0 + n < N ? Cm[(t0 + i0 + i) * N + n0 + n]
                                          : 0.f;
        });
        __syncthreads();
        block_mma(acc, RT, [&](int m, int k) { return Ws[k * SA + m]; },
                  mma_b);                           // W^T C
        __syncthreads();
      }
      for (int p0 = 0; p0 < HD; p0 += KC) {         // diag(erev) xd G^T
        stage<RT, KC, false>(As, SA, [&](int j, int p) {
          return j0 + j < Q ? xd_at(j0 + j, p0 + p) * erev[j0 + j] : 0.f;
        });
        stage<KC, RT, true>(Bs, SB, [&](int p, int n) {
          return n0 + n < N ? G[(size_t)(n0 + n) * HD + p0 + p] : 0.f;
        });
        __syncthreads();
        block_mma(acc, KC, mma_a, mma_b);
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + acc_row(e), n = n0 + acc_col<4>(nt, e);
          if (j < Q && n < N) dBh[((t0 + j) * H + h) * N + n] = acc[nt][e];
        }
    }
    if (tid < RT && j0 + tid < Q) colpart[(t0 + j0 + tid) * H + h] = -colsum;
    return;
  }

  // ------------------ this head's dC of rows I, the row sums and the
  // dy . (C prev) terms; the longest tiles first
  const int i0 = (ntile - 1 - tile) * RT;
  float rowsum = 0.f, rterm = 0.f;
  for (int n0 = 0; n0 < N; n0 += RT) {
    zero(acc);
    for (int j0 = 0; j0 <= i0; j0 += RT) {
      m_tile(accM, i0, j0);
      w_tile(accM, i0, j0, n0 == 0);
      if (n0 == 0 && tid < RT)
        for (int cc = 0; cc < RT; ++cc) rowsum += Ps[tid * SA + cc];
      stage<RT, RT, false>(Bs, SB, [&](int j, int n) {
        return j0 + j < Q && n0 + n < N ? Bm[(t0 + j0 + j) * N + n0 + n]
                                        : 0.f;
      });
      __syncthreads();
      block_mma(acc, RT, [&](int m, int k) { return Ws[m * SA + k]; },
                mma_b);                             // W B
      __syncthreads();
    }
    float accI[4][4];                               // diag(ecum) dy prev^T
    zero(accI);
    for (int p0 = 0; p0 < HD; p0 += KC) {
      stage<RT, KC, false>(As, SA, [&](int i, int p) {
        return i0 + i < Q ? dy_at(i0 + i, p0 + p) * ecum[i0 + i] : 0.f;
      });
      stage<KC, RT, true>(Bs, SB, [&](int p, int n) {
        return n0 + n < N ? prev[(size_t)(n0 + n) * HD + p0 + p] : 0.f;
      });
      __syncthreads();
      block_mma(accI, KC, mma_a, mma_b);
      __syncthreads();
    }
    rterm += row_dot(accI, red, [&](int r, int n) {
      return i0 + r < Q && n0 + n < N ? Cm[(t0 + i0 + r) * N + n0 + n] : 0.f;
    });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + acc_row(e), n = n0 + acc_col<4>(nt, e);
        if (i < Q && n < N)
          dCh[((t0 + i) * H + h) * N + n] = acc[nt][e] + accI[nt][e];
      }
  }
  if (tid < RT && i0 + tid < Q)
    rowpart[(t0 + i0 + tid) * H + h] = rowsum + rterm;
}

// ---------------------------------------------------------- 4. dla
// Block (chunk c, b * H + h): dcum = rowpart + colpart - sterm, the
// chunk's last entry plus dtotal = exp(total) <prev, G> + sum sterm, and
// dla its reverse cumsum within the chunk
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dla_kernel(const float* __restrict__ states,
                   const float* __restrict__ totals,
                   const float* __restrict__ dst,
                   const float* __restrict__ parts, float* __restrict__ dla,
                   Dims d, int NH) {
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;                     // QP: dcum reversed, then its cumsum
  float* red = r_s + d.QP;             // THREADS
  const int c = blockIdx.x, b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int H = d.H, Q = d.Q;
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t bch = ((size_t)b * d.nc + c) * H + h;
  const size_t plane = (size_t)d.Bb * d.S * H;
  const float* rowpart = parts;
  const float* colpart = parts + plane;
  const float* sterm = colpart + plane;
  float dot = 0.f, ssum = 0.f;
  for (int e = threadIdx.x; e < NH; e += THREADS)
    dot += states[bch * NH + e] * dst[bch * NH + e];
  for (int i = threadIdx.x; i < Q; i += THREADS)
    ssum += sterm[(t0 + i) * H + h];
  dot = block_sum(dot, red);
  ssum = block_sum(ssum, red);
  const float dtotal = expf(totals[bch]) * dot + ssum;
  for (int i = threadIdx.x; i < d.QP; i += THREADS) {
    float v = 0.f;
    if (i < Q) {
      const int t = Q - 1 - i;         // reversed
      const size_t k = (t0 + t) * H + h;
      v = rowpart[k] + colpart[k] - sterm[k] + (t == Q - 1 ? dtotal : 0.f);
    }
    r_s[i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(r_s, d.QP, threadIdx.x);
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += THREADS)
    dla[(t0 + t) * H + h] = r_s[Q - 1 - t];
}

// ------------------------------------------------ 5. dB, dC over heads
// element (b, t, n) of dB (blockIdx.y = 0) or dC (1): its heads' parts
// summed in order
__global__ void __launch_bounds__(THREADS)
ssd_bwd_heads_kernel(const float* __restrict__ dBh,
                     const float* __restrict__ dCh, float* __restrict__ dB,
                     float* __restrict__ dC, size_t rows, int H, int N) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= rows * N) return;
  const float* src = blockIdx.y ? dCh : dBh;
  const size_t bt = idx / N, n = idx % N;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[(bt * H + h) * N + n];
  (blockIdx.y ? dC : dB)[idx] = s;
}

size_t chunk_smem(int QP, int hd) {
  const int sb = (hd > RT ? hd : RT) + 8;
  return ((size_t)3 * QP + 3 * RT * SA + (size_t)RT * sb + 2 * RT) *
         sizeof(float);
}

size_t state_smem(int QP, int hd) {
  return ((size_t)QP + RT * SA + (size_t)RT * (hd + 8)) * sizeof(float);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
int launch(const float* xd, const float* la, const float* Bm, const float* Cm,
           const float* states, const float* totals, const float* cb,
           const float* dy, const float* dfinal, float* dst, float* dBh,
           float* dCh, float* parts, float* dxd, float* dla, float* dB,
           float* dC, float* dinit, Dims d, cudaStream_t st) {
  const size_t sm1 = state_smem(d.QP, HD), sm3 = chunk_smem(d.QP, HD);
  const size_t sm4 = ((size_t)d.QP + THREADS) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_state_kernel<HD>, sm1)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_chunk_kernel<HD>, sm3)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dla_kernel, sm4)) != cudaSuccess)
    return (int)err;
  ssd_bwd_state_kernel<HD><<<dim3((d.N + RT - 1) / RT, d.nc, d.Bb * d.H),
                             THREADS, sm1, st>>>(la, Cm, dy, dst, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int NH = d.N * HD;
  ssd_bwd_pass_kernel<<<dim3((NH + THREADS - 1) / THREADS, d.Bb * d.H),
                        THREADS, 0, st>>>(dst, totals, dfinal, dinit, d.nc,
                                          d.H, NH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<HD><<<dim3(d.nc, d.Bb * d.H, 3 * (d.QP / RT)),
                             THREADS, sm3, st>>>(
      xd, la, Bm, Cm, states, cb, dy, dst, dxd, dBh, dCh, parts, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dla_kernel<<<dim3(d.nc, d.Bb * d.H), THREADS, sm4, st>>>(
      states, totals, dst, parts, dla, d, NH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t rows = (size_t)d.Bb * d.S;
  ssd_bwd_heads_kernel<<<dim3((unsigned)((rows * d.N + THREADS - 1) /
                                         THREADS), 2),
                         THREADS, 0, st>>>(dBh, dCh, dB, dC, rows, d.H, d.N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bwd(const float* xd, const float* la, const float* Bm,
                            const float* Cm, const float* states,
                            const float* totals, const float* cb,
                            const float* dy, const float* dfinal, float* dst,
                            float* dBh, float* dCh, float* parts, float* dxd,
                            float* dla, float* dB, float* dC, float* dinit,
                            int Bb, int S, int H, int hd, int N, int Q,
                            void* stream) {
  if (Bb < 1 || S < 1 || H < 1 || N < 1 || N > 256 || Q < 1 || S % Q ||
      S / Q > 65535 || (long long)Bb * H > 65535 ||
      3LL * (round_up(Q, RT) / RT) > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d{Bb, S, H, N, Q, S / Q, round_up(Q, RT)};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define SSD_BWD_CASE(HD)                                                   \
  case HD:                                                                 \
    return launch<HD>(xd, la, Bm, Cm, states, totals, cb, dy, dfinal, dst, \
                      dBh, dCh, parts, dxd, dla, dB, dC, dinit, d, st);
    SSD_BWD_CASE(16)
    SSD_BWD_CASE(32)
    SSD_BWD_CASE(64)
    SSD_BWD_CASE(128)
#undef SSD_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
