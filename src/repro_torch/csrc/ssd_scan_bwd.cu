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
// and, B and C being shared by the heads, with W_h = (dy_h xd_h^T) o L_h
// and dS = sum_h W_h,
//   dC  = dS B + sum_h diag(exp(cum_h)) dy_h prev_h^T
//   dB  = dS^T C + sum_h diag(exp(total_h - cum_h)) xd_h G_h^T
//   dcum_t = rowsum_t(W o C B^T) - colsum_t(W o C B^T)
//            + exp(cum_t) dy_t . (C_t prev) - exp(total - cum_t) xd_t . (B_t G)
//   dtotal = exp(total) <prev, G> + sum_j exp(total - cum_j) xd_j . (B_j G)
// (dcum per head) added to the chunk's last dcum; dla is the in-chunk
// reverse cumsum of dcum.  All f32; what JAX's autodiff gives
// (tests/test_torch_ssd_bwd.py, which also holds this decomposition).
//
// What bounds it on an H100: operations, as the forward.  Six launches:
//   1. ssd_bwd_state_kernel, parallel over (b, chunk, head, 64 state
//      rows): each chunk's own part u_c = C^T diag(exp(cum)) dy; its first
//      blocks also write cum to scratch for the other kernels.
//   2. ssd_bwd_pass_kernel, sequential over the chunks of each (b, h) in
//      reverse, a thread per state element: u_c is replaced by G_c, and
//      dprev_c = exp(total_c) G_c + u_c carried down; dinit.  The forward
//      saved each chunk's incoming state (`states`), its totals and its
//      C B^T, so nothing of the forward's pass is redone.
//   3. ssd_bwd_w_kernel, a block per (b, chunk, row tile I, group of HG
//      heads): each head's W tiles (I, J <= I) formed once; their row
//      sums of W o C B^T completed in the block, their column sums (this
//      row tile's share) and the group's dS tiles (W summed over the
//      group's heads in order) written to scratch.
//   4. ssd_bwd_dxd_kernel, a block per (b, chunk, head, column tile J):
//      dxd and the xd . (B G) terms.
//   5. ssd_bwd_ds_kernel, a block per (b, chunk, 64 columns of d_state,
//      row tile; dC or dB): the head sums as one product over K = H hd
//      (for dC, what each head adds to the rows is dotted with C for its
//      dy . (C prev) terms), then dS B or dS^T C, each dS tile staged by
//      adding the groups' partials in group order.
//   6. ssd_bwd_dla_kernel, per (chunk, b, h): dcum from the parts, dtotal,
//      the reverse cumsum.
// No atomics: every sum runs in a fixed order, so two launches on the
// same inputs give the same bits.  Every product is 3xTF32 on
// mma.sync.m16n8k8 (ssd_common.cuh), as in the forward: one TF32 pass
// would not hold 1e-4 of the largest element.  (wgmma was tried and
// measured slower: the time goes to staging tiles, not to the tensor
// cores; PERF.md.)  Operand tiles come by cp.async, NS = 2 stages in
// flight; each staged tile gets its elementwise factors (decays, masks)
// and its hi / lo split once, four entries a thread at a time, the hi
// part in place and the lo part into a plane beside it, so the MMA loops
// only load fragments and issue MMAs.  Tiles are stored as they lie in
// device memory, and their row stride is picked for how the MMA reads
// them (s_rowk, s_colk: conflict-free fragment loads either way), so a
// transposed operand costs nothing.  Every decay is exp of a difference,
// as in the forward: in a chunk |cum| can pass 88, where exp(cum_i)
// exp(-cum_j) would overflow.  Masked entries are selected away, never
// multiplied by 0, so nothing of C B^T above the diagonal (left unwritten
// by the forward) is read into a sum.
//
// C interface for ctypes: pointers are device pointers.  xd, la, Bm, Cm
// as the forward takes them; states (B * S/Q * H * N * hd: the state
// entering each chunk), totals (B * S/Q * H) and cb (B * S/Q * QP * QP)
// as the forward leaves its scratch; dy (B, S, H, hd); dfinal (B, H, N,
// hd) or null (zero); scratch dst (B * S/Q * H * N * hd), dsg (NG * B *
// S/Q * QP * QP, NG = ceil(H / HG)) and parts ((3 + QP/64 + ceil(N/64)) *
// B * S * H: cum, row sums, xd . (B G) terms, column sums per row tile,
// dy . (C prev) terms per 64 columns of d_state); outputs dxd, dla, dB,
// dC and dinit (null: not wanted).  Returns the CUDA error code of the
// launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int RT = 64;           // rows (and columns) of a chunk tile
constexpr int NS = 2;            // tiles in flight (cp.async groups)
constexpr int HG = 8;            // heads of a group in ssd_bwd_w_kernel

// row strides of a staged tile of `cols` columns, by how the MMA reads
// it: a row holding the reduction dimension K ([m][k] or [n][k]), or
// holding M or N ([k][m] or [k][n])
__host__ __device__ constexpr int s_rowk(int cols) { return cols + 4; }
__host__ __device__ constexpr int s_colk(int cols) { return cols + 8; }

struct Dims {
  int Bb, S, H, N, Q, nc, QP, NG;
};

// entries (r, c) of a staged ROWS x COLS tile t (stride s, a multiple of
// 4) become the tf32 hi part of f(r, c, t[r][c]), in place, and its lo
// part at the same offset in lo; four columns a thread at a time
template <int ROWS, int COLS, class F>
__device__ __forceinline__ void split_tile(float* t, uint32_t* lo, int s,
                                           F f) {
#pragma unroll 2
  for (int e = threadIdx.x; e < ROWS * COLS / 4; e += THREADS) {
    const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
    float* q = t + r * s + c;
    const float4 v = *reinterpret_cast<const float4*>(q);
    uint4 hi, l;
    split(f(r, c, v.x), hi.x, l.x);
    split(f(r, c + 1, v.y), hi.y, l.y);
    split(f(r, c + 2, v.z), hi.z, l.z);
    split(f(r, c + 3, v.w), hi.w, l.w);
    *reinterpret_cast<uint4*>(q) = hi;
    *reinterpret_cast<uint4*>(lo + r * s + c) = l;
  }
}

// the identity as split_tile's f
struct Keep {
  __device__ __forceinline__ float operator()(int, int, float x) const {
    return x;
  }
};

// acc (64 rows x 16 NTW columns) += A B over K (a multiple of 8) in
// 3xTF32 from split tiles: A's hi at ah, lo at al, stride sa, stored
// [m][k] (or [k][m] if AT); B's at bh, bl, stride sb, stored [n][k] (or
// [k][n] if BT).  Warp w owns rows 16 (w % 4) + g, + 8 and columns
// 8 NTW (w / 4) + 8 nt + 2 t, + 1 (g = lane / 4, t = lane % 4): the
// m16n8k8 accumulator layout.  The two small cross terms first, then
// hi * hi, as the forward's mma3.
template <int NTW, int K, bool AT, bool BT>
__device__ __forceinline__ void mma_split(float (&acc)[NTW][4],
                                          const float* ah_, const uint32_t* al,
                                          int sa, const float* bh_,
                                          const uint32_t* bl, int sb) {
  const uint32_t* ah = reinterpret_cast<const uint32_t*>(ah_);
  const uint32_t* bh = reinterpret_cast<const uint32_t*>(bh_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp & 3) * 16 + g, c0 = (warp >> 2) * NTW * 8 + g;
  auto ai = [&](int m, int k) { return AT ? k * sa + m : m * sa + k; };
  auto bi = [&](int k, int n) { return BT ? k * sb + n : n * sb + k; };
#pragma unroll 1
  for (int k = 0; k < K; k += 8) {
    const int i0 = ai(ra, k + t), i1 = ai(ra + 8, k + t);
    const int i2 = ai(ra, k + t + 4), i3 = ai(ra + 8, k + t + 4);
    const uint32_t hi[4] = {ah[i0], ah[i1], ah[i2], ah[i3]};
    const uint32_t lo[4] = {al[i0], al[i1], al[i2], al[i3]};
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int j0 = bi(k + t, c0 + nt * 8), j1 = bi(k + t + 4, c0 + nt * 8);
      const uint32_t bh0 = bh[j0], bh1 = bh[j1];
      mma_tf32(acc[nt], lo, bh0, bh1);
      mma_tf32(acc[nt], hi, bl[j0], bl[j1]);
      mma_tf32(acc[nt], hi, bh0, bh1);
    }
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

// the sums over each row's quad (the lanes sharing a row) of s[0] (row
// acc_row(0)) and s[1] (row acc_row(2)), into red[w / 4][row] by lane
// t = 0: the two warps sharing rows write two halves
__device__ __forceinline__ void quad_rows(float (&s)[2], float* red) {
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
}

// per-row sums of a 64-row accumulator's entries times v(row, col): each
// thread's entries, then its quad, then the two warps sharing rows in
// red[2][64]; thread r < 64 gets row r's sum
template <int NTW, class V>
__device__ __forceinline__ float row_dot(const float (&acc)[NTW][4],
                                         float* red, V v) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e >> 1] += acc[nt][e] * v(acc_row(e), acc_col<NTW>(nt, e));
  quad_rows(s, red);
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
// over KT-row tiles of C ([i][n], read as A [k][m]) and dy ([i][p], read
// as B [k][n]).  Blocks x = 0 write the chunk's cum to scratch.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_state_kernel(const float* __restrict__ la, const float* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ cum,
                     float* __restrict__ dst, Dims d) {
  constexpr int KT = HD > RT ? 32 : RT;
  constexpr int SC = s_colk(RT), SY = s_colk(HD);
  constexpr int STAGE = KT * SC + KT * SY;
  extern __shared__ __align__(16) float sm[];
  float* cum_s = sm;                                  // QP: exp(cum)
  float* ring = cum_s + d.QP;                         // NS x STAGE
  uint32_t* lo = reinterpret_cast<uint32_t*>(ring + NS * STAGE);  // STAGE
  const int n0 = blockIdx.x * RT, c = blockIdx.y;
  const int b = blockIdx.z / d.H, h = blockIdx.z % d.H;
  const size_t t0 = (size_t)b * d.S + (size_t)c * d.Q;
  const int H = d.H, N = d.N, Q = d.Q;
  const bool vecC = aligned16(Cm, N), vecY = aligned16(dy, (size_t)H * HD);
  const int T = d.QP / KT;
  auto prefetch = [&](int k) {
    if (k < T) {
      float* st = ring + (k % NS) * STAGE;
      const int i0 = k * KT;
      load_tile<KT, RT>(st, SC, Cm + (t0 + i0) * N + n0, N, Q - i0, N - n0,
                        vecC, Cm);
      load_tile<KT, HD>(st + KT * SC, SY, dy + ((t0 + i0) * H + h) * HD,
                        (size_t)H * HD, Q - i0, HD, vecY, dy);
    }
    cp_async_commit();
  };
  prefetch(0);
  chunk_cumsum(cum_s, la, t0, h, H, Q, d.QP);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < Q; i += THREADS)
      cum[(t0 + i) * H + h] = cum_s[i];
  __syncthreads();
  for (int i = threadIdx.x; i < d.QP; i += THREADS)
    cum_s[i] = i < Q ? __expf(cum_s[i]) : 0.f;

  float acc[HD / 16][4];
  zero(acc);
  for (int k = 0; k < T; ++k) {
    cp_async_wait<0>();
    __syncthreads();
    prefetch(k + 1);
    float* st = ring + (k % NS) * STAGE;
    const float* ec = cum_s + k * KT;
    split_tile<KT, RT>(st, lo, SC,
                       [&](int i, int, float x) { return x * ec[i]; });
    split_tile<KT, HD>(st + KT * SC, lo + KT * SC, SY, Keep());
    __syncthreads();
    mma_split<HD / 16, KT, true, true>(acc, st, lo, SC, st + KT * SC,
                                       lo + KT * SC, SY);
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
  // eight chunks' loads issued before their dependent chain
  for (int c0 = nc - 1; c0 >= 0; c0 -= 8) {
    float u[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 - k >= 0) {
        const size_t row = ((size_t)b * nc + c0 - k) * H + h;
        u[k] = dst[row * NH + e];
        dec[k] = expf(totals[row]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 - k >= 0) {
        dst[(((size_t)b * nc + c0 - k) * H + h) * NH + e] = g;
        g = g * dec[k] + u[k];
      }
  }
  if (dinit) dinit[(size_t)bh * NH + e] = g;
}

// The per-step parts of dcum, each B * S * H (index (t * H + h)): cum
// (written by 1), row sums of W o C B^T (3), the xd . (B G) terms (4),
// the column sums, one plane per row tile (3), the dy . (C prev) terms,
// one plane per 64 columns of d_state (5)
struct Parts {
  float *cum, *rows, *sterm, *cols, *rterm;
  __device__ __host__ Parts(float* p, size_t plane, int ntile)
      : cum(p), rows(p + plane), sterm(p + 2 * plane),
        cols(p + 3 * plane), rterm(p + (3 + (size_t)ntile) * plane) {}
};

// ------------------------------------ 3. W tiles, their sums, dS by group
// Block x = (group g, chunk c, b), z: row tile I (the longest first).
// For each column tile J <= I and each head h of the group in order:
//   W = (dy_I xd_J^T) o L     (64 x 64, K = hd in KC-column steps)
// Its row sums of W o C B^T add up over J in rsum (rows I of head h);
// its column sums (rows I's share) go to the row tile's plane of cols;
// W summed over the group's heads is tile (I, J) of the group's dS.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_w_kernel(const float* __restrict__ xd, const float* __restrict__ dy,
                 const float* __restrict__ cb, float* __restrict__ dsg,
                 float* __restrict__ parts, Dims d) {
  constexpr int KC = HD < RT ? HD : RT, NK = HD / KC;
  constexpr int SK = s_rowk(KC);
  constexpr int STAGE = 2 * RT * SK + 2 * RT;   // dy_I, xd_J, cum_I, cum_J
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                                   // NS x STAGE
  uint32_t* lo = reinterpret_cast<uint32_t*>(ring + NS * STAGE);  // 2 RT SK
  float* rsum = ring + NS * STAGE + 2 * RT * SK;      // HG x 64
  float* rowred = rsum + HG * RT;                     // 2 x 64
  float* colred = rowred + 2 * RT;                    // 4 x 64

  const int H = d.H, Q = d.Q, QP = d.QP, ntile = QP / RT;
  const int g = blockIdx.x % d.NG;
  const int c = (blockIdx.x / d.NG) % d.nc, b = blockIdx.x / d.NG / d.nc;
  const int it = ntile - 1 - blockIdx.z, i0 = it * RT;
  const int h0 = g * HG, nh = min(HG, H - h0);
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t plane = (size_t)d.Bb * d.S * H;
  const Parts pt(parts, plane, ntile);
  const float* cbc = cb + ((size_t)b * d.nc + c) * QP * QP;
  const bool vecY = aligned16(dy, (size_t)H * HD);
  const bool vecX = aligned16(xd, (size_t)H * HD);
  const int tid = threadIdx.x;
  const int T = (it + 1) * nh * NK;          // steps (J, head, K step)

  auto prefetch = [&](int s) {
    if (s < T) {
      float* st = ring + (s % NS) * STAGE;
      const int kc = s % NK, h = h0 + (s / NK) % nh, j0 = s / (NK * nh) * RT;
      load_tile<RT, KC>(st, SK, dy + ((t0 + i0) * H + h) * HD + kc * KC,
                        (size_t)H * HD, Q - i0, KC, vecY, dy);
      load_tile<RT, KC>(st + RT * SK, SK,
                        xd + ((t0 + j0) * H + h) * HD + kc * KC,
                        (size_t)H * HD, Q - j0, KC, vecX, xd);
      load_la(st + 2 * RT * SK, pt.cum + (t0 + i0) * H + h, H, Q - i0, RT);
      load_la(st + 2 * RT * SK + RT, pt.cum + (t0 + j0) * H + h, H, Q - j0,
              RT);
    }
    cp_async_commit();
  };
  prefetch(0);
  for (int e = tid; e < HG * RT; e += THREADS) rsum[e] = 0.f;

  // the row and column sums of the last head's W o C B^T, in rowred and
  // colred: added to rsum, and written to its plane of cols
  int pend_h = -1, pend_j0 = 0;
  auto settle = [&]() {
    if (pend_h < 0) return;
    if (tid < RT) {
      rsum[pend_h * RT + tid] += rowred[tid] + rowred[RT + tid];
    } else if (tid < 2 * RT) {
      const int col = tid - RT, j = pend_j0 + col;
      if (j < Q)
        pt.cols[((size_t)it * d.Bb * d.S + t0 + j) * H + h0 + pend_h] =
            colred[col] + colred[RT + col] + colred[2 * RT + col] +
            colred[3 * RT + col];
    }
    pend_h = -1;
  };

  float accW[4][4], dS[4][4], cbr[4][4];
  for (int s = 0; s < T; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    prefetch(s + 1);
    settle();
    float* st = ring + (s % NS) * STAGE;
    const int kc = s % NK, hh = (s / NK) % nh, j0 = s / (NK * nh) * RT;
    split_tile<RT, KC>(st, lo, SK, Keep());
    split_tile<RT, KC>(st + RT * SK, lo + RT * SK, SK, Keep());
    __syncthreads();
    if (kc == 0) zero(accW);
    mma_split<4, KC, false, false>(accW, st, lo, SK, st + RT * SK,
                                   lo + RT * SK, SK);
    if (kc != NK - 1) continue;

    // W o L, its sums, dS: rows i0 + acc_row(e), columns j0 + acc_col
    const float* cI = st + 2 * RT * SK;
    const float* cJ = cI + RT;
    if (hh == 0) {
      zero(dS);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + acc_row(e), j = j0 + acc_col<4>(nt, e);
          cbr[nt][e] = j <= i && i < Q ? cbc[(size_t)i * QP + j] : 0.f;
        }
    }
    float rs[2] = {0.f, 0.f}, cs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      cs[nt][0] = cs[nt][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(e), cc = acc_col<4>(nt, e);
        const int i = i0 + r, j = j0 + cc;
        const float w =
            j <= i && i < Q ? accW[nt][e] * __expf(cI[r] - cJ[cc]) : 0.f;
        dS[nt][e] += w;
        const float p = w * cbr[nt][e];
        rs[e >> 1] += p;
        cs[nt][e & 1] += p;
      }
    }
    quad_rows(rs, rowred);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float x = cs[nt][v];
        x += __shfl_xor_sync(FULL, x, 4);
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if ((tid & 31) < 4) colred[(tid >> 5 & 3) * RT + acc_col<4>(nt, v)] = x;
      }
    pend_h = hh;
    pend_j0 = j0;
    if (hh == nh - 1) {
      float* out = dsg + ((((size_t)g * d.Bb + b) * d.nc + c) * QP + i0) * QP +
                   j0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = acc_row(0), cc = acc_col<4>(nt, 0);
        *reinterpret_cast<float2*>(out + (size_t)r * QP + cc) =
            make_float2(dS[nt][0], dS[nt][1]);
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * QP + cc) =
            make_float2(dS[nt][2], dS[nt][3]);
      }
    }
  }
  __syncthreads();
  settle();
  __syncthreads();
  for (int e = tid; e < nh * RT; e += THREADS) {
    const int hh = e / RT, r = e % RT;
    if (i0 + r < Q) pt.rows[(t0 + i0 + r) * H + h0 + hh] = rsum[e];
  }
}

// ------------------------------------------------- 4. dxd, per head
// Block x = (h, chunk c, b), z: column tile J (the longest first):
//   dxd_J = (diag(exp(total - cum_J)) B_J) G + (C B^T o L)_{:,J}^T dy
// in one accumulator: first over N (KT columns a step: B_J [j][n] with
// its decays as A [m][k], G [n][p] as B [k][n]), when the accumulator's
// rows dotted with xd_J are the terms exp(total - cum_j) xd_j . (B_j G);
// then over rows i >= J (KT a step: C B^T [i][j] read as A [k][m] with
// the decays and masks applied, dy [i][p] as B [k][n]).
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dxd_kernel(const float* __restrict__ xd, const float* __restrict__ Bm,
                   const float* __restrict__ cb, const float* __restrict__ dst,
                   const float* __restrict__ dy, float* __restrict__ dxd,
                   float* __restrict__ parts, Dims d) {
  constexpr int NTW = HD / 16;
  constexpr int KT = HD > RT ? 32 : RT;
  constexpr int SL = s_colk(RT), SBJ = s_rowk(KT), SY = s_colk(HD);
  constexpr int AMAX = KT * SL > RT * SBJ ? KT * SL : RT * SBJ;
  constexpr int STAGE = AMAX + KT * SY + KT;    // A, B, cum of the rows i
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                                   // NS x STAGE
  uint32_t* lo = reinterpret_cast<uint32_t*>(ring + NS * STAGE);  // STAGE
  float* cJ = ring + (NS + 1) * STAGE;                // 64: cum_J
  float* er = cJ + RT;                                // 64: exp(total - cum_J)
  float* red = er + RT;                               // 2 x 64

  const int H = d.H, N = d.N, Q = d.Q, QP = d.QP;
  const int h = blockIdx.x % H;
  const int c = (blockIdx.x / H) % d.nc, b = blockIdx.x / H / d.nc;
  const int j0 = blockIdx.z * RT;
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t bch = ((size_t)b * d.nc + c) * H + h;
  const Parts pt(parts, (size_t)d.Bb * d.S * H, QP / RT);
  const float* G = dst + bch * N * HD;
  const float* cbc = cb + ((size_t)b * d.nc + c) * QP * QP;
  const bool vecB = aligned16(Bm, N), vecY = aligned16(dy, (size_t)H * HD);
  const int T1 = (N + KT - 1) / KT, T = T1 + (QP - j0) / KT;
  const int tid = threadIdx.x;

  auto prefetch = [&](int s) {
    if (s < T) {
      float* st = ring + (s % NS) * STAGE;
      if (s < T1) {
        const int n0 = s * KT;
        load_tile<RT, KT>(st, SBJ, Bm + (t0 + j0) * N + n0, N, Q - j0,
                          N - n0, vecB, Bm);
        load_tile<KT, HD>(st + AMAX, SY, G + (size_t)n0 * HD, HD, N - n0, HD,
                          true, dst);
      } else {
        const int i0 = j0 + (s - T1) * KT;
        load_tile<KT, RT>(st, SL, cbc + (size_t)i0 * QP + j0, QP, KT, RT,
                          true, cb);
        load_tile<KT, HD>(st + AMAX, SY, dy + ((t0 + i0) * H + h) * HD,
                          (size_t)H * HD, Q - i0, HD, vecY, dy);
        load_la(st + AMAX + KT * SY, pt.cum + (t0 + i0) * H + h, H, Q - i0,
                KT);
      }
    }
    cp_async_commit();
  };
  prefetch(0);
  const float total = pt.cum[(t0 + Q - 1) * H + h];
  for (int j = tid; j < RT; j += THREADS) {
    cJ[j] = j0 + j < Q ? pt.cum[(t0 + j0 + j) * H + h] : 0.f;
    er[j] = j0 + j < Q ? __expf(total - cJ[j]) : 0.f;
  }

  float acc[NTW][4];
  zero(acc);
  for (int s = 0; s < T; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    prefetch(s + 1);
    float* st = ring + (s % NS) * STAGE;
    if (s < T1) {
      split_tile<RT, KT>(st, lo, SBJ,
                         [&](int j, int, float x) { return x * er[j]; });
      split_tile<KT, HD>(st + AMAX, lo + AMAX, SY, Keep());
      __syncthreads();
      mma_split<NTW, KT, false, true>(acc, st, lo, SBJ, st + AMAX,
                                      lo + AMAX, SY);
      if (s == T1 - 1) {        // acc = diag(exp(total - cum_J)) B_J G
        const float sdot = row_dot(acc, red, [&](int r, int p) {
          return j0 + r < Q ? xd[((t0 + j0 + r) * H + h) * HD + p] : 0.f;
        });
        if (tid < RT && j0 + tid < Q) pt.sterm[(t0 + j0 + tid) * H + h] = sdot;
      }
    } else {
      const int i0 = j0 + (s - T1) * KT;
      const float* cI = st + AMAX + KT * SY;
      split_tile<KT, RT>(st, lo, SL, [&](int i, int j, float x) {
        return j0 + j <= i0 + i && i0 + i < Q ? x * __expf(cI[i] - cJ[j])
                                              : 0.f;
      });
      split_tile<KT, HD>(st + AMAX, lo + AMAX, SY, Keep());
      __syncthreads();
      mma_split<NTW, KT, true, true>(acc, st, lo, SL, st + AMAX, lo + AMAX,
                                     SY);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + acc_row(e);
      if (j < Q)
        dxd[((t0 + j) * H + h) * HD + acc_col<NTW>(nt, e)] = acc[nt][e];
    }
}

// --------------------------------------------- 5. dB and dC, per chunk
// Block x = (role, 64 state columns n0.., chunk c, b), z: row tile (the
// longest first).  Role 0, dC of rows I:
//   sum_h diag(exp(cum_h)) (dy_h prev_h^T) + sum_{J <= I} dS_IJ B_J
// the head sums as one product over K = H hd (KC a step; dy with its
// decays [i][p] as A [m][k], prev_h [n][p] as B [n][k]), the rows of what
// each head adds dotted with C_I (staged once) for the head's
// dy . (C prev) terms; then dS [i][j] as A [m][k] with B [j][n] as
// B [k][n], KS of j a step.  Role 1, dB of rows J:
//   sum_h diag(exp(total_h - cum_h)) xd_h G_h^T + sum_{I >= J} dS_IJ^T C_I
// (xd with its decays [j][p] as A [m][k], G_h [n][p] as B [n][k]: one
// product over K = H hd; dS [i][j] as A [k][m], C [i][n] as B [k][n], KS
// of i a step).  Each dS tile is the groups' partials added in group
// order as it is staged.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_ds_kernel(const float* __restrict__ xd, const float* __restrict__ Bm,
                  const float* __restrict__ Cm,
                  const float* __restrict__ states,
                  const float* __restrict__ dst, const float* __restrict__ dy,
                  const float* __restrict__ dsg, float* __restrict__ parts,
                  float* __restrict__ dB, float* __restrict__ dC, Dims d) {
  constexpr int KS = 32;                        // K of a stage
  constexpr int KC = HD < KS ? HD : KS, NK = HD / KC;
  constexpr int SK = s_rowk(KC), SM = s_rowk(KS), SN = s_colk(RT);
  constexpr int AREA = KS * SN;                 // A or B tile of a stage
  constexpr int STAGE = 2 * AREA + RT + 4;      // A, B, cum (+ total)
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                                   // NS x STAGE
  uint32_t* lo = reinterpret_cast<uint32_t*>(ring + NS * STAGE);  // 2 AREA
  float* cs = ring + NS * STAGE + 2 * AREA;           // 64 x SN: C_I
  float* red = cs + RT * SN;                          // 2 x 64

  const int H = d.H, N = d.N, Q = d.Q, QP = d.QP, ntile = QP / RT;
  const int nN = (N + RT - 1) / RT;
  int x = blockIdx.x;
  const int role = x % 2;
  x /= 2;
  const int nn = x % nN;
  x /= nN;
  const int c = x % d.nc, b = x / d.nc;
  const int n0 = nn * RT;
  const int tile = role == 0 ? ntile - 1 - blockIdx.z : blockIdx.z;
  const int r0 = tile * RT;                   // rows I (dC) or J (dB)
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t plane = (size_t)d.Bb * d.S * H;
  const Parts pt(parts, plane, ntile);
  const float* Xs = role == 0 ? dy : xd;      // A of the head sums
  const float* Ys = role == 0 ? states : dst; // B of the head sums
  const float* Ds = dsg + ((size_t)b * d.nc + c) * QP * QP;
  const size_t gstride = (size_t)d.Bb * d.nc * QP * QP;
  const bool vecX = aligned16(Xs, (size_t)H * HD);
  const bool vecB = aligned16(Bm, N) && aligned16(Cm, N);
  const int Th = H * NK;
  const int T = Th + (role == 0 ? tile + 1 : ntile - tile) * (RT / KS);
  const int tid = threadIdx.x;

  auto prefetch = [&](int s) {
    if (s < T) {
      float* st = ring + (s % NS) * STAGE;
      if (s < Th) {
        const int h = s / NK, kc = s % NK;
        load_tile<RT, KC>(st, SK, Xs + ((t0 + r0) * H + h) * HD + kc * KC,
                          (size_t)H * HD, Q - r0, KC, vecX, Xs);
        load_tile<RT, KC>(st + AREA, SK,
                          Ys + ((((size_t)b * d.nc + c) * H + h) * N + n0) *
                                   HD + kc * KC,
                          HD, N - n0, KC, true, Ys);
        load_la(st + 2 * AREA, pt.cum + (t0 + r0) * H + h, H, Q - r0, RT);
        if (tid == 0)
          cp_async4(st + 2 * AREA + RT, pt.cum + (t0 + Q - 1) * H + h, true);
      } else {
        // the other operand of dS: B (dC) or C (dB) rows k0.., [k][n]
        const int k0 = (role == 0 ? 0 : r0) + (s - Th) * KS;
        load_tile<KS, RT>(st + AREA, SN,
                          (role == 0 ? Bm : Cm) + (t0 + k0) * N + n0, N,
                          Q - k0, N - n0, vecB, Bm);
      }
    }
    if (s == 0 && role == 0)
      load_tile<RT, RT>(cs, SN, Cm + (t0 + r0) * N + n0, N, Q - r0, N - n0,
                        vecB, Cm);
    cp_async_commit();
  };
  prefetch(0);

  int pend_h = -1;
  auto settle = [&]() {       // the last head's dy . (C prev) terms
    if (pend_h < 0) return;
    if (tid < RT && r0 + tid < Q)
      pt.rterm[((size_t)nn * plane) + (t0 + r0 + tid) * H + pend_h] =
          red[tid] + red[RT + tid];
    pend_h = -1;
  };

  float acc[4][4], part[2] = {0.f, 0.f};
  zero(acc);
  for (int s = 0; s < T; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    prefetch(s + 1);
    settle();
    float* st = ring + (s % NS) * STAGE;
    if (s < Th) {
      const int h = s / NK, kc = s % NK;
      const float* cum = st + 2 * AREA;
      const float total = cum[RT];
      split_tile<RT, KC>(st, lo, SK, [&](int r, int, float v) {
        return r0 + r < Q ? v * __expf(role == 0 ? cum[r] : total - cum[r])
                          : 0.f;
      });
      split_tile<RT, KC>(st + AREA, lo + AREA, SK, Keep());
      __syncthreads();
      mma_split<4, KC, false, false>(acc, st, lo, SK, st + AREA, lo + AREA,
                                     SK);
      if (role == 1 || kc != NK - 1) continue;
      // this head's dy . (C prev) terms: what it added to acc's rows,
      // dotted with C_I
      float now[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          now[e >> 1] +=
              acc[nt][e] * cs[acc_row(e) * SN + acc_col<4>(nt, e)];
      float rs[2] = {now[0] - part[0], now[1] - part[1]};
      part[0] = now[0];
      part[1] = now[1];
      quad_rows(rs, red);
      pend_h = h;
      continue;
    }
    // A of dS, K = the chunk rows k0.. (KS of them): dS_I[:, k0..] (dC,
    // a 64 x KS tile [i][j]), dS[k0.., J] (dB, KS x 64 [i][j]); the
    // groups' partials added in order, split; B split
    const int k0 = (role == 0 ? 0 : r0) + (s - Th) * KS;
    const int cols = role == 0 ? KS : RT, sa = role == 0 ? SM : SN;
    const float* src = role == 0 ? Ds + (size_t)r0 * QP + k0
                                 : Ds + (size_t)k0 * QP + r0;
#pragma unroll 1
    for (int e = tid; e < RT * KS / 4; e += THREADS) {
      const int r = e / (cols / 4), cc = (e % (cols / 4)) * 4;
      const float* q = src + (size_t)r * QP + cc;
      float4 v = *reinterpret_cast<const float4*>(q);
      for (int gi = 1; gi < d.NG; ++gi) {
        const float4 w = *reinterpret_cast<const float4*>(q + gi * gstride);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      uint4 hi, l;
      split(v.x, hi.x, l.x);
      split(v.y, hi.y, l.y);
      split(v.z, hi.z, l.z);
      split(v.w, hi.w, l.w);
      *reinterpret_cast<uint4*>(st + r * sa + cc) = hi;
      *reinterpret_cast<uint4*>(lo + r * sa + cc) = l;
    }
    split_tile<KS, RT>(st + AREA, lo + AREA, SN, Keep());
    __syncthreads();
    if (role == 0)
      mma_split<4, KS, false, true>(acc, st, lo, SM, st + AREA, lo + AREA,
                                    SN);
    else
      mma_split<4, KS, true, true>(acc, st, lo, SN, st + AREA, lo + AREA,
                                   SN);
  }
  __syncthreads();
  settle();
  float* out = role == 0 ? dC : dB;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + acc_row(e), n = n0 + acc_col<4>(nt, e);
      if (i < Q && n < N) out[(t0 + i) * N + n] = acc[nt][e];
    }
}

// ---------------------------------------------------------- 6. dla
// Block (chunk c, b * H + h): dcum = row sums + dy . (C prev) terms (over
// the 64-column tiles of d_state) - column sums (over the row tiles at
// or below the step's) - xd . (B G) terms, the chunk's last entry plus
// dtotal = exp(total) <prev, G> + sum sterm, and dla its reverse cumsum
// within the chunk
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dla_kernel(const float* __restrict__ states,
                   const float* __restrict__ totals,
                   const float* __restrict__ dst, float* __restrict__ parts,
                   float* __restrict__ dla, Dims d, int NH) {
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;                     // QP: dcum reversed, then its cumsum
  float* red = r_s + d.QP;             // THREADS
  const int c = blockIdx.x, b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int H = d.H, Q = d.Q, ntile = d.QP / RT, nN = (d.N + RT - 1) / RT;
  const size_t t0 = (size_t)b * d.S + (size_t)c * Q;
  const size_t bch = ((size_t)b * d.nc + c) * H + h;
  const size_t plane = (size_t)d.Bb * d.S * H;
  const Parts pt(parts, plane, ntile);
  float dot = 0.f, ssum = 0.f;
  for (int e = threadIdx.x; e < NH; e += THREADS)
    dot += states[bch * NH + e] * dst[bch * NH + e];
  for (int i = threadIdx.x; i < Q; i += THREADS)
    ssum += pt.sterm[(t0 + i) * H + h];
  dot = block_sum(dot, red);
  ssum = block_sum(ssum, red);
  const float dtotal = expf(totals[bch]) * dot + ssum;
  for (int i = threadIdx.x; i < d.QP; i += THREADS) {
    float v = 0.f;
    if (i < Q) {
      const int t = Q - 1 - i;         // reversed
      const size_t k = (t0 + t) * H + h;
      v = pt.rows[k];
      for (int n = 0; n < nN; ++n) v += pt.rterm[n * plane + k];
      for (int it = t / RT; it < ntile; ++it) v -= pt.cols[it * plane + k];
      v += -pt.sterm[k] + (t == Q - 1 ? dtotal : 0.f);
    }
    r_s[i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(r_s, d.QP, threadIdx.x);
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += THREADS)
    dla[(t0 + t) * H + h] = r_s[Q - 1 - t];
}

// dynamic shared memory of kernels 1, 3, 4 and 5, bytes
size_t state_smem(int QP, int hd) {
  const int kt = hd > RT ? 32 : RT;
  return ((size_t)QP + (NS + 1) * (kt * s_colk(RT) + kt * s_colk(hd))) *
         sizeof(float);
}
size_t w_smem(int hd) {
  const int kc = hd < RT ? hd : RT;
  return ((size_t)NS * (2 * RT * s_rowk(kc) + 2 * RT) +
          2 * RT * s_rowk(kc) + HG * RT + 6 * RT) *
         sizeof(float);
}
size_t dxd_smem(int hd) {
  const int kt = hd > RT ? 32 : RT;
  const int a = kt * s_colk(RT) > RT * s_rowk(kt) ? kt * s_colk(RT)
                                                  : RT * s_rowk(kt);
  const size_t stage = (size_t)a + kt * s_colk(hd) + kt;
  return ((NS + 1) * stage + 4 * RT) * sizeof(float);
}
size_t ds_smem() {
  const size_t area = (size_t)32 * s_colk(RT);
  return (NS * (2 * area + RT + 4) + 2 * area + (size_t)RT * s_colk(RT) +
          2 * RT) *
         sizeof(float);
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
           const float* dy, const float* dfinal, float* dst, float* dsg,
           float* parts, float* dxd, float* dla, float* dB, float* dC,
           float* dinit, Dims d, cudaStream_t st) {
  const size_t sm1 = state_smem(d.QP, HD), sm3 = w_smem(HD);
  const size_t sm4 = dxd_smem(HD), sm5 = ds_smem();
  const size_t sm6 = ((size_t)d.QP + THREADS) * sizeof(float);
  const int ntile = d.QP / RT, nN = (d.N + RT - 1) / RT;
  const unsigned bc = (unsigned)d.Bb * d.nc;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_state_kernel<HD>, sm1)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_w_kernel<HD>, sm3)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dxd_kernel<HD>, sm4)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_ds_kernel<HD>, sm5)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dla_kernel, sm6)) != cudaSuccess)
    return (int)err;
  ssd_bwd_state_kernel<HD><<<dim3((d.N + RT - 1) / RT, d.nc, d.Bb * d.H),
                             THREADS, sm1, st>>>(la, Cm, dy, parts, dst, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int NH = d.N * HD;
  ssd_bwd_pass_kernel<<<dim3((NH + THREADS - 1) / THREADS, d.Bb * d.H),
                        THREADS, 0, st>>>(dst, totals, dfinal, dinit, d.nc,
                                          d.H, NH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_w_kernel<HD><<<dim3(d.NG * bc, 1, ntile), THREADS, sm3, st>>>(
      xd, dy, cb, dsg, parts, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dxd_kernel<HD><<<dim3(d.H * bc, 1, ntile), THREADS, sm4, st>>>(
      xd, Bm, cb, dst, dy, dxd, parts, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_ds_kernel<HD><<<dim3(2 * nN * bc, 1, ntile), THREADS, sm5, st>>>(
      xd, Bm, Cm, states, dst, dy, dsg, parts, dB, dC, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dla_kernel<<<dim3(d.nc, d.Bb * d.H), THREADS, sm6, st>>>(
      states, totals, dst, parts, dla, d, NH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bwd(const float* xd, const float* la, const float* Bm,
                            const float* Cm, const float* states,
                            const float* totals, const float* cb,
                            const float* dy, const float* dfinal, float* dst,
                            float* dsg, float* parts, float* dxd, float* dla,
                            float* dB, float* dC, float* dinit, int Bb, int S,
                            int H, int hd, int N, int Q, void* stream) {
  if (Bb < 1 || S < 1 || H < 1 || N < 1 || N > 256 || Q < 1 || S % Q ||
      S / Q > 65535 || (long long)Bb * H > 65535 ||
      3LL * (round_up(Q, RT) / RT) > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d{Bb, S, H, N, Q, S / Q, round_up(Q, RT), (H + HG - 1) / HG};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define SSD_BWD_CASE(HD)                                                   \
  case HD:                                                                 \
    return launch<HD>(xd, la, Bm, Cm, states, totals, cb, dy, dfinal, dst, \
                      dsg, parts, dxd, dla, dB, dC, dinit, d, st);
    SSD_BWD_CASE(16)
    SSD_BWD_CASE(32)
    SSD_BWD_CASE(64)
    SSD_BWD_CASE(128)
#undef SSD_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
