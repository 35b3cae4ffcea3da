// Mamba2 SSD scan, chunked form, forward, on the tensor cores (the
// backward is ssd_scan_bwd.cu; both take their helpers from
// ssd_common.cuh).
//
// Replaces the Pallas TPU kernel `_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/ssd_scan.py (wrapped there by
// ops.ssd_scan), the same math as repro.models.mamba2.ssd_chunked.  For
// batch b and head h the recurrence
//   state_t = exp(la_t) state_{t-1} + B_t (x) xd_t,   y_t = C_t . state_t
// is evaluated chunk by chunk (Q steps each, cum = cumsum of la within
// the chunk, total = its last entry):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xd_j
//         + exp(cum_i) C_i . prev_c                 (the incoming state)
//   prev_{c+1} = exp(total) prev_c + sum_j exp(total - cum_j) B_j (x) xd_j
// and y (B, S, H, hd) and the final state (B, H, N, hd) are written.  B
// and C (B, S, N) are shared by the heads (one group).  All f32.
//
// What bounds it on an H100: operations.  Nearly all of them are four
// matrix products (C B^T, the masked L xd, B^T (w xd), C prev).  The TPU
// kernel walks (b, h, chunk) in order on one core; here only the N x hd
// state carries from one chunk to the next, so the work is split as in
// the Mamba2 paper (Dao & Gu 2024, sections 6-7) into three launches:
//   1. ssd_state_kernel, parallel over (b, chunk, head, 64 state rows):
//      the chunk's own end state s_c = B^T diag(exp(total - cum)) xd, an
//      (N x Q)(Q x hd) product, and the chunk's total; its other blocks
//      form C B^T once per chunk (B and C do not depend on the head) in
//      64 x 64 tiles of the lower triangle, into scratch.
//   2. ssd_pass_kernel, sequential over the chunks of each (b, h), one
//      thread per state element: prev_0 = init (or 0), prev_{c+1} =
//      exp(total_c) prev_c + s_c, written over s_c in place (so the
//      scratch holds each chunk's incoming state), and the final state.
//   3. ssd_out_kernel, parallel over (b, chunk, head, 64-row tile):
//      y = (C B^T o exp(cum_i - cum_j) o causal) xd + diag(exp(cum)) C
//      prev_c, all hd columns in one block, written once.
// Every product runs on the tensor cores in 3xTF32
// (mma.sync.m16n8k8.tf32): each operand x is split into hi = tf32(x) and
// lo = x - hi, and hi*hi + hi*lo + lo*hi is summed in f32, which keeps
// f32-level error (one TF32 pass would not).  Operand tiles come from
// global memory by cp.async, double-buffered (NS = 2).  The decay stays
// exp(cum_i - cum_j), as in the reference: factored as exp(cum_i)
// exp(-cum_j) it would overflow once |cum| > 88.  Rows past Q (S < chunk,
// e.g. Q = 100) and state rows past N are zero-filled in shared memory
// and never written.  What holds it back now (PERF.md): mma.sync takes
// its operands from registers, so every MMA comes with its fragments'
// shared-memory loads and splits (and, in L xd, the decays), about as
// many instructions as the MMAs themselves; wgmma is later work.
//
// C interface for ctypes: pointers are device pointers (init_state may
// be null: a zero state; `states` is scratch of B * S/Q * H * N * hd
// floats, `totals` of B * S/Q * H, `cb` of B * S/Q * QP * QP with QP = Q
// rounded up to 64), `stream` is a cudaStream_t, the return value is the
// CUDA error code of the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_common.cuh"

namespace {

constexpr int RT = 64;          // chunk rows of an output tile
constexpr int KT = 32;          // rows of a streamed xd / B / state tile
constexpr int NT1 = 32;         // d_state columns of a C B^T step
constexpr int NS = 2;           // tiles in flight (cp.async groups)

// ------------------------------------------------ 1a. C B^T of a chunk
// cb[b, c, i, j] = C_i . B_j for the 64 x 64 tile (it, jt), jt <= it, of
// chunk c, the d_state dimension streamed in NT1-column slices of C and
// B.  Warp w owns rows 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31;
// warp tiles wholly above the diagonal are left unwritten (never read
// unmasked).  Rows and columns past Q come out 0.
__device__ __forceinline__ void cb_tile(const float* __restrict__ Bm,
                                        const float* __restrict__ Cm,
                                        float* __restrict__ cb, float* buf,
                                        int S, int N, int Q, int c, int b,
                                        int it, int jt) {
  constexpr int SB1 = NT1 + 4;         // [row][n] slices: conflict-free
  constexpr int BUF = 2 * RT * SB1;
  const int QP = round_up(Q, RT), NCP = round_up(N, NT1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp & 3, ch = warp >> 2;
  const int nc = S / Q;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const int i0 = it * RT, j0 = jt * RT, ra = rs * 16 + g;
  const bool vec = aligned16(Bm, N) && aligned16(Cm, N);
  const int T = NCP / NT1;
  auto prefetch = [&](int k) {
    if (k < T) {
      float* cs = buf + (k % NS) * BUF;
      load_tile<RT, NT1>(cs, SB1, Cm + (t0 + i0) * N + k * NT1, N, Q - i0,
                         N - k * NT1, vec, Cm);
      load_tile<RT, NT1>(cs + RT * SB1, SB1, Bm + (t0 + j0) * N + k * NT1, N,
                         Q - j0, N - k * NT1, vec, Bm);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) prefetch(k);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const bool active = !(jt == it && ch * 32 > rs * 16 + 15);
  for (int k = 0; k < T; ++k) {
    prefetch(k + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
    const float* cs = buf + (k % NS) * BUF;
    const float* bs = cs + RT * SB1;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < NT1 / 8; ++ks) {
        const float* ca = cs + ra * SB1 + ks * 8 + t;
        AFrag a;
        a.set(ca[0], ca[8 * SB1], ca[4], ca[8 * SB1 + 4]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* br = bs + (ch * 32 + nt * 8 + g) * SB1 + ks * 8 + t;
          mma3(acc[nt], a, br[0], br[4]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* out = cb + (((size_t)b * nc + c) * QP + i0 + ra) * QP + j0 + ch * 32;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(out + nt * 8 + 2 * t) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + 8 * QP + nt * 8 + 2 * t) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------ 1b. chunk end states
// Blocks z < B * H: (64 state rows, chunk c, b * H + h); warp w owns state
// rows
// 16 (w % 4) .. + 15 and columns (w / 4) hd / 2 .. + hd / 2 of
//   s_c[n, p] = sum_j B[j, n] w_j xd[j, p],  w_j = exp(total - cum_j),
// the A operand B^T w read from a [j][n] tile, the B operand a [j][p]
// tile of xd, KT rows of j a step, NS steps in flight.  Blocks z >= B * H
// (x = 0) form the C B^T tiles of chunk c instead (cb_tile).
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_state_kernel(const float* __restrict__ xd, const float* __restrict__ la,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ states, float* __restrict__ totals,
                 float* __restrict__ cb, int Bb, int S, int H, int N,
                 int Q) {
  constexpr int SB = 64 + 8;           // [j][n] tile stride: conflict-free
  constexpr int SX = HD + 8;           // [j][p] tile stride
  constexpr int BUF = KT * SB + KT * SX;
  constexpr int NTW = HD / 16;         // 8-column MMA tiles per warp
  extern __shared__ __align__(16) float sm[];
  const int QP = round_up(Q, KT);
  float* cum_s = sm;                   // QP
  float* w_s = cum_s + QP;             // QP
  float* buf = w_s + QP;               // NS x BUF

  if (blockIdx.z >= Bb * H) {
    if (blockIdx.x) return;
    int z = blockIdx.z - Bb * H;
    const int nt = round_up(Q, RT) / RT, ntri = nt * (nt + 1) / 2;
    const int b = z / ntri;
    int it = 0;
    for (z %= ntri; z > it; z -= ++it) {}
    cb_tile(Bm, Cm, cb, sm, S, N, Q, blockIdx.y, b, it, z);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, ch = warp >> 2;
  const int n0 = blockIdx.x * 64, c = blockIdx.y;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int nc = S / Q;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;   // chunk's first step
  const bool vecB = aligned16(Bm, N);
  const bool vecX = aligned16(xd, (size_t)H * HD);

  const int T = QP / KT;
  auto prefetch = [&](int k) {
    if (k < T) {
      float* bs = buf + (k % NS) * BUF;
      const int j0 = k * KT;
      load_tile<KT, 64>(bs, SB, Bm + (t0 + j0) * N + n0, N, Q - j0, N - n0,
                        vecB, Bm);
      load_tile<KT, HD>(bs + KT * SB, SX, xd + ((t0 + j0) * H + h) * HD,
                        (size_t)H * HD, Q - j0, HD, vecX, xd);
    }
    cp_async_commit();
  };

  load_la(cum_s, la + t0 * H + h, H, Q, QP);
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) prefetch(k);

  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const bool active = n0 + mt * 16 < N;
  for (int k = 0; k < T; ++k) {
    prefetch(k + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
    if (k == 0) {                      // la (group 0) has landed
      if (warp == 0) warp_cumsum(cum_s, QP, lane);
      __syncthreads();
      const float total = cum_s[Q - 1];
      for (int j = tid; j < QP; j += THREADS)
        w_s[j] = j < Q ? __expf(total - cum_s[j]) : 0.f;
      if (blockIdx.x == 0 && tid == 0)
        totals[((size_t)b * nc + c) * H + h] = total;
      __syncthreads();
    }
    const float* bs = buf + (k % NS) * BUF;
    const float* xs = bs + KT * SB;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        const int jr = ks * 8 + t;
        const float w0 = w_s[k * KT + jr], w1 = w_s[k * KT + jr + 4];
        const float* r0 = bs + jr * SB + mt * 16 + g;
        const float* r1 = r0 + 4 * SB;
        AFrag a;
        a.set(r0[0] * w0, r0[8] * w0, r1[0] * w1, r1[8] * w1);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int col = ch * (HD / 2) + nt * 8 + g;
          mma3(acc[nt], a, xs[jr * SX + col], xs[(jr + 4) * SX + col]);
        }
      }
    }
    __syncthreads();
  }

  float* out = states + (((size_t)b * nc + c) * H + h) * N * HD;
  const int r = n0 + mt * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = ch * (HD / 2) + nt * 8 + 2 * t;
    if (r < N)
      *reinterpret_cast<float2*>(out + (size_t)r * HD + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r + 8 < N)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * HD + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------- 2. passing the state
// thread e of block (x, b * H + h) walks state element e of (b, h) over
// the chunks: s_c is replaced by the state entering chunk c
__global__ void __launch_bounds__(THREADS)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ totals,
                const float* __restrict__ st0, float* __restrict__ fs,
                int nc, int H, int NH) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= NH) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  float prev = st0 ? st0[(size_t)bh * NH + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float s[4], dec[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cc = c0 + u;
      if (cc < nc) {
        const size_t row = ((size_t)b * nc + cc) * H + h;
        s[u] = states[row * NH + e];
        dec[u] = expf(totals[row]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cc = c0 + u;
      if (cc < nc) {
        states[(((size_t)b * nc + cc) * H + h) * NH + e] = prev;
        prev = prev * dec[u] + s[u];
      }
    }
  }
  fs[(size_t)bh * NH + e] = prev;
}

// --------------------------------------------------------- 3. chunk output
// Block (chunk c, b * H + h, 64-row tile); warp w owns rows 16 (w % 4) ..
// + 15 of the tile and columns (w / 4) hd / 2 .. + hd / 2.  Tiles, NS in
// flight: for k < TJ the C B^T tile (64 rows x KT columns j, from 1a)
// with the xd tile of the same KT rows j: y += (C B^T o decay o causal)
// xd; then [n][p] tiles of the incoming state: y += diag(exp(cum)) C prev
// (the tile's C rows, all N, and la come with the first tile).
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : 2)
ssd_out_kernel(const float* __restrict__ xd, const float* __restrict__ la,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ states, float* __restrict__ y, int S,
               int H, int N, int Q) {
  constexpr int SL = KT + 4;           // [i][j] C B^T tile: conflict-free
  constexpr int SX = HD + 8;           // [j][p] / [n][p] tiles
  constexpr int BUF = RT * SL + KT * SX;
  constexpr int NTW = HD / 16;
  extern __shared__ __align__(16) float sm[];
  const int QP = round_up(Q, RT), NCP = round_up(N, NT1);
  const int SC = NCP + 4;
  float* C_s = sm;                     // RT x SC: the tile's C rows
  float* cum_s = C_s + RT * SC;        // QP: la, then its cumsum
  float* buf = cum_s + QP;             // NS x BUF

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp & 3, ch = warp >> 2;
  const int c = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int it = gridDim.z - 1 - blockIdx.z;   // the longest tiles first
  const int nc = S / Q;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const int i0 = it * RT;                      // tile's first chunk row
  const int rows = min(RT, Q - i0);
  const bool vecC = aligned16(Cm, N);
  const bool vecX = aligned16(xd, (size_t)H * HD);
  const bool vecS = aligned16(states, HD);
  const int ra = rs * 16 + g;                  // this thread's tile rows
  const int ia = i0 + ra, ib = ia + 8;         // ra, ra + 8; chunk rows
  const int jlast = i0 + rs * 16 + 15;         // the warp's last row
  const float* cbt = cb + (((size_t)b * nc + c) * QP + i0) * QP;
  const float* prev = states + (((size_t)b * nc + c) * H + h) * N * HD;

  const int TJ = (it + 1) * (RT / KT);
  const int T = TJ + NCP / KT;
  auto prefetch = [&](int k) {
    if (k < T) {
      float* dst = buf + (k % NS) * BUF;
      if (k < TJ) {
        load_tile<RT, KT>(dst, SL, cbt + k * KT, QP, RT, KT, true, cb);
        load_tile<KT, HD>(dst + RT * SL, SX,
                          xd + ((t0 + k * KT) * H + h) * HD, (size_t)H * HD,
                          Q - k * KT, HD, vecX, xd);
      } else {
        load_tile<KT, HD>(dst + RT * SL, SX,
                          prev + (size_t)(k - TJ) * KT * HD, HD,
                          N - (k - TJ) * KT, HD, vecS, states);
      }
    }
    cp_async_commit();
  };

  for (int n0 = 0; n0 < NCP; n0 += NT1)
    load_tile<RT, NT1>(C_s + n0, SC, Cm + (t0 + i0) * N + n0, N, rows, N - n0,
                       vecC, Cm);
  load_la(cum_s, la + t0 * H + h, H, Q, i0 + RT);
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) prefetch(k);

  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float cum_a = 0.f, cum_b = 0.f;
  for (int k = 0; k < T; ++k) {
    prefetch(k + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
    if (k == 0) {                      // C rows and la (group 0) are in
      if (warp == 0) warp_cumsum(cum_s, i0 + RT, lane, LOG2E);
      __syncthreads();
      cum_a = cum_s[ia];
      cum_b = cum_s[ib];
    }
    const float* lt = buf + (k % NS) * BUF;
    const float* xs = lt + RT * SL;
    // y += (C B^T o decay) xd over KT columns j; `masked`: the tile's
    // diagonal block, where j > i is cut off
    auto intra = [&](auto mask) {
      constexpr bool masked = decltype(mask)::value;
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        const int j = k * KT + ks * 8 + t;     // a0, a1; j + 4: a2, a3
        if (masked && j - t > jlast) break;    // warp-uniform
        const float cj0 = cum_s[j], cj1 = cum_s[j + 4];
        const float* pa = lt + ra * SL + ks * 8 + t;
        const float* pb = pa + 8 * SL;
        float v[4] = {pa[0] * exp2_ftz(cum_a - cj0),
                      pb[0] * exp2_ftz(cum_b - cj0),
                      pa[4] * exp2_ftz(cum_a - cj1),
                      pb[4] * exp2_ftz(cum_b - cj1)};
        if (masked) {
          v[0] = j <= ia ? v[0] : 0.f;
          v[1] = j <= ib ? v[1] : 0.f;
          v[2] = j + 4 <= ia ? v[2] : 0.f;
          v[3] = j + 4 <= ib ? v[3] : 0.f;
        }
        AFrag a;
        a.set(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int col = ch * (HD / 2) + nt * 8 + g;
          mma3(acc[nt], a, xs[(ks * 8 + t) * SX + col],
               xs[(ks * 8 + t + 4) * SX + col]);
        }
      }
    };
    if (k < TJ) {
      if (k * KT + KT <= i0)                   // wholly below the diagonal
        intra(std::false_type());
      else
        intra(std::true_type());
    } else {
      const float ea = exp2_ftz(cum_a), eb = exp2_ftz(cum_b);
      const int n0 = (k - TJ) * KT;
#pragma unroll
      for (int ks = 0; ks < KT / 8; ++ks) {
        const float* ca = C_s + ra * SC + n0 + ks * 8 + t;
        AFrag a;
        a.set(ea * ca[0], eb * ca[8 * SC], ea * ca[4], eb * ca[8 * SC + 4]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int col = ch * (HD / 2) + nt * 8 + g;
          mma3(acc[nt], a, xs[(ks * 8 + t) * SX + col],
               xs[(ks * 8 + t + 4) * SX + col]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = ch * (HD / 2) + nt * 8 + 2 * t;
    if (ra < rows)
      *reinterpret_cast<float2*>(y + ((t0 + ia) * H + h) * HD + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (ra + 8 < rows)
      *reinterpret_cast<float2*>(y + ((t0 + ib) * H + h) * HD + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

size_t state_smem(int Q, int hd) {
  const size_t state = (size_t)2 * round_up(Q, KT) +
                       (size_t)NS * (KT * (64 + 8) + KT * (hd + 8));
  const size_t cbt = (size_t)NS * 2 * RT * (NT1 + 4);
  return (state > cbt ? state : cbt) * sizeof(float);
}

size_t out_smem(int Q, int N, int hd) {
  return ((size_t)RT * (round_up(N, NT1) + 4) + round_up(Q, RT) +
          (size_t)NS * (RT * (KT + 4) + KT * (hd + 8))) *
         sizeof(float);
}

template <int HD>
int launch(const float* xd, const float* la, const float* Bm, const float* Cm,
           const float* st0, float* states, float* totals, float* cb,
           float* y, float* fs, int Bb, int S, int H, int N, int Q,
           cudaStream_t st) {
  const int nc = S / Q, nt = round_up(Q, RT) / RT;
  const size_t sm1 = state_smem(Q, HD), sm3 = out_smem(Q, N, HD);
  if (sm1 > (size_t)MAX_SMEM || sm3 > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((N + 63) / 64, nc, Bb * H + Bb * nt * (nt + 1) / 2);
  ssd_state_kernel<HD><<<grid1, THREADS, sm1, st>>>(
      xd, la, Bm, Cm, states, totals, cb, Bb, S, H, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int NH = N * HD;
  ssd_pass_kernel<<<dim3((NH + THREADS - 1) / THREADS, Bb * H), THREADS, 0,
                    st>>>(states, totals, st0, fs, nc, H, NH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return (int)err;
  ssd_out_kernel<HD><<<dim3(nc, Bb * H, nt), THREADS, sm3, st>>>(
      xd, la, Cm, cb, states, y, S, H, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_fwd(const float* xd, const float* la, const float* Bm,
                            const float* Cm, const float* init_state,
                            float* states, float* totals, float* cb, float* y,
                            float* final_state, int Bb, int S, int H, int hd,
                            int N, int Q, void* stream) {
  if (Bb < 1 || S < 1 || H < 1 || N < 1 || N > 256 || Q < 1 || S % Q ||
      S / Q > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nt = round_up(Q, RT) / RT;   // grid z of launch 1
  if ((long long)Bb * H + Bb * nt * (nt + 1) / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define SSD_CASE(HD)                                                      \
  case HD:                                                                \
    return launch<HD>(xd, la, Bm, Cm, init_state, states, totals, cb, y, \
                      final_state, Bb, S, H, N, Q, st);
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
#undef SSD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
