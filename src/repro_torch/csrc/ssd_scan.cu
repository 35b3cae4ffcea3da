// Mamba2 SSD scan, chunked form, forward only.
//
// Replaces the Pallas TPU kernel `_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/ssd_scan.py (wrapped there by
// ops.ssd_scan), the same math as repro.models.mamba2.ssd_chunked.  For
// batch b and head h the recurrence
//   state_t = exp(la_t) state_{t-1} + B_t (x) xd_t,   y_t = C_t . state_t
// is evaluated chunk by chunk (Q steps each, cum = cumsum of la within
// the chunk, total = its last entry):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xd_j
//         + exp(cum_i) C_i . state                    (carried state)
//   state = exp(total) state + sum_j exp(total - cum_j) B_j (x) xd_j
// and y (B, S, H, hd) and the final state (B, H, N, hd) are written.  B
// and C (B, S, N) are shared by the heads (one group).  All f32.
//
// What bounds it on an H100: operations, on the fp32 CUDA cores.  Per
// chunk the intra-chunk part is a (Q x N) (N x Q) product shared by the
// heads and, per head, a masked (Q x Q) (Q x hd) product; the traffic is
// each input read once.  The TPU kernel holds a whole chunk in VMEM and
// walks (b, h, chunk) in order on one core.  Here a block may use
// 227 KB of shared memory, and Q (2N + hd) 4 bytes is 196 KB for zamba2
// (N = 64) and 320 KB for mamba2-780m (N = 128), so chunks are cut into
// 64-row tiles, and the work is split in two launches:
//   1. cb_kernel: C B^T for the lower-triangle tiles of every (b, chunk)
//      into a scratch buffer (B, S/Q, Q, Q) the wrapper allocates; it
//      does not depend on the head, so it is computed once, not once
//      per head.
//   2. ssd_kernel: one block of 256 threads per (b, h, 16-column slice
//      of hd).  Columns of the state evolve independently, so the slices
//      give a B = 1 zamba2 prefill 256 blocks instead of 64.  The block
//      walks the chunks in order with the (N x 16) state slice in shared
//      memory (the counterpart of the TPU's state scratch).  Per chunk a
//      warp scans la (sequential runs of Q/32 steps per lane, then a
//      shuffle scan over the lanes); per row tile I it loads C_I, adds
//      the carried state's part, then for each tile J <= I forms
//      L = C B^T * exp(cum_i - cum_j) with the causal mask in shared
//      memory and adds L xd_J; the last row tile also folds B_J and
//      xd_J into the state.  Tensor cores are later work.
//
// C interface for ctypes: pointers are device pointers (init_state may
// be null: a zero state; cb is scratch of B * S * Q floats), `stream` is
// a cudaStream_t, the return value is the CUDA error code of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 64;          // rows of a chunk tile
constexpr int PT = 16;          // state columns (of hd) per block
constexpr int NK = 32;          // d_state slice of the C B^T pass
constexpr int THREADS = 256;
constexpr int EPT = QT * PT / THREADS;  // y elements per thread
constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

size_t smem_floats(int Q, int N) {
  return (size_t)3 * Q + 2 * QT * (N + 1) + QT * PT + QT * (QT + 1) +
         (size_t)N * PT;
}

// cb[b, c, i, j] = C[b, cQ + i] . B[b, cQ + j] for the 64 x 64 tiles with
// j-tile <= i-tile; grid (ntile, ntile, B * S/Q), 4 x 4 outputs a thread
__global__ void __launch_bounds__(THREADS)
cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
          float* __restrict__ cb, int S, int N, int Q) {
  __shared__ float cs[QT][NK + 1];
  __shared__ float bs[QT][NK + 1];
  const int it = blockIdx.x, jt = blockIdx.y;
  if (jt > it) return;
  const int bc = blockIdx.z;                     // b * (S / Q) + chunk
  const size_t row0 = (size_t)bc * Q;            // its first time step
  const int i0 = it * QT, j0 = jt * QT;
  const int rows = min(QT, Q - i0), cols = min(QT, Q - j0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NK) {
    __syncthreads();
    for (int e = tid; e < QT * NK; e += THREADS) {
      const int r = e / NK, n = e % NK;
      const bool in_n = n0 + n < N;
      cs[r][n] = r < rows && in_n ? Cm[(row0 + i0 + r) * N + n0 + n] : 0.f;
      bs[r][n] = r < cols && in_n ? Bm[(row0 + j0 + r) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < NK; ++n) {
      float ca[4], bb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ca[a] = cs[ty + 16 * a][n];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = bs[tx + 16 * c][n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += ca[a] * bb[c];
    }
  }
  float* out = cb + (size_t)bc * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * a, j = tx + 16 * c;
      if (i < rows && j < cols) out[(size_t)(i0 + i) * Q + j0 + j] = acc[a][c];
    }
}

// thread tid owns y rows (tid / PT) + 16 k, k < EPT, of column tid % PT
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ xd, const float* __restrict__ la,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ cb, const float* __restrict__ st0,
           float* __restrict__ y, float* __restrict__ fs, int S, int H,
           int hd, int N, int Q) {
  extern __shared__ float sm[];
  float* cum_s = sm;                    // Q: cumsum of la in the chunk
  float* e_s = cum_s + Q;               // Q: exp(cum)
  float* w_s = e_s + Q;                 // Q: exp(total - cum)
  float* C_s = w_s + Q;                 // QT x (N + 1)
  float* B_s = C_s + QT * (N + 1);      // QT x (N + 1)
  float* x_s = B_s + QT * (N + 1);      // QT x PT
  float* L_s = x_s + QT * PT;           // QT x (QT + 1)
  float* st_s = L_s + QT * (QT + 1);    // N x PT

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = tid % PT;               // this thread's column
  const int r0 = tid / PT;              // and its first row in a tile
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int LN = N + 1;
  const int ntile = (Q + QT - 1) / QT;
  const size_t row0 = (size_t)b * S;    // first time step of batch b

  for (int e = tid; e < N * PT; e += THREADS)
    st_s[e] = st0 ? st0[(((size_t)b * H + h) * N + e / PT) * hd + p0 + e % PT]
                  : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const float* cbc = cb + (row0 + t0) * Q;   // this chunk's C B^T
    __syncthreads();  // the previous chunk is done with cum, e, w
    for (int i = tid; i < Q; i += THREADS)
      cum_s[i] = la[(row0 + t0 + i) * H + h];
    __syncthreads();
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int a = min(lane * per, Q), z = min(a + per, Q);
      float run = 0.f;
      for (int i = a; i < z; ++i) {
        run += cum_s[i];
        cum_s[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += up;
      }
      const float off = incl - run;
      for (int i = a; i < z; ++i) cum_s[i] += off;
    }
    __syncthreads();
    const float total = cum_s[Q - 1];
    for (int i = tid; i < Q; i += THREADS) {
      e_s[i] = expf(cum_s[i]);
      w_s[i] = expf(total - cum_s[i]);
    }

    for (int it = 0; it < ntile; ++it) {
      const int i0 = it * QT;
      const int rows = min(QT, Q - i0);
      const bool last = it == ntile - 1;
      __syncthreads();  // C_s of the previous tile is consumed
      for (int e = tid; e < QT * N; e += THREADS) {
        const int r = e / N, n = e % N;
        C_s[r * LN + n] = r < rows ? Cm[(row0 + t0 + i0 + r) * N + n] : 0.f;
      }
      __syncthreads();

      // the carried state's part: exp(cum_i) C_i . state
      float yacc[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) yacc[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float sv = st_s[n * PT + p];
#pragma unroll
        for (int k = 0; k < EPT; ++k) yacc[k] += C_s[(r0 + 16 * k) * LN + n] * sv;
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = r0 + 16 * k;
        yacc[k] = i < rows ? e_s[i0 + i] * yacc[k] : 0.f;
      }
      if (last) {
        __syncthreads();  // every read of the carried state is done
        const float dec = expf(total);
        for (int e = tid; e < N * PT; e += THREADS) st_s[e] *= dec;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * QT;
        const int cols = min(QT, Q - j0);
        __syncthreads();  // B_s, x_s and L_s of the previous tile consumed
        if (last) {
          for (int e = tid; e < QT * N; e += THREADS) {
            const int r = e / N, n = e % N;
            B_s[r * LN + n] =
                r < cols ? Bm[(row0 + t0 + j0 + r) * N + n] : 0.f;
          }
        }
        for (int e = tid; e < QT * PT; e += THREADS) {
          const int r = e / PT, c = e % PT;
          x_s[e] = r < cols
                       ? xd[((row0 + t0 + j0 + r) * H + h) * hd + p0 + c]
                       : 0.f;
        }
        // L = C B^T * exp(cum_i - cum_j), zero above the diagonal
        for (int e = tid; e < QT * QT; e += THREADS) {
          const int i = e / QT, j = e % QT;
          const int gi = i0 + i, gj = j0 + j;
          L_s[i * (QT + 1) + j] =
              (i < rows && j < cols && gj <= gi)
                  ? cbc[(size_t)gi * Q + gj] * expf(cum_s[gi] - cum_s[gj])
                  : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < cols; ++j) {
          const float xv = x_s[j * PT + p];
#pragma unroll
          for (int k = 0; k < EPT; ++k)
            yacc[k] += L_s[(r0 + 16 * k) * (QT + 1) + j] * xv;
        }
        if (last) {
          for (int e = tid; e < N * PT; e += THREADS) {
            const int n = e / PT, c = e % PT;
            float s = 0.f;
            for (int j = 0; j < cols; ++j)
              s += B_s[j * LN + n] * w_s[j0 + j] * x_s[j * PT + c];
            st_s[e] += s;
          }
        }
      }

#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = r0 + 16 * k;
        if (i < rows)
          y[((row0 + t0 + i0 + i) * H + h) * hd + p0 + p] = yacc[k];
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * PT; e += THREADS)
    fs[(((size_t)b * H + h) * N + e / PT) * hd + p0 + e % PT] = st_s[e];
}

}  // namespace

extern "C" int ssd_scan_fwd(const float* xd, const float* la, const float* Bm,
                            const float* Cm, const float* init_state,
                            float* cb, float* y, float* final_state, int Bb,
                            int S, int H, int hd, int N, int Q,
                            void* stream) {
  if (Bb < 1 || S < 1 || H < 1 || N < 1 || N > 256 || Q < 1 || S % Q ||
      hd % PT || Bb > 65535 || H > 65535 || (size_t)Bb * (S / Q) > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntile = (Q + QT - 1) / QT;
  cb_kernel<<<dim3(ntile, ntile, Bb * (S / Q)), THREADS, 0, st>>>(Bm, Cm, cb,
                                                                 S, N, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<dim3(hd / PT, H, Bb), THREADS, smem, st>>>(
      xd, la, Bm, Cm, cb, init_state, y, final_state, S, H, hd, N, Q);
  return (int)cudaGetLastError();
}
