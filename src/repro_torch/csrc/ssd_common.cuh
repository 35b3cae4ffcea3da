// Helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): cp.async tile loads, the 3xTF32 split and mma.sync
// fragments, the loads of la and the in-chunk cumsum.  Each source that
// includes it is compiled on its own (kernels/build.py), so the anonymous
// namespace gives each its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// --------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `n` has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ROWS x COLS floats (COLS a multiple of 4) from src (row stride ss)
// into shared dst (row stride ds, a multiple of 4); entries at row >= rv
// or column >= cv are zero-filled (nothing is read for them, `base`
// stands in for their address).  16-byte copies where src's rows allow.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* src,
                                          size_t ss, int rv, int cv,
                                          bool vec, const float* base) {
  if (vec) {
    constexpr int C4 = COLS / 4;
#pragma unroll
    for (int e0 = 0; e0 < ROWS * C4; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      const int r = e / C4, c = (e % C4) * 4;
      if (ROWS * C4 % THREADS == 0 || e < ROWS * C4) {
        const bool ok = r < rv && c < cv;
        cp_async16(dst + r * ds + c, ok ? src + r * ss + c : base, ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const bool ok = r < rv && c < cv;
      cp_async4(dst + r * ds + c, ok ? src + r * ss + c : base, ok);
    }
  }
}

__device__ __forceinline__ bool aligned16(const float* p, size_t stride) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && (stride % 4 == 0);
}

// ----------------------------------------------------------------- 3xTF32
// x = hi + lo exactly in f32: hi is x rounded to tf32 (half up in
// magnitude: add half a tf32 ulp, clear the 13 low bits; finite x), lo
// the rest, of which the MMA reads the top 19 bits (it ignores a tf32
// operand's low 13): lo loses 2^-11 of itself, about 2^-22 of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x (x in log2 units), subnormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g),
// b1 (k t + 4, n g); D d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1).  A and B are given as f32 and split here.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// la of head h for chunk rows [0, len) into dst (zero past Q)
__device__ __forceinline__ void load_la(float* dst, const float* la_h, int H,
                                        int Q, int len) {
  for (int i = threadIdx.x; i < len; i += THREADS)
    cp_async4(dst + i, i < Q ? la_h + (size_t)i * H : la_h, i < Q);
}

// in-place inclusive cumsum of cum_s[0, len), times `scale`; one warp
__device__ __forceinline__ void warp_cumsum(float* cum_s, int len, int lane,
                                            float scale = 1.f) {
  const int per = (len + 31) / 32;
  const int a = min(lane * per, len), z = min(a + per, len);
  float run = 0.f;
  for (int i = a; i < z; ++i) {
    run += cum_s[i];
    cum_s[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  const float off = incl - run;
  for (int i = a; i < z; ++i) cum_s[i] = (cum_s[i] + off) * scale;
}

}  // namespace
