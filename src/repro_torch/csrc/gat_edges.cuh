// Pieces shared by the GAT forward (gat_mp.cu) and its gradient
// (gat_mp_bwd.cu): how a warp's lanes split a node's feature row, and
// how a warp turns one row of the mask into the list of its set
// columns with 16-byte loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gat {

constexpr int HD = 32;           // features per head
constexpr int MAX_HEADS = 8;
constexpr int SWEEP = 32 * 16;   // mask bytes a warp reads per sweep
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The mask of batch element b: `adj` holds `count` masks of N x N bytes,
// `bstride` bytes apart, and element b reads mask (b / rep) % count.  One
// mask shared by the batch is count 1; one per element, rep 1 and count
// B; one per graph of a zoo bucket shared by the P genomes of a
// population laid out genome-major (b = p G + g), rep 1 and count G, or
// by the T transitions of a critic batch laid out graph-major
// (b = g T + t), rep T and count G.
__device__ __forceinline__ const unsigned char* batch_mask(
    const unsigned char* adj, long long bstride, int rep, int count, int b) {
  // (the shared mask skips the division: with it ptxas spilled in
  // gat_fwd_kernel<8>)
  return count == 1 ? adj : adj + (long long)((b / rep) % count) * bstride;
}

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.2f * x;
}

// The largest v of the warp, exactly (one redux.sync): floats map to
// unsigned integers of the same order (the sign bit set for v >= +0, all
// bits flipped for v < 0), whose max is taken and mapped back.
__device__ __forceinline__ float warp_max(float v) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  u = __reduce_max_sync(FULL, u);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A lane's share of a feature row of D = 32 H floats.  HP is H rounded
// up to a power of two (1, 2, 4 or 8); lane l owns the HP consecutive
// floats from HP * l on, so 32 / HP consecutive lanes hold one head and
// a lane's floats lie in one head.  The row is read as one float4 per
// lane at H = 4 (a 512-byte coalesced load).  Lanes past D / HP
// (H = 3, 5, 6, 7) own nothing: they load zeros and store nothing, and
// as they make up whole head groups, no head sum mixes them in.
template <int HP>
struct Slot {
  static constexpr int LANES_PER_HEAD = 32 / HP;
  bool active;
  int head;

  __device__ Slot(int lane, int H)
      : active(lane * HP < H * HD), head(lane / LANES_PER_HEAD) {}

  __device__ bool leader(int lane) const {
    return active && lane % LANES_PER_HEAD == 0;
  }

  // `row` is 16-byte aligned (the wrapper checks the base; a row is
  // 128 H bytes)
  __device__ void load(const float* __restrict__ row, float (&v)[HP],
                       int lane) const {
    if (!active) {
#pragma unroll
      for (int q = 0; q < HP; ++q) v[q] = 0.f;
      return;
    }
    const float* p = row + HP * lane;
    if constexpr (HP >= 4) {
#pragma unroll
      for (int q = 0; q < HP; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(p + q);
        v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
      }
    } else if constexpr (HP == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      v[0] = t.x; v[1] = t.y;
    } else {
      v[0] = *p;
    }
  }

  __device__ void store(float* __restrict__ row, const float (&v)[HP],
                        int lane) const {
    if (!active) return;
    float* p = row + HP * lane;
    if constexpr (HP >= 4) {
#pragma unroll
      for (int q = 0; q < HP; q += 4)
        *reinterpret_cast<float4*>(p + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else if constexpr (HP == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  }

  // sum over the lanes of this lane's head
  __device__ static float head_sum(float v) {
#pragma unroll
    for (int o = LANES_PER_HEAD / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(FULL, v, o);
    return v;
  }

  // per-head values held by every lane -> the one of this lane's head
  __device__ float pick(const float (&v)[HP]) const {
    float r = v[0];
#pragma unroll
    for (int h = 1; h < HP; ++h)
      if (h == head) r = v[h];
    return r;
  }
};

// bit t set where byte t of the 4-byte word x is not zero
__device__ __forceinline__ unsigned nonzero4(unsigned x) {
  const unsigned m = __vcmpne4(x, 0u) & 0x01010101u;
  return (m * 0x01020408u) >> 24;  // gathers bits 0, 8, 16, 24 into 0..3
}

__device__ __forceinline__ unsigned nonzero16(uint4 w) {
  return nonzero4(w.x) | nonzero4(w.y) << 4 | nonzero4(w.z) << 8 |
         nonzero4(w.w) << 12;
}

// Mask bytes are read as the aligned 16-byte words that hold them.  A
// word that holds a byte of the mask lies in that byte's memory page, so
// the bytes of it outside the mask (or outside the tensor, where its
// storage is not 16-byte aligned) are read without fault and discarded.
__device__ __forceinline__ const uint4* word_of(const unsigned char* p,
                                                int& skew) {
  skew = (int)((uintptr_t)p & 15);
  return reinterpret_cast<const uint4*>(p - skew);
}

// bit t set where byte p[t] is not zero, for the n (1..16) bytes at p
__device__ __forceinline__ unsigned nonzero_bytes(const unsigned char* p,
                                                  int n) {
  int skew;
  const uint4* w = word_of(p, skew);
  unsigned long long bits = nonzero16(w[0]);
  if (skew + n > 16) bits |= (unsigned long long)nonzero16(w[1]) << 16;
  return (unsigned)(bits >> skew) & ((1u << n) - 1u);
}

// One row of the mask (n bytes) walked by a warp in sweeps of SWEEP
// columns: in a sweep each lane reads one 16-byte word, and the set
// columns are written in column order into a list in shared memory, as
// offsets from the sweep's first column.
struct MaskRow {
  const uint4* words;
  int skew;     // bytes of the first word before the row
  int n;
  int nwords;

  __device__ MaskRow(const unsigned char* row, int n_) : n(n_) {
    words = word_of(row, skew);
    nwords = (skew + n + 15) >> 4;
  }

  __device__ int sweeps() const { return (nwords + 31) >> 5; }

  // the column that offset 0 of sweep s stands for
  __device__ int col0(int s) const { return s * SWEEP - skew; }

  // Writes sweep s's set columns to list[0, count) and returns count
  // (the same in every lane).
  __device__ int compact(int s, int lane, unsigned short* list) const {
    const int w = s * 32 + lane;
    unsigned bits = 0;
    if (w < nwords) {
      bits = nonzero16(words[w]);
      const int first = w * 16 - skew;  // the column of byte 0
      if (first < 0) bits &= 0xffffu << -first;
      if (n - first < 16) bits &= (1u << (n - first)) - 1u;
    }
    const int cnt = __popc(bits);
    int incl = cnt;  // inclusive prefix sum of the counts over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    int at = incl - cnt;
    while (bits) {
      const int t = __ffs(bits) - 1;
      bits &= bits - 1;
      list[at++] = (unsigned short)(lane * 16 + t);
    }
    return __shfl_sync(FULL, incl, 31);
  }
};

}  // namespace gat
