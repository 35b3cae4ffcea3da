// Memory-placement simulator: rectify + roofline latency + reward for P
// mappings of one workload graph, in one launch.
//
// Replaces the `lax.scan` rectifier `_rectify_scan` and `latency` of
// src/repro/memsim/simulator.py (lines 163-213 and 241-269) and the
// reward of `evaluate` (:272-284), which the JAX package vmaps over the
// mappings in `evaluate_population` (:286).  PyTorch has no scan, and a
// per-step loop of tensor ops launches O(N) kernels per evaluation.
//
// Two entries share the block's body (`memsim_block`): `memsim_evaluate`
// (`memsim_kernel`) takes one graph, `memsim_evaluate_zoo`
// (`memsim_zoo_kernel`) one bucket of padded graphs of
// src/repro/memsim/batch.py (`evaluate_population_zoo`, :79, a vmap of
// the scan over the bucket): its grid is (mapping group, graph), and each
// block builds its graph's descriptor (pointers into the stacked arrays,
// real N, total_bytes, ref_latency) from the block's graph index.
//
// What bounds it: latency.  A rectify step depends on the free-byte
// counters the step before it left, so one mapping is N steps of one
// dependent chain, whatever the card's rates (on an H100 the roofline
// bound of BERT at P = 20 is 0.00004 ms).  In this kernel's SASS
// (sm_90a, cuobjdump -sass) a step's chain through a free counter is
// five instructions:
// FSETP (the weight's fit test, which takes the tier test as its
// predicate input) -> predicated FADD (subtract the weight) -> FSETP
// (the activation's) -> predicated FADD -> FADD (the release).  The
// control bits schedule 13 cycles from a compare to the instruction its
// predicate guards and 5 from an FADD to its dependent: 41 cycles a
// step.  The latency bound is N x 41 cycles + N x 5 (a dependent FADD
// of the ordered latency sum) + one device-memory round trip (taken as
// 1,000 cycles) for the first tile, at the SM clock; chip_smoke.py
// computes it per graph.  On an H100 (80GB HBM3, 700 W) the walk takes
// ~116 cycles a step, not 41: one warp issues it alone, 57 instructions
// a step, most of them compares, predicate logic and selects on the
// half-rate integer pipe (PERF.md §6).
//
// What the design does about it (a block is 16 warps and up to 32
// mappings; more mappings, more blocks):
// - warp 0 walks: lane p rectifies mapping p.  A step reads only shared
//   memory and registers: the node's record (w, a, and a split by
//   whether the node is its own last consumer), its ring offsets, and
//   the mapping's tiers one-hot, 4 steps to a word; the group of 4
//   steps after the current one is loaded into registers first, so no
//   load waits behind the ring's stores.  The three free counters and
//   `moved` stay in registers; the step is branch-free (predicated
//   adds), so the lanes advance in lockstep.  Each lane's (W, 3) ring of
//   release credits is one float4 per (row, lane), lanes side by side:
//   a pop and a push are one 16-byte access each, on distinct banks, and
//   the row a step pushes to is loaded at the step's start, so the
//   shared-memory round trip stays off the chain.
// - warps 1-3, 5-7, 9-11 and 13-15 (12 helpers; warps 4, 8 and 12 stay
//   idle, as they would share the walker's scheduler) stage the walk's
//   input a tile of TN nodes ahead, double-buffered: node records and
//   ring offsets, the tiers (read as whole node-contiguous (N, 2) rows),
//   the quotients a / bw_k and w wf / bw_k, and the tile's in_acts rows
//   (cp.async).  In the same phase they compute the latency terms of the
//   tile the walker finished one phase earlier, one (node, mapping) pair
//   a thread, the fan-in columns four at a time, and write its
//   rectified tiers out node-contiguous; then warp 1 adds the terms to
//   each mapping's sum in node order.  The latency pass runs beside the
//   walk; only the last tile's terms follow it.
// - tiles leave N unbounded in the walk's input.  What stays resident,
//   for the latency terms (an input may come from any earlier node), is
//   a byte of rectified tiers per (node, mapping) and 28 bytes of
//   quotients per node; where N needs it the launcher gives a block
//   fewer mappings.  N and W are run-time values.
//
// Float order is the reference's, bit for bit (compile with
// -fmad=false): each step subtracts the weight, then the activation;
// release credits accumulate per tier in ascending producer order from
// 0.0 and are added to the free counters only then (a node that is its
// own last consumer adds its activation to the popped credits); where
// the reference adds a zero one-hot term (x + 0.0, exact: every sum
// here is >= +0) the kernel adds nothing.  eps divides by the host-side
// total; latency adds (w_t + out_t) + in_t with the fan-in columns left
// to right, max with comp_t, + overhead, and sums the nodes strictly in
// order.
//
// Tiers in `mappings` must lie in [0, 3); `in_acts` rows hold their
// producers first and -1 only after them.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef MEMSIM_PHASE_CYCLES
// tools/memsim_phases.py builds with -DMEMSIM_PHASE_CYCLES: block 0
// records per phase the SM cycles of the walk (warp 0) and of warp 1's
// helper work up to the helpers' barrier
__device__ long long memsim_phase_cycles[2 * 4096];
#define PHASE_MARK(slot, t0)                                           \
  if (blockIdx.x == 0 && lane == 0 && i < 4096)                        \
    memsim_phase_cycles[2 * i + (slot)] = clock64() - (t0)
#else
#define PHASE_MARK(slot, t0)
#endif

namespace {

constexpr int TN = 64;                 // nodes per tile
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int HELPERS = 12;            // warps w with w % 4 != 0
constexpr int HELPER_THREADS = 32 * HELPERS;
constexpr int LANES = 32;              // mappings per block, at most
constexpr int TW = TN / 4 + 1;         // words per lane row of a tier tile
                                       // (odd: a lane row per bank)
static_assert(LANES * TN / 4 <= 2 * HELPER_THREADS, "2 tier words a helper");
static_assert(TN <= HELPER_THREADS, "a node record a helper");

struct Graph {                         // one workload graph
  const float* wb;                     // (N,) weight bytes
  const float* wf;                     // (N,) weight fraction streamed
  const float* ab;                     // (N,) activation bytes
  const float* flops;                  // (N,)
  const int* ring_t;                   // (N,) t % W
  const int* ring_lc;                  // (N,) last_consumer % W
  const float* self_rel;               // (N,) 1.0 iff last_consumer == t
  const int* in_acts;                  // (N, max_in) producers, -1 pad
  const float* total_bytes;            // () eps denominator
  int max_in, N, W;
};

struct Consts {
  float cap0, cap1, cap2, bw0, bw1, bw2, comp_denom, overhead, ref_latency,
      reward_scale;
};

struct Outs {
  const int* maps;                     // mapping p's (N, 2) int32 tiers at
                                       // maps + 2 * p * row
  int P, M;                            // mappings; per block
  size_t row;                          // nodes from one mapping's row to
                                       // the next
  int stride;                          // mapping p's scalars at [p * stride]
  int n_rows;                          // rows of rect per mapping (>= N;
                                       // those past N are written 0)
  float *reward, *eps, *lat, *speedup;
  unsigned char* valid;
  int* rect;                           // laid out as maps
};

// One bucket of padded graphs (the zoo entry): G graphs stacked at
// N_max nodes each, the ring W wide and max_in fan-in columns for all
struct Zoo {
  const float *wb, *wf, *ab, *flops;   // (G, N_max)
  const int *ring_t, *ring_lc;         // (G, N_max)
  const float* self_rel;               // (G, N_max)
  const int* in_acts;                  // (G, N_max, max_in)
  const float* total_bytes;            // (G,)
  const int* n_nodes;                  // (G,) real nodes
  const float* ref_latency;            // (G,)
  int max_in, N_max, W;
};

// byte offsets of the dynamic shared memory, from the launch's shapes
struct Layout {
  size_t ring, qa, wc, term, ia, rect, moved, bytes;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline Layout layout(int N, int W, int max_in, int M) {
  Layout L;
  size_t o = 0;
  L.ring = o;  o += align16((size_t)W * LANES * 16);       // float4 [W][32]
  L.qa = o;    o += align16((size_t)N * 12);               // a / bw_k
  L.wc = o;    o += (size_t)N * 16;                        // w*wf/bw_k, comp
  L.term = o;  o += (size_t)TN * LANES * 4;                // a tile's terms
  L.ia = o;    o += align16((size_t)2 * TN * max_in * 4);  // in_acts tiles
  L.rect = o;  o += align16((size_t)((N + 3) / 4) * M * 4); // tiers, 4/word
  L.moved = o; o += LANES * 4;
  L.bytes = o;
  return L;
}

__device__ __forceinline__ float pick(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// tier code (w | a << 2) of node t for lane p
__device__ __forceinline__ uint32_t tier_of(const uint32_t* rect_s, int M,
                                            int t, int p) {
  return (rect_s[(t >> 2) * M + p] >> (8 * (t & 3))) & 0xffu;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// bit != 0 and f >= v, as one compare that takes the tier test (made
// ahead, off the chain) as its predicate input
__device__ __forceinline__ bool fits(float f, float v, uint32_t bit) {
  uint32_t r;
  asm("{\n\t.reg .pred q, p;\n\tsetp.ne.u32 q, %1, 0;\n\t"
      "setp.ge.and.f32 p, %2, %3, q;\n\tselp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(bit), "f"(f), "f"(v));
  return r != 0;
}

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(HELPER_THREADS) : "memory");
}

// One rectify step of one mapping; returns its rectified tier code
// (w | a << 2) shifted to byte `sh / 8` of the tile's word.  `nd` is the
// node's (w, a, as, fut): its activation as the release of this step
// (as) or as a credit to its last consumer's row (fut), the other 0;
// `off` the byte offsets of its ring rows (popped, pushed to), `word` the
// mapping's tiers one-hot (weight bits 0-2, activation bits 3-5 of each
// byte) and `rl` the lane's column of the ring.
__device__ __forceinline__ uint32_t step(const float4 nd, const int2 off,
                                         const uint32_t word, const int sh,
                                         char* rl, float& f0, float& f1,
                                         float& f2, float& moved) {
  const float w = nd.x, a = nd.y, as = nd.z, fut = nd.w;
  float4* pop = reinterpret_cast<float4*>(rl + off.x);
  float4* push = reinterpret_cast<float4*>(rl + off.y);
  const uint32_t w0 = word & (1u << sh), w1 = word & (2u << sh),
                 w2 = word & (4u << sh), a0 = word & (8u << sh),
                 a1 = word & (16u << sh), a2 = word & (32u << sh);
  // pop this step's credits and recycle the row; then load the row the
  // activation's credit goes to (the popped one, zeroed, for a node that
  // is its own last consumer)
  const float4 r = *pop;
  *pop = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 x = *push;
  // weights: pinned for the whole run, spilled to HBM if they do not fit
  const bool kw1 = fits(f1, w, w1), kw2 = fits(f2, w, w2);
  const bool w_fits = kw1 | kw2 | fits(f0, w, w0);
  moved = w_fits ? moved : moved + w;
  f0 = (kw1 | kw2) ? f0 : f0 - w;
  f1 = kw1 ? f1 - w : f1;
  f2 = kw2 ? f2 - w : f2;
  // output activation: lives until its last consumer
  const bool k1 = fits(f1, a, a1), k2 = fits(f2, a, a2), k0 = !(k1 | k2);
  const bool a_fits = k1 | k2 | fits(f0, a, a0);
  moved = a_fits ? moved : moved + a;
  f0 = k0 ? f0 - a : f0;
  f1 = k1 ? f1 - a : f1;
  f2 = k2 ? f2 - a : f2;
  // credit the release to the last consumer's row (0 for a node that
  // releases itself: its activation is released below, in this step);
  // each credit is added only to the tier it is for (adding 0.0 to the
  // others would change no bit, but costs a select)
  float4 y = x, rr = r;
  if (k0) y.x = y.x + fut, rr.x = rr.x + as;
  if (k1) y.y = y.y + fut, rr.y = rr.y + as;
  if (k2) y.z = y.z + fut, rr.z = rr.z + as;
  *push = y;
  f0 = f0 + rr.x;
  f1 = f1 + rr.y;
  f2 = f2 + rr.z;
  uint32_t code = 0;
  if (kw1) code += 1u << sh;
  if (kw2) code += 2u << sh;
  if (k1) code += 4u << sh;
  if (k2) code += 8u << sh;
  return code;
}

// The block's work: mappings p0.. of group blockIdx.x on graph g
__device__ __forceinline__ void memsim_block(const Graph& g, const Consts& c,
                                             const Outs& o) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float4 node_s[2][TN + 4];   // + 4: the walker reads a group
  __shared__ int2 off_s[2][TN + 4];      // ahead, unused past the tile
  __shared__ uint32_t tier_s[2][LANES * TW];
  const int N = g.N, M = o.M, max_in = g.max_in;
  const Layout L = layout(N, g.W, max_in, M);
  float4* ring = reinterpret_cast<float4*>(smem + L.ring);
  float* qa_s = reinterpret_cast<float*>(smem + L.qa);
  float4* wc_s = reinterpret_cast<float4*>(smem + L.wc);
  float* term_s = reinterpret_cast<float*>(smem + L.term);
  int* ia_s = reinterpret_cast<int*>(smem + L.ia);
  uint32_t* rect_s = reinterpret_cast<uint32_t*>(smem + L.rect);
  float* moved_s = reinterpret_cast<float*>(smem + L.moved);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool helper = (warp & 3) != 0;
  const int h = warp - 1 - (warp >> 2);          // helper index, 0..11
  const int ht = h * 32 + lane;                  // helper thread index
  const int p0 = blockIdx.x * M;
  const int Mb = min(M, o.P - p0);               // mappings of this block
  const int nt = (N + TN - 1) / TN;

  // node records, quotients and tiers of tile T into buffer T & 1; every
  // global load of a stage is issued before its first store
  auto stage_nodes = [&](int T) {
    const int t0 = T * TN, cnt = min(TN, N - t0), buf = T & 1;
    const bool node = ht < cnt;
    const int t = t0 + (node ? ht : 0);
    const float w = g.wb[t], a = g.ab[t], wf = g.wf[t], fl = g.flops[t],
                sr = g.self_rel[t];
    const int rt = g.ring_t[t], rlc = g.ring_lc[t];
    int2 m[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = ht + u * HELPER_THREADS, p = k / (TN / 4),
                q = k % (TN / 4);
      const int2* mp = reinterpret_cast<const int2*>(o.maps) +
                       (size_t)(p0 + p) * o.row + t0 + 4 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m[u][j] = (p < Mb && 4 * q + j < cnt) ? mp[j] : make_int2(0, 0);
    }
    if (node) {
      const bool self = sr != 0.f;
      node_s[buf][ht] = make_float4(w, a, self ? a : 0.f, self ? 0.f : a);
      off_s[buf][ht] = make_int2(rt * LANES * 16, rlc * LANES * 16);
      qa_s[3 * t] = a / c.bw0;
      qa_s[3 * t + 1] = a / c.bw1;
      qa_s[3 * t + 2] = a / c.bw2;
      const float wwf = w * wf;
      wc_s[t] = make_float4(wwf / c.bw0, wwf / c.bw1, wwf / c.bw2,
                            fl / c.comp_denom);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = ht + u * HELPER_THREADS, p = k / (TN / 4),
                q = k % (TN / 4);
      if (p < Mb) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= ((1u << m[u][j].x) | (8u << m[u][j].y)) << (8 * j);
        tier_s[buf][p * TW + q] = word;
      }
    }
  };

  for (int k = tid; k < g.W * LANES; k += THREADS)
    ring[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (helper) stage_nodes(0);
  __syncthreads();

  float f0 = c.cap0, f1 = c.cap1, f2 = c.cap2, moved = 0.f;  // walker
  float lat = 0.f;                                           // warp 1
  for (int i = 0; i <= nt; ++i) {
#ifdef MEMSIM_PHASE_CYCLES
    const long long t_phase = clock64();
#endif
    if (warp == 0) {
      // ---------------------------------------------------- the walk
      if (i < nt && lane < Mb) {
        const int buf = i & 1, t0 = i * TN, cnt = min(TN, N - t0);
        const float4* nd = node_s[buf];
        const int2* od = off_s[buf];
        const uint32_t* tw = tier_s[buf] + lane * TW;
        uint32_t* rs = rect_s + (t0 >> 2) * M + lane;
        char* rl = reinterpret_cast<char*>(ring + lane);
        // a group's node records, ring offsets and tier word are loaded
        // into registers a group ahead: loads issued after the ring's
        // stores would wait behind them and join the chain
        const int groups = (cnt + 3) >> 2;
        float4 n[4];
        int2 of[4];
        uint32_t word = tw[0];
#pragma unroll
        for (int j = 0; j < 4; ++j) n[j] = nd[j], of[j] = od[j];
        for (int q = 0; q < groups; ++q) {
          float4 n2[4];
          int2 of2[4];
          const uint32_t word2 = tw[q + 1];   // TW > TN / 4: in bounds
#pragma unroll
          for (int j = 0; j < 4; ++j)
            n2[j] = nd[4 * q + 4 + j], of2[j] = od[4 * q + 4 + j];
          uint32_t out = 0;
          if (4 * q + 4 <= cnt) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              out |= step(n[j], of[j], word, 8 * j, rl, f0, f1, f2, moved);
          } else {
#pragma unroll
            for (int j = 0; j < 3; ++j)
              if (j < (cnt & 3))
                out |= step(n[j], of[j], word, 8 * j, rl, f0, f1, f2, moved);
          }
          rs[q * M] = out;
          word = word2;
#pragma unroll
          for (int j = 0; j < 4; ++j) n[j] = n2[j], of[j] = of2[j];
        }
        if (i == nt - 1) moved_s[lane] = moved;
      }
      PHASE_MARK(0, t_phase);
    } else if (helper) {
      // ------------------------------------------------------ helpers
      if (i < nt) {           // in_acts of tile i, for its terms next phase
        const int t0 = i * TN, cnt = min(TN, N - t0);
        int* dst = ia_s + (i & 1) * TN * max_in;
        const int* src = g.in_acts + (size_t)t0 * max_in;
        for (int k = ht; k < cnt * max_in; k += HELPER_THREADS)
          cp_async4(dst + k, src + k);
      }
      if (i + 1 < nt) stage_nodes(i + 1);
      if (i >= 1) {
        // latency terms of tile T, which the walker finished last phase
        const int T = i - 1, t0 = T * TN, cnt = min(TN, N - t0);
        const int* ia = ia_s + (T & 1) * TN * max_in;
        // one (node, mapping) pair a thread, so no lane idles when the
        // block has fewer than 32 mappings
        for (int k = ht; k < cnt * Mb; k += HELPER_THREADS) {
          const int j = k / Mb, p = k - j * Mb, t = t0 + j;
          const uint32_t code = tier_of(rect_s, M, t, p);
          const float4 wc = wc_s[t];
          const float w_t = pick(wc.x, wc.y, wc.z, code & 3);
          const float out_t = qa_s[3 * t + (code >> 2)];
          // fan-in columns four at a time: their loads are independent,
          // their adds stay in column order
          float in_t = 0.f;
          for (int col = 0; col < max_in; col += 4) {
            int src[4];
            float q[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              src[u] = col + u < max_in ? ia[j * max_in + col + u] : -1;
            if (src[0] < 0) break;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int sv = max(src[u], 0);
              q[u] = qa_s[3 * sv + (tier_of(rect_s, M, sv, p) >> 2)];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (src[u] >= 0) in_t = in_t + q[u];
          }
          term_s[j * LANES + p] =
              fmaxf((w_t + out_t) + in_t, wc.w) + c.overhead;
        }
        // rectified tiers of tile T out, node-contiguous per mapping
        for (int k = ht; k < Mb * TN; k += HELPER_THREADS) {
          const int p = k / TN, j = k % TN;
          if (j < cnt) {
            const uint32_t code = tier_of(rect_s, M, t0 + j, p);
            reinterpret_cast<int2*>(o.rect)[(size_t)(p0 + p) * o.row + t0 +
                                            j] =
                make_int2((int)(code & 3), (int)(code >> 2));
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (h == 0) PHASE_MARK(1, t_phase);
      if (i >= 1) {
        helpers_sync();
        if (h == 0 && lane < Mb) {
          const int cnt = min(TN, N - (i - 1) * TN);
#pragma unroll 8
          for (int j = 0; j < cnt; ++j) lat = lat + term_s[j * LANES + lane];
        }
      }
    }
    __syncthreads();
  }

  // rows past the graph's nodes (a padded graph of the zoo entry): 0
  const int pad = o.n_rows - N;
  if (helper && pad > 0)
    for (int k = ht; k < Mb * pad; k += HELPER_THREADS)
      reinterpret_cast<int2*>(o.rect)[(size_t)(p0 + k / pad) * o.row + N +
                                      k % pad] = make_int2(0, 0);
  if (helper && h == 0 && lane < Mb) {
    const int p = (p0 + lane) * o.stride;
    const float eps = moved_s[lane] / fmaxf(*g.total_bytes, 1.f);
    const bool valid = eps <= 0.f;
    const float speedup = c.ref_latency / lat;
    o.reward[p] = valid ? c.reward_scale * speedup : -eps;
    o.eps[p] = eps;
    o.lat[p] = lat;
    o.speedup[p] = valid ? speedup : 0.f;
    o.valid[p] = valid ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    memsim_kernel(const Graph g, const Consts c, const Outs o) {
  memsim_block(g, c, o);
}

// One bucket of the zoo in one launch: block (x, y) takes mapping group
// x on graph y.  The block walks only the graph's real nodes: the steps
// over its padded nodes (zero bytes, self-releasing) would be IEEE
// identities (src/repro/graphs/batch.py), so walking them would change no
// bit; the latency sum skips their terms, which the reference multiplies
// by a 0 mask, for the same reason.  Padded rows of `rect` are written 0.
__global__ void __launch_bounds__(THREADS, 1)
    memsim_zoo_kernel(const Zoo z, const Consts c, const Outs o) {
  const int gi = blockIdx.y;
  const size_t n0 = (size_t)gi * z.N_max;
  const Graph g{z.wb + n0, z.wf + n0, z.ab + n0, z.flops + n0,
                z.ring_t + n0, z.ring_lc + n0, z.self_rel + n0,
                z.in_acts + n0 * z.max_in, z.total_bytes + gi, z.max_in,
                z.n_nodes[gi], z.W};
  Consts cg = c;
  cg.ref_latency = z.ref_latency[gi];
  Outs og = o;
  og.maps = o.maps + 2 * n0;
  og.rect = o.rect + 2 * n0;
  og.reward = o.reward + gi;
  og.eps = o.eps + gi;
  og.lat = o.lat + gi;
  og.speedup = o.speedup + gi;
  og.valid = o.valid + gi;
  memsim_block(g, cg, og);
}

// static shared memory: node records, ring offsets and tier words, two
// tiles each
constexpr size_t STATIC_SMEM = 2 * (TN + 4) * (16 + 8) + 2 * LANES * TW * 4;

// Mappings per block M, blocks over the mappings and dynamic shared
// memory for P mappings of graphs up to (N, W, max_in); static and
// dynamic shared memory together stay within the block's 227 KB.  Where
// the two pass 48 KB it raises the kernel's dynamic limit, always to the
// same largest value: the limit belongs to the kernel, not the launch,
// so a smaller value set by another thread between this thread's set and
// its launch would fail the launch.  Returns a CUDA error code.
template <typename K>
int configure(K kernel, int N, int W, int max_in, int P, int& M, int& blocks,
              size_t& smem) {
  const size_t max_dyn = 232448 - STATIC_SMEM;
  blocks = (P + LANES - 1) / LANES;
  M = (P + blocks - 1) / blocks;
  while (M > 1 && layout(N, W, max_in, M).bytes > max_dyn) M = (M + 1) / 2;
  smem = layout(N, W, max_in, M).bytes;
  if (smem > max_dyn) return (int)cudaErrorInvalidValue;
  blocks = (P + M - 1) / M;
  if (STATIC_SMEM + smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_dyn);
  return 0;
}

}  // namespace

extern "C" int memsim_evaluate(
    const float* wb, const float* wf, const float* ab, const float* flops,
    const int* ring_t, const int* ring_lc, const float* self_rel,
    const int* in_acts, const float* total_bytes, int max_in, int N, int W,
    float cap0, float cap1, float cap2, float bw0, float bw1, float bw2,
    float comp_denom, float overhead, float ref_latency, float reward_scale,
    const int* mappings, int P, float* reward, float* eps, float* lat,
    float* speedup, unsigned char* valid, int* rect, void* stream) {
  if (P < 1 || N < 1 || W < 1 || max_in < 1)
    return (int)cudaErrorInvalidValue;
  int M, blocks;
  size_t smem;
  const int e = configure(memsim_kernel, N, W, max_in, P, M, blocks, smem);
  if (e) return e;
  const Graph g{wb, wf, ab, flops, ring_t, ring_lc, self_rel, in_acts,
                total_bytes, max_in, N, W};
  const Consts c{cap0, cap1, cap2, bw0, bw1, bw2, comp_denom, overhead,
                 ref_latency, reward_scale};
  const Outs o{mappings, P, M, (size_t)N, 1, N, reward, eps, lat, speedup,
               valid, rect};
  memsim_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(g, c, o);
  return (int)cudaGetLastError();
}

// One bucket of G padded graphs (N_max nodes, ring W, max_in columns
// each; n_nodes real ones) for P mappings in one launch.  mappings and
// rect are (P, G, N_max, 2) int32; reward, eps, lat, speedup and valid
// (P, G).  Shared memory is sized once from (N_max, W, max_in).
extern "C" int memsim_evaluate_zoo(
    const float* wb, const float* wf, const float* ab, const float* flops,
    const int* ring_t, const int* ring_lc, const float* self_rel,
    const int* in_acts, const float* total_bytes, const int* n_nodes,
    const float* ref_latency, int max_in, int N_max, int W, int G,
    float cap0, float cap1, float cap2, float bw0, float bw1, float bw2,
    float comp_denom, float overhead, float reward_scale,
    const int* mappings, int P, float* reward, float* eps, float* lat,
    float* speedup, unsigned char* valid, int* rect, void* stream) {
  if (P < 1 || N_max < 1 || W < 1 || max_in < 1 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  int M, blocks;
  size_t smem;
  const int e =
      configure(memsim_zoo_kernel, N_max, W, max_in, P, M, blocks, smem);
  if (e) return e;
  const Zoo z{wb, wf, ab, flops, ring_t, ring_lc, self_rel, in_acts,
              total_bytes, n_nodes, ref_latency, max_in, N_max, W};
  const Consts c{cap0, cap1, cap2, bw0, bw1, bw2, comp_denom, overhead,
                 0.f, reward_scale};
  const Outs o{mappings, P, M, (size_t)G * N_max, G, N_max, reward, eps,
               lat, speedup, valid, rect};
  memsim_zoo_kernel<<<dim3(blocks, G), THREADS, smem,
                      (cudaStream_t)stream>>>(z, c, o);
  return (int)cudaGetLastError();
}

#ifdef MEMSIM_PHASE_CYCLES
extern "C" int memsim_phase_cycles_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, memsim_phase_cycles,
                                   n * sizeof(long long));
}
#endif
