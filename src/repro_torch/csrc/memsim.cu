// Memory-placement simulator: rectify + roofline latency + reward for P
// mappings of one workload graph, one thread per mapping.
//
// Replaces the `lax.scan` rectifier `_rectify_scan` and `latency` in
// src/repro/memsim/simulator.py (lines 163-213 and 241-269), which the
// JAX package vmaps over the population in `evaluate_population`.
// PyTorch has no scan, and a per-step loop of tensor ops launches
// O(N) kernels per generation, so the whole evaluation is one launch.
//
// What bounds it on an H100: nothing the card is rated for.  The scan
// is sequential over the N nodes and the population is small (P = 20),
// so one warp does all the work and the time is the latency of N
// dependent steps.  The design keeps everything a step touches on
// chip: the three free-byte counters and `moved` live in registers,
// each thread's (W, 3) ring of release credits lives in shared memory
// (interleaved by thread, so the warp's accesses hit distinct banks),
// and the per-node arrays are read-only loads that every thread of the
// warp shares.
//
// Float order is the reference's, bit for bit (compile with
// -fmad=false): each step subtracts the weight, then the activation;
// release credits accumulate per tier in ascending producer order from
// 0.0 and are added to the free counters only then; eps divides by the
// host-side total; latency adds (w_t + out_t) + in_t with the fan-in
// columns left to right and sums the nodes strictly in order.
//
// Tiers in `mappings` must lie in [0, 3).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float pick(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__global__ void memsim_kernel(
    const float* __restrict__ wb, const float* __restrict__ wf,
    const float* __restrict__ ab, const float* __restrict__ flops,
    const int* __restrict__ ring_t, const int* __restrict__ ring_lc,
    const float* __restrict__ self_rel, const int* __restrict__ in_acts,
    const float* __restrict__ total_bytes, int max_in, int N, int W,
    float cap0, float cap1, float cap2, float bw0, float bw1, float bw2,
    float comp_denom, float overhead, float ref_latency, float reward_scale,
    const int* __restrict__ mappings, int P, float* __restrict__ reward,
    float* __restrict__ eps_out, float* __restrict__ lat_out,
    float* __restrict__ speedup_out, unsigned char* __restrict__ valid_out,
    int* __restrict__ rect) {
  extern __shared__ float ring_all[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int p = blockIdx.x * T + tid;
  if (p >= P) return;  // no block-wide barrier below
#define RING(row, k) ring_all[((row) * 3 + (k)) * T + tid]
  for (int k = 0; k < W * 3; ++k) ring_all[k * T + tid] = 0.f;

  const int* mp = mappings + (size_t)p * N * 2;
  int* rp = rect + (size_t)p * N * 2;
  float f0 = cap0, f1 = cap1, f2 = cap2;
  float moved = 0.f;
  for (int t = 0; t < N; ++t) {
    // pop this step's release credits and recycle the row
    const int tm = ring_t[t];
    const float r0 = RING(tm, 0), r1 = RING(tm, 1), r2 = RING(tm, 2);
    RING(tm, 0) = 0.f;
    RING(tm, 1) = 0.f;
    RING(tm, 2) = 0.f;
    const int wt = mp[2 * t], at = mp[2 * t + 1];
    const float w = wb[t], a = ab[t];
    // weights: pinned for the whole run, spilled to HBM if they do not fit
    const bool w_fits = pick(f0, f1, f2, wt) >= w;
    const int w_tier = w_fits ? wt : 0;
    if (!w_fits) moved = moved + w;
    if (w_tier == 0) f0 = f0 - w;
    else if (w_tier == 1) f1 = f1 - w;
    else f2 = f2 - w;
    // output activation: lives until its last consumer
    const bool a_fits = pick(f0, f1, f2, at) >= a;
    const int a_tier = a_fits ? at : 0;
    if (!a_fits) moved = moved + a;
    if (a_tier == 0) f0 = f0 - a;
    else if (a_tier == 1) f1 = f1 - a;
    else f2 = f2 - a;
    // credit the release to the last consumer's ring row; a node that
    // is its own last consumer releases in this step instead
    const bool self = self_rel[t] != 0.f;
    if (!self) RING(ring_lc[t], a_tier) += a;
    f0 = f0 + (r0 + ((self && a_tier == 0) ? a : 0.f));
    f1 = f1 + (r1 + ((self && a_tier == 1) ? a : 0.f));
    f2 = f2 + (r2 + ((self && a_tier == 2) ? a : 0.f));
    rp[2 * t] = w_tier;
    rp[2 * t + 1] = a_tier;
  }
#undef RING
  const float eps = moved / fmaxf(*total_bytes, 1.f);

  // roofline latency of the rectified mapping, summed in node order
  float lat = 0.f;
  for (int t = 0; t < N; ++t) {
    const float w_t = (wb[t] * wf[t]) / pick(bw0, bw1, bw2, rp[2 * t]);
    const float out_t = ab[t] / pick(bw0, bw1, bw2, rp[2 * t + 1]);
    float in_t = 0.f;
    for (int c = 0; c < max_in; ++c) {
      const int src = in_acts[t * max_in + c];
      const float term =
          src >= 0 ? ab[src] / pick(bw0, bw1, bw2, rp[2 * src + 1]) : 0.f;
      in_t = c == 0 ? term : in_t + term;
    }
    const float mem_t = (w_t + out_t) + in_t;
    const float comp_t = flops[t] / comp_denom;
    lat = lat + (fmaxf(mem_t, comp_t) + overhead);
  }

  const bool valid = eps <= 0.f;
  const float speedup = ref_latency / lat;
  reward[p] = valid ? reward_scale * speedup : -eps;
  eps_out[p] = eps;
  lat_out[p] = lat;
  speedup_out[p] = valid ? speedup : 0.f;
  valid_out[p] = valid ? 1 : 0;
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
  if (P < 1 || N < 1 || W < 1 || max_in < 1) return (int)cudaErrorInvalidValue;
  const size_t per_thread = (size_t)W * 3 * sizeof(float);
  const size_t max_smem = 227 * 1024;
  int threads = 32;
  while (threads > 1 && threads * per_thread > max_smem) threads >>= 1;
  const size_t smem = threads * per_thread;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        memsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P + threads - 1) / threads;
  memsim_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      wb, wf, ab, flops, ring_t, ring_lc, self_rel, in_acts, total_bytes,
      max_in, N, W, cap0, cap1, cap2, bw0, bw1, bw2, comp_denom, overhead,
      ref_latency, reward_scale, mappings, P, reward, eps, lat, speedup,
      valid, rect);
  return (int)cudaGetLastError();
}
