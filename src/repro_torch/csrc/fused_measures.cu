// Fused trec_eval measure pass for Hopper (sm_90a): all 55 standard columns
// of every query from its rank-sorted relevance row, in one read of the row.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_measures.py::_kernel
// (built by _measure_call, wrapped by fused_measures), which keeps a
// [block_q, D] tile in VMEM and takes log2(D) shifted-add prefix sums over
// it.  VMEM holds many megabytes; a Hopper SM has 227 KB of shared memory
// and D reaches 65,536, so a whole row does not fit.  Instead one block of
// 256 threads walks its query's row in tiles of 1,024 ranks (4 per
// thread), scans each tile with warp shuffles plus one shared-memory pass
// over the 8 warp totals, and carries the running sums from tile to tile.
// Cutoff reads are recorded by the thread that owns the cutoff rank.
//
// Bound on this card: bytes.  Per query it reads 2·D·4 bytes (rel, judged)
// and 16·4 of scalars and writes 64·4, for ~20 flops per rank; at 3.35 TB/s
// the data takes far longer than the arithmetic.  The design reads each
// input element exactly once, keeps every intermediate in registers or
// shared memory, and writes only the [Q, 64] result.  It is the simple
// version: scalar loads, one block per query, no TMA.
//
// The per-rank arithmetic lives in fused_measures.cuh, shared with the
// host check.  Build without --use_fast_math: see the header.
#include <cuda_runtime.h>

#include "fused_measures.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// Exclusive prefix (over the block's threads, in thread order) and block
// total of N per-thread values.  `smem` holds one row of N per warp.
template <int N>
__device__ __forceinline__ void block_scan(const float (&x)[N], float (&excl)[N],
                                           float (&total)[N],
                                           float (*smem)[N]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float incl[N];
#pragma unroll
  for (int n = 0; n < N; ++n) incl[n] = x[n];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float y = __shfl_up_sync(0xffffffffu, incl[n], off);
      if (lane >= off) incl[n] += y;
    }
  }
  float prev[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    prev[n] = __shfl_up_sync(0xffffffffu, incl[n], 1);
    if (lane == 0) prev[n] = 0.0f;
  }
  if (lane == 31) {
#pragma unroll
    for (int n = 0; n < N; ++n) smem[warp][n] = incl[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float before = 0.0f;
    float all = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float t = smem[w][n];
      if (w < warp) before += t;
      all += t;
    }
    excl[n] = before + prev[n];
    total[n] = all;
  }
  __syncthreads();  // smem is reused by the next scan
}

__global__ void __launch_bounds__(kThreads)
    fused_measures_kernel(const float* __restrict__ rel,
                          const float* __restrict__ judged,
                          const float* __restrict__ scalars,
                          float* __restrict__ out, int d, float level) {
  __shared__ float scan4[kWarps][4];
  __shared__ float scan1[kWarps][1];
  __shared__ float red[kWarps][4];
  __shared__ fm::Cut cuts[fm::kNumSlots];

  const size_t row = blockIdx.x;
  const float* r = rel + row * d;
  const float* jd = judged + row * d;
  const float* scal = scalars + row * fm::kScalarWidth;
  const float n_rel = scal[0];
  const float n_nonrel = scal[1];

  float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // cum, jn, cj, dcg
  float carry_ap = 0.0f;
  fm::Acc acc = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int base = 0; base < d; base += kTile) {
    const int p0 = base + threadIdx.x * kItems;
    float rv[kItems], jv[kItems];
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = p0 + i;
      rv[i] = p < d ? r[p] : 0.0f;
      jv[i] = p < d ? jd[p] : 0.0f;
      if (p < d) {
        float e[4];
        fm::scan_inputs(rv[i], jv[i], static_cast<float>(p + 1), level, e);
#pragma unroll
        for (int n = 0; n < 4; ++n) x[n] += e[n];
      }
    }
    float ex[4], tot[4];
    block_scan<4>(x, ex, tot, scan4);

    // First walk: this thread's share of the AP sum, for the AP scan.
    fm::Prefix pre = {carry[0] + ex[0], carry[1] + ex[1], carry[2] + ex[2],
                      carry[3] + ex[3], 0.0f};
    const fm::Prefix start = pre;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (p0 + i < d) {
        fm::step(rv[i], jv[i], p0 + i, d, level, n_rel, n_nonrel, pre,
                 nullptr, nullptr);
      }
    }
    float xa[1] = {pre.ap};
    float exa[1], tota[1];
    block_scan<1>(xa, exa, tota, scan1);

    // Second walk: full prefix; reductions and cutoff slots.
    pre = start;
    pre.ap = carry_ap + exa[0];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (p0 + i < d) {
        fm::step(rv[i], jv[i], p0 + i, d, level, n_rel, n_nonrel, pre, &acc,
                 cuts);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) carry[n] += tot[n];
    carry_ap += tota[0];
  }

  float a[4] = {acc.bpref, acc.zeros, acc.rel_at_r, acc.rbp};
  float ignore[4], sums[4];
  block_scan<4>(a, ignore, sums, red);  // also orders the cut writes
  if (threadIdx.x == 0) {
    const fm::Acc all = {sums[0], sums[1], sums[2], sums[3]};
    float o[fm::kOutWidth];
    fm::finalize(cuts, all, scal, o);
    float* dst = out + row * fm::kOutWidth;
    for (int c = 0; c < fm::kOutWidth; ++c) dst[c] = o[c];
  }
}

}  // namespace

// rel, judged: [q, d] f32 rank-sorted rows; scalars: [q, 16] f32;
// out: [q, 64] f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_measures_launch(const float* rel, const float* judged,
                                     const float* scalars, float* out, int q,
                                     int d, float level, void* stream) {
  if (q > 0 && d > 0) {
    fused_measures_kernel<<<q, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rel, judged, scalars, out, d, level);
  }
  return static_cast<int>(cudaGetLastError());
}
