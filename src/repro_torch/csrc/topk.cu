// Per-row top-k for Hopper (sm_90a): the k largest scores of every row with
// their column indices, ties to the lower index (jax.lax.top_k's order).
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::_topk_kernel and its
// sorting network repro/kernels/bitonic.py (sort_desc, merge_desc, _stage,
// _compare_exchange).  That kernel walks the grid's document axis in order
// on one core and carries the running top-k in VMEM scratch between grid
// steps.  Blocks on a GPU run in no order, so here one block owns one row
// and loops over its document tiles itself: each tile of
// block_d = max(2·k2, 512) (value, index) pairs is bitonic-sorted in shared
// memory (2,048 × 8 B = 16 KB at k = 1000), then merged into the running
// k2 = next_pow2(k, 128) buffer (8 KB) by the half-cleaner of the bitonic
// merge and log2(k2) more stages.
//
// Bound on this card: bytes.  The kernel must read Q·D·4 bytes of scores
// and write Q·k·8, and a sort is a few compares per element; the design
// reads each score exactly once (coalesced) and keeps every sort stage in
// shared memory.  It is the simple version: every tile is fully sorted,
// with a barrier per stage, which makes it latency-bound well above the
// byte bound (see PERF.md).
//
// The compare-exchange lives in bitonic.cuh, shared with the host check.
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    topk_kernel(const float* __restrict__ scores, float* __restrict__ out_v,
                int* __restrict__ out_i, int d, int k, int k2, int block_d) {
  extern __shared__ float smem[];
  float* tv = smem;                                    // [block_d]
  int* ti = reinterpret_cast<int*>(tv + block_d);      // [block_d]
  float* rv = reinterpret_cast<float*>(ti + block_d);  // [k2]
  int* ri = reinterpret_cast<int*>(rv + k2);           // [k2]

  const size_t row = blockIdx.x;
  const float* s = scores + row * d;
  const int nt = blockDim.x;
  const int t0 = threadIdx.x;

  for (int base = 0; base < d; base += block_d) {
    // Columns past d are -inf with indices >= d, as the Pallas kernel pads.
    for (int p = t0; p < block_d; p += nt) {
      const int g = base + p;
      tv[p] = g < d ? s[g] : -__int_as_float(0x7f800000);
      ti[p] = g;
    }
    __syncthreads();
    for (int kk = 2; kk <= block_d; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int t = t0; t < block_d / 2; t += nt) bt::stage_pair(tv, ti, j, kk, t);
        __syncthreads();
      }
    }
    if (base == 0) {
      for (int p = t0; p < k2; p += nt) {
        rv[p] = tv[p];
        ri[p] = ti[p];
      }
    } else {
      for (int t = t0; t < k2; t += nt) bt::keep_first(rv, ri, tv, ti, k2, t);
      __syncthreads();
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        for (int t = t0; t < k2 / 2; t += nt) bt::stage_pair(rv, ri, j, 2 * k2, t);
        __syncthreads();
      }
    }
    __syncthreads();
  }
  for (int p = t0; p < k; p += nt) {
    out_v[row * k + p] = rv[p];
    out_i[row * k + p] = ri[p];
  }
}

}  // namespace

// scores: [q, d] f32; out_v: [q, k] f32; out_i: [q, k] i32.  k2 is a power
// of two >= k and block_d a power of two >= k2.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int topk_launch(const float* scores, float* out_v, int* out_i,
                           int q, int d, int k, int k2, int block_d,
                           void* stream) {
  const int threads = block_d / 2 < 1024 ? block_d / 2 : 1024;
  const size_t smem = (static_cast<size_t>(block_d) + k2) * 8;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(topk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (q > 0 && d > 0) {
    topk_kernel<<<q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        scores, out_v, out_i, d, k, k2, block_d);
  }
  return static_cast<int>(cudaGetLastError());
}
