// EmbeddingBag for Hopper (sm_90a): the weighted sum of table rows per bag,
// out[b] = sum over the lookups i of bag b, in order, of w[i] * table[idx[i]].
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py::_kernel.
// That kernel runs one sequential grid step per lookup: scalar-prefetched
// indices pick the table row block to DMA, and consecutive lookups of one
// bag revisit the same output block in VMEM, accumulating into it (each bag
// is seeded with a zero-weight lookup so an empty bag is written).  Blocks
// on a GPU run in no order and carry nothing between them, so here the
// lookups arrive as CSR: the wrapper stable-sorts them by bag id and passes
// offsets[n_bags + 1].  One thread owns one (bag, column) pair and walks its
// bag's lookups in order, acc = acc + table[idx] * w (multiplied, rounded,
// then added: the Pallas kernel's order and rounding), and writes the sum
// once.  An empty bag writes 0; no seed lookup and no atomics, so the result
// is deterministic and sums each bag in the plain version's order.
//
// Neighbouring threads take neighbouring columns of a row, so a row gather
// is contiguous.  Any width E is taken: xDeepFM's E = 10 gives 40-byte rows,
// not 16-byte aligned, so the loads are 4 bytes a thread.
//
// Bound on this card: bytes.  A lookup moves its row (4·E bytes), its index,
// weight and (amortised) offset: about 52 B at E = 10, plus 4·E bytes out
// per bag; one multiply and one add per element.  A 40-byte row at a random
// address touches 2-3 of the 32-byte sectors the memory system moves, so the
// practical floor lies above that count.  Table rows are addressed with
// 64-bit arithmetic: tables of 10^9 rows overflow 32-bit offsets.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ w,
                         const long long* __restrict__ offsets,
                         float* __restrict__ out, long long n_bags, int e) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_bags * e) return;
  const long long bag = t / e;
  const int col = static_cast<int>(t - bag * e);
  const long long hi = offsets[bag + 1];
  float acc = 0.0f;
  for (long long i = offsets[bag]; i < hi; ++i) {
    const float x = table[static_cast<long long>(idx[i]) * e + col];
    acc = __fadd_rn(acc, __fmul_rn(x, w[i]));
  }
  out[t] = acc;
}

}  // namespace

// table: [v, e] f32; idx, w: [l] i32 / f32, sorted by bag (stable);
// offsets: [n_bags + 1] i64, bag b's lookups are [offsets[b], offsets[b+1]);
// out: [n_bags, e] f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    const float* w, const long long* offsets,
                                    float* out, long long n_bags, int e,
                                    void* stream) {
  const int threads = 256;
  const long long total = n_bags * e;
  if (total > 0) {
    const long long blocks = (total + threads - 1) / threads;
    embedding_bag_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, idx, w, offsets, out, n_bags, e);
  }
  return static_cast<int>(cudaGetLastError());
}
