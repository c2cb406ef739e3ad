// EmbeddingBag for Hopper (sm_90a): the weighted sum of table rows per bag,
// out[b] = sum over the lookups i of bag b, in order, of w[i] * table[idx[i]].
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py::_kernel.
// That kernel runs one sequential grid step per lookup: scalar-prefetched
// indices pick the table row block to DMA, and consecutive lookups of one
// bag revisit the same output block in VMEM, accumulating into it (each bag
// is seeded with a zero-weight lookup so an empty bag is written).  Blocks
// on a GPU run in no order and carry nothing between them, so here a thread
// owns one (bag, column) -- or two neighbouring columns -- walks its bag's
// lookups in order, acc = acc + table[idx] * w (multiplied, rounded, then
// added: the Pallas kernel's order and rounding), and writes the sum once.
// No seed lookup and no atomics: the result is deterministic and sums each
// bag in the plain version's order.  Two entry points:
//
// * Fixed-length bags (the recsys multi-hot fields): ids [n_bags, m], bag n
//   owns lookups [n·m, n·m + m), so the offsets are implicit and the
//   lookups need no sort.  Bag n belongs to field n % fields, whose ids are
//   offset by field · field_rows, so one launch covers every multi-hot
//   field of a batch.  Each lookup weighs its bool mask entry (1 / 0), or
//   1 without a mask.  m = 8 (xDeepFM's) is a template constant, so the
//   eight row loads are issued together before the in-order adds.  Rows of
//   an even width E (xDeepFM: 40 bytes) are read as 8-byte pairs.  An id
//   outside [0, V) stops the kernel with __trap(): nothing out of range is
//   read, no host sync is needed, and the failure shows at the next
//   synchronisation.  Masked-out lookups are still multiplied in: in the
//   reference a non-finite row times 0 is NaN.
// * Any order (CSR): the wrapper stable-sorts the lookups by bag and passes
//   offsets[n_bags + 1]; lookups are read eight at a time, loads first.
//
// Bound on this card: bytes.  A lookup moves its index and weight (8 B;
// 5 B with a bool mask) and, the first time it is touched, its row (4·E bytes); each bag is
// written once (4·E bytes); one multiply and one add per element.  A
// 40-byte row at a random address touches 2-3 of the 32-byte sectors the
// memory system moves, so the practical floor lies above that count.
// Table rows are addressed with 64-bit arithmetic: tables of 10^9 rows
// overflow 32-bit offsets.
//
// The backward of the fixed-length entry (embedding_bag_fixed_backward_launch,
// at the end) replaces no Pallas kernel: the JAX package's training path
// gathers without its kernel (repro/models/embedding.py, use_kernel=False)
// and XLA forms the scatter.  It computes the table's gradient,
// d_table[row] = sum over the lookups (n, j) with row(n, j) == row, in
// lookup order, of d_out[n] * mask[n, j].  A float atomicAdd per lookup
// would sum a row in whatever order the lookups arrive, so two launches
// could differ in the last bits.  Instead the wrapper stable-sorts the
// flattened rows (torch.sort), which puts the lookups of one row next to
// each other in lookup order; the thread of (sorted position i, column c)
// at the start of a run of equal rows walks the run, adds in that order
// with the forward's rounding (multiply, round, add, round), and writes the
// row once.  Threads off a run's start return at once.  Deterministic: the
// same inputs give the same bits on every launch.  Rows never touched keep
// the zeros the wrapper allocated.  Bound on this card: bytes, dominated by
// the dense [V, E] gradient the function returns (written once); the
// kernel's own traffic is the sorted rows and order (16 B a lookup), the
// mask byte and one d_out row read per lookup.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
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
  long long i = offsets[bag];
  for (; i + 8 <= hi; i += 8) {
    float x[8], wt[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wt[j] = w[i + j];
      x[j] = table[static_cast<long long>(idx[i + j]) * e + col];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], wt[j]));
  }
  for (; i < hi; ++i) {
    const float x = table[static_cast<long long>(idx[i]) * e + col];
    acc = __fadd_rn(acc, __fmul_rn(x, w[i]));
  }
  out[t] = acc;
}

// Weight of lookup j: 1 without a mask, else the mask as 1 / 0 (the
// reference's mask.astype(float32)).
__device__ __forceinline__ float weight(const unsigned char* mask, int j) {
  return mask ? (mask[j] ? 1.0f : 0.0f) : 1.0f;
}

template <int VEC>
struct Cols;
template <>
struct Cols<1> {
  float x;
  __device__ __forceinline__ void zero() { x = 0.0f; }
  __device__ __forceinline__ void load(const float* p) { x = __ldg(p); }
  __device__ __forceinline__ void add(const Cols& r, float w) {
    x = __fadd_rn(x, __fmul_rn(r.x, w));
  }
  __device__ __forceinline__ void store(float* p) const { p[0] = x; }
};
template <>
struct Cols<2> {
  float x, y;
  __device__ __forceinline__ void zero() { x = y = 0.0f; }
  __device__ __forceinline__ void load(const float* p) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    x = f.x;
    y = f.y;
  }
  __device__ __forceinline__ void add(const Cols& r, float w) {
    x = __fadd_rn(x, __fmul_rn(r.x, w));
    y = __fadd_rn(y, __fmul_rn(r.y, w));
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// One thread per (bag, VEC columns).  M > 0: m == M, fully unrolled.
template <int M, int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_fixed_kernel(const float* __restrict__ table,
                               long long v_rows, int e,
                               const int* __restrict__ ids,
                               const unsigned char* __restrict__ mask,
                               long long n_bags,
                               int m_runtime, int fields,
                               long long field_rows,
                               float* __restrict__ out) {
  const int m = M > 0 ? M : m_runtime;
  const int lanes = e / VEC;  // threads per bag
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_bags * lanes) return;
  const long long bag = t / lanes;
  const int col = static_cast<int>(t - bag * lanes) * VEC;
  const long long first = (bag % fields) * field_rows;
  const int* bag_ids = ids + bag * m;
  const unsigned char* bag_mask = mask ? mask + bag * m : nullptr;
  Cols<VEC> acc;
  acc.zero();
  if constexpr (M > 0) {
    Cols<VEC> x[M];
    float wt[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const long long row = __ldg(bag_ids + j) + first;
      if (static_cast<unsigned long long>(row) >=
          static_cast<unsigned long long>(v_rows)) {
        __trap();
      }
      wt[j] = weight(bag_mask, j);
      x[j].load(table + row * e + col);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) acc.add(x[j], wt[j]);
  } else {
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const long long row = __ldg(bag_ids + j) + first;
      if (static_cast<unsigned long long>(row) >=
          static_cast<unsigned long long>(v_rows)) {
        __trap();
      }
      Cols<VEC> x;
      x.load(table + row * e + col);
      acc.add(x, weight(bag_mask, j));
    }
  }
  acc.store(out + bag * e + col);
}

template <int M, int VEC>
void launch_fixed(const float* table, long long v, int e, const int* ids,
                  const unsigned char* mask, long long n_bags, int m,
                  int fields, long long field_rows, float* out,
                  cudaStream_t st) {
  const long long total = n_bags * (e / VEC);
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  embedding_bag_fixed_kernel<M, VEC><<<blocks, kThreads, 0, st>>>(
      table, v, e, ids, mask, n_bags, m, fields, field_rows, out);
}

template <int VEC>
void launch_fixed_m(const float* table, long long v, int e, const int* ids,
                    const unsigned char* mask, long long n_bags, int m,
                    int fields, long long field_rows, float* out,
                    cudaStream_t st) {
  if (m == 8) {  // xDeepFM's multi-hot length
    launch_fixed<8, VEC>(table, v, e, ids, mask, n_bags, m, fields,
                         field_rows, out, st);
  } else {
    launch_fixed<0, VEC>(table, v, e, ids, mask, n_bags, m, fields,
                         field_rows, out, st);
  }
}

// One thread per (sorted lookup i, column c); only a run's first thread
// works.  rows: [l] sorted (stable) table rows; order: [l] the lookups'
// positions n·m + j in that order; d_out: [n_bags, e]; d_table: [v, e],
// zero on entry, each touched row written once.
__global__ void __launch_bounds__(kThreads)
    embedding_bag_fixed_backward_kernel(
        const long long* __restrict__ rows,
        const long long* __restrict__ order,
        const float* __restrict__ d_out,
        const unsigned char* __restrict__ mask, long long l, int m, int e,
        long long v_rows, float* __restrict__ d_table) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= l * e) return;
  const long long i = t / e;
  const int col = static_cast<int>(t - i * e);
  const long long row = rows[i];
  if (i > 0 && rows[i - 1] == row) return;  // not the start of a run
  if (static_cast<unsigned long long>(row) >=
      static_cast<unsigned long long>(v_rows)) {
    __trap();
  }
  float acc = 0.0f;
  for (long long k = i; k < l && rows[k] == row; ++k) {
    const long long pos = order[k];
    const float g = __ldg(d_out + (pos / m) * e + col);
    const float w = mask ? (mask[pos] ? 1.0f : 0.0f) : 1.0f;
    acc = __fadd_rn(acc, __fmul_rn(g, w));
  }
  d_table[row * e + col] = acc;
}

}  // namespace

// table: [v, e] f32; idx, w: [l] i32 / f32, sorted by bag (stable);
// offsets: [n_bags + 1] i64, bag b's lookups are [offsets[b], offsets[b+1]);
// out: [n_bags, e] f32.  Launches on `stream`, sets *launched to the number
// of kernels launched (0 for an empty grid); returns cudaGetLastError().
extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    const float* w, const long long* offsets,
                                    float* out, long long n_bags, int e,
                                    void* stream, int* launched) {
  *launched = 0;
  const long long total = n_bags * e;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    embedding_bag_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, idx, w, offsets, out, n_bags, e);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// table: [v, e] f32; ids: [n_bags, m] i32; mask: [n_bags, m] bool, or null
// (every lookup weighs 1); bag n adds (n % fields) · field_rows to its ids.
// vec2: read rows as float2 (e even, table 8-byte aligned).
// out: [n_bags, e] f32.  Launches on `stream`, sets *launched to the number
// of kernels launched; returns cudaGetLastError().
extern "C" int embedding_bag_fixed_launch(const float* table, long long v,
                                          int e, const int* ids,
                                          const unsigned char* mask,
                                          long long n_bags, int m,
                                          int fields, long long field_rows,
                                          int vec2, float* out,
                                          void* stream, int* launched) {
  *launched = 0;
  if (n_bags > 0 && e > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec2) {
      launch_fixed_m<2>(table, v, e, ids, mask, n_bags, m, fields,
                        field_rows, out, st);
    } else {
      launch_fixed_m<1>(table, v, e, ids, mask, n_bags, m, fields,
                        field_rows, out, st);
    }
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of embedding_bag_fixed_launch with respect to the table.
// rows: [l] i64, the lookups' table rows (ids plus their field offsets),
// stable-sorted; order: [l] i64, position n·m + j of each sorted lookup;
// d_out: [n_bags, e] f32; mask: [n_bags, m] bool, or null (every lookup
// weighs 1); d_table: [v, e] f32, zero on entry.  Launches on `stream`, sets
// *launched to the number of kernels launched; returns cudaGetLastError().
extern "C" int embedding_bag_fixed_backward_launch(
    const long long* rows, const long long* order, const float* d_out,
    const unsigned char* mask, long long l, int m, int e, long long v,
    float* d_table, void* stream, int* launched) {
  *launched = 0;
  const long long total = l * e;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    embedding_bag_fixed_backward_kernel<<<
        static_cast<unsigned int>(blocks), kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(rows, order, d_out, mask, l, m,
                                            e, v, d_table);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}
