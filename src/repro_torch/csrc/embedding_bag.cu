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
// could differ in the last bits.  Instead the wrapper groups the lookups:
// one stable torch.sort of their rows as 32-bit keys puts the lookups of
// one row next to each other in lookup order, and torch.searchsorted gives
// each slab's first lookup.  One launch then writes the whole dense
// gradient, every byte once, with no zero fill before it
// (embedding_bag_bwd.cuh): [V, E] is cut into slabs of R rows (R·E floats
// <= 20 KB; R = 512 for E = 10), a CTA of 256 threads takes 2 consecutive
// slabs, zeroes a slab in shared memory, stages each chunk of 256 lookups
// as products rounded once (a thread's lookup of the next chunk -- its
// mask byte and d_out row, in registers for rows of up to 16 floats -- and
// the keys of the chunk after it load while a chunk folds), folds each run
// of equal rows in lookup order into the slab (one thread a column, adds
// rounded once), and stores the slab with one TMA bulk copy (it read
// faster than 16-byte stores).  No atomics: deterministic, bit for bit the
// CPU plain version.  A run of one row is still summed
// serially per column, a chunk after another: a slab holding a Zipf head
// costs its one CTA a round of loads and its longest segment per 256
// lookups.  A key outside [0, V) stops the kernel with __trap() (the
// sorted keys' first and last are checked).  Bound on this card: bytes,
// dominated by the dense [V, E] gradient written once; the kernel's own
// traffic is the sorted keys and positions (12 B a lookup), the mask byte
// and one d_out row read per lookup.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "embedding_bag_bwd.cuh"

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

// Zeroes floats [a, b) of the slab in shared memory (the 16-byte words
// that hold them).
__device__ __forceinline__ void zero_slab(float* slab, int a, int b) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = (a >> 2) + threadIdx.x; i < (b + 3) >> 2;
       i += ebb::kThreads) {
    reinterpret_cast<float4*>(slab)[i] = z;
  }
}

// The 16-byte words within floats [a, b): [a4, b4), a4 <= b4.
__device__ __forceinline__ void words(int a, int b, int& a4, int& b4) {
  a4 = (a + 3) & ~3;
  a4 = a4 < b ? a4 : b;
  b4 = b & ~3;
  b4 = b4 > a4 ? b4 : a4;
}

// Floats [a, b) of the slab in shared memory to the same floats of dst, the
// slab's place in the gradient (both 16-byte aligned): the 16-byte words by
// one TMA bulk copy (every thread's writes to the slab fenced for the async
// proxy first; thread 0 waits until the copy has read the slab), the ragged
// ends float by float.
__device__ __forceinline__ void store_slab(float* dst, const float* src,
                                           int a, int b) {
  int a4, b4;
  words(a, b, a4, b4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && b4 > a4) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(src + a4));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst + a4),
        "r"(s), "r"((b4 - a4) * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  for (int i = a + threadIdx.x; i < a4; i += ebb::kThreads) dst[i] = src[i];
  for (int i = b4 + threadIdx.x; i < b; i += ebb::kThreads) dst[i] = src[i];
}

// What every walk of a launch shares: its inputs and the CTA's shared
// memory (the slab [r·e], the staged terms [e][chunk], column-major, the
// chunk's rows within the slab [chunk], its segment starts [chunk + 1], a
// count per warp).
struct Walk {
  const int* keys;
  const long long* order;
  const float* d_out;
  const unsigned char* mask;
  int m, e, chunk;
  bool small;  // positions divide in 32 bits
  float* slab;
  float* stage;
  int* row;
  int* seg;
  int* warp_n;
};

// One CTA's walk over the sorted lookups [lo, hi) of a slab whose rows
// start at r0 and whose floats [fa, fb) it owns (every row of those
// floats, and only those, among the lookups' rows): zero them in shared
// memory, stage and fold the lookups a chunk at a time, store [fa, fb) to
// out, the slab's place in the gradient.  A thread
// holds its lookup of the next chunk (A) and the key of the chunk after it
// (B): while a chunk folds, A's mask byte and d_out row (EMAX > 0: rows of
// at most EMAX floats, in registers) and B's key and position load, so a
// chunk waits for one round of loads, not three.
template <int EMAX>
__device__ __forceinline__ void walk(const Walk& w, long long r0, int fa,
                                     int fb, long long lo, long long hi,
                                     float* out) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int e = w.e;
  const int chunk = w.chunk;
  zero_slab(w.slab, fa, fb);
  // chunk A [a_lo, a_end), staged next, and chunk B after it
  long long a_lo = lo;
  long long a_end = lo + chunk < hi ? lo + chunk : hi;
  bool a_has = a_lo + t < a_end;
  int a_key = 0;
  long long a_pos = 0;
  if (a_has) {
    a_key = w.keys[a_lo + t];
    a_pos = w.order[a_lo + t];
  }
  long long b_lo = a_end;
  long long b_end = b_lo + chunk < hi ? b_lo + chunk : hi;
  bool b_has = b_lo + t < b_end;
  int b_key = 0;
  long long b_pos = 0;
  if (b_has) {
    b_key = w.keys[b_lo + t];
    b_pos = w.order[b_lo + t];
  }
  float g[EMAX > 0 ? EMAX : 1];
  unsigned char a_w = 1;
  auto fetch = [&]() {  // A's mask byte and d_out row, into registers
    if (EMAX > 0 && a_has) {
      const long long bag =
          w.small ? static_cast<long long>(static_cast<unsigned>(a_pos) /
                                           static_cast<unsigned>(w.m))
                  : a_pos / w.m;
      const float* gp = w.d_out + bag * e;
#pragma unroll
      for (int c = 0; c < (EMAX > 0 ? EMAX : 1); ++c) {
        g[c] = c < e ? __ldg(gp + c) : 0.0f;
      }
      a_w = w.mask ? w.mask[a_pos] : 1;
    }
  };
  fetch();
  while (a_lo < hi) {
    // stage chunk A: its rows within the slab and its e terms
    const int cnt = static_cast<int>(a_end - a_lo);
    if (a_has) {
      w.row[t] = static_cast<int>(a_key - r0);
      if constexpr (EMAX > 0) {
        const float wt = a_w ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < EMAX; ++c) {
          if (c < e) w.stage[c * chunk + t] = ebb::term(g[c], wt);
        }
      } else {
        const float wt = ebb::weight(w.mask, a_pos);
        const float* gp = w.d_out + (a_pos / w.m) * e;
        for (int c = 0; c < e; ++c) {
          w.stage[c * chunk + t] = ebb::term(__ldg(gp + c), wt);
        }
      }
    }
    __syncthreads();
    // the chunk's segments (runs of one row), in order
    const bool opens = a_has && ebb::starts_segment(w.row, t);
    const unsigned bal = __ballot_sync(0xffffffffu, opens);
    if (lane == 0) w.warp_n[warp] = __popc(bal);
    __syncthreads();
    int before = 0;
    int segs = 0;
    for (int i = 0; i < ebb::kThreads / 32; ++i) {
      const int x = w.warp_n[i];
      before += i < warp ? x : 0;
      segs += x;
    }
    if (opens) w.seg[before + __popc(bal & ((1u << lane) - 1u))] = t;
    if (t == 0) w.seg[segs] = cnt;
    __syncthreads();
    // B becomes A: its terms load while this chunk folds, and so does the
    // key of the chunk after it
    a_lo = b_lo;
    a_end = b_end;
    a_has = b_has;
    a_key = b_key;
    a_pos = b_pos;
    fetch();
    b_lo = b_end;
    b_end = b_lo + chunk < hi ? b_lo + chunk : hi;
    b_has = b_lo + t < b_end;
    if (b_has) {
      b_key = w.keys[b_lo + t];
      b_pos = w.order[b_lo + t];
    }
    // one thread a (segment, column): the segment's terms in order
    for (int p = t; p < segs * e; p += ebb::kThreads) {
      const int sid = p / e;
      const int c = p - sid * e;
      const int a = w.seg[sid];
      ebb::fold(w.slab + w.row[a] * e + c, w.stage + c * chunk, a,
                w.seg[sid + 1]);
    }
    __syncthreads();
  }
  store_slab(out, w.slab, fa, fb);
  __syncthreads();  // the slab is read before it is zeroed again
}

// B3's backward (see the header comment and embedding_bag_bwd.cuh), slabs
// of r rows.  keys: [l] sorted rows; order: [l] positions n·m + j; starts:
// [slabs + 1] the first lookup of each slab; chunk:
// ebb::chunk_lookups(e).  CTAs [0, windows) take the windows of kWindow
// sorted lookups, each its rows of the heavy slabs it meets (first, so
// that the longest walks start early); CTA windows + b takes the slabs
// [T·b, T·b + T) (T = kSlabsPerTile) that are not heavy.  The grid has a
// window CTA for every kWindow lookups, heavy slabs or not: which slabs are
// heavy is known only on the card, and sizing the grid by them would cost
// the op a host sync; a window CTA that meets no heavy slab reads two keys
// and two starts and returns (192 of them at train_batch's 1.57M lookups).
template <int EMAX>
__global__ void __launch_bounds__(ebb::kThreads, 4)
    embedding_bag_fixed_backward_kernel(
        const int* __restrict__ keys, const long long* __restrict__ order,
        const long long* __restrict__ starts, const float* __restrict__ d_out,
        const unsigned char* __restrict__ mask, long long l, int m, int e,
        long long v, int r, int chunk, long long windows,
        float* __restrict__ d_table) {
  extern __shared__ __align__(16) float smem[];
  Walk w;
  w.keys = keys;
  w.order = order;
  w.d_out = d_out;
  w.mask = mask;
  w.m = m;
  w.e = e;
  w.chunk = chunk;
  w.small = l <= 0x7fffffffLL;
  w.slab = smem;
  w.stage = w.slab + r * e;
  w.row = reinterpret_cast<int*>(w.stage + chunk * e);
  w.seg = w.row + chunk;
  w.warp_n = w.seg + chunk + 1;
  __shared__ long long bounds[ebb::kSlabsPerTile + 1];
  const int t = threadIdx.x;
  const long long slabs = (v + r - 1) / r;
  if (blockIdx.x == 0 && t == 64 && l > 0 &&
      (keys[0] < 0 || keys[l - 1] >= v)) {
    __trap();  // a row outside [0, v): sorted, so the first or the last
  }
  if (blockIdx.x < windows) {
    const long long h = blockIdx.x;
    const long long first = h * ebb::kWindow;
    const long long last =
        (first + ebb::kWindow < l ? first + ebb::kWindow : l) - 1;
    for (int side = 0; side < 2; ++side) {
      // the slab of the window's first lookup, then of its last: a heavy
      // slab that meets the window holds one of them
      const int key = keys[side == 0 ? first : last];
      if (key < 0 || key >= v) __trap();
      const long long s = key / r;
      if (side == 1 && s == keys[first] / r) break;
      const long long lo_s = starts[s];
      const long long hi_s = starts[s + 1];
      if (hi_s - lo_s <= ebb::kWindow) continue;  // its tile writes it
      const long long r0 = s * r;
      const int rows = static_cast<int>(r0 + r < v ? r : v - r0);
      const long long h0 = lo_s / ebb::kWindow;
      const long long h1 = (hi_s - 1) / ebb::kWindow;
      const int ra = ebb::window_row(keys, h, h0, h1, r0, rows);
      const int rb = ebb::window_row(keys, h + 1, h0, h1, r0, rows);
      if (ra >= rb) continue;
      if (t <= 1) {
        bounds[t] = ebb::lower_bound(keys, lo_s, hi_s, r0 + (t ? rb : ra));
      }
      __syncthreads();
      const long long lo = bounds[0];
      const long long hi = bounds[1];
      __syncthreads();
      walk<EMAX>(w, r0, ra * e, rb * e, lo, hi, d_table + r0 * e);
    }
    return;
  }
  const long long s0 = (blockIdx.x - windows) * ebb::kSlabsPerTile;
  const int tile = static_cast<int>(
      s0 + ebb::kSlabsPerTile < slabs ? ebb::kSlabsPerTile : slabs - s0);
  if (t <= tile) bounds[t] = starts[s0 + t];
  __syncthreads();
  for (int i = 0; i < tile; ++i) {
    const long long lo = bounds[i];
    const long long hi = bounds[i + 1];
    if (hi - lo > ebb::kWindow) continue;  // heavy: the windows write it
    const long long r0 = (s0 + i) * r;
    const int n = static_cast<int>((r0 + r < v ? r : v - r0) * e);
    walk<EMAX>(w, r0, 0, n, lo, hi, d_table + r0 * e);
  }
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
// keys: [l] i32, the lookups' table rows (ids plus their field offsets),
// stable-sorted; order: [l] i64, position n·m + j of each sorted lookup;
// starts: [ceil(v / slab_rows) + 1] i64, the first sorted lookup of each
// slab (the lower bound of its first row in keys; the last entry l);
// d_out: [n_bags, e] f32; mask: [n_bags, m] bool, or null (every lookup
// weighs 1); d_table: [v, e] f32, 16-byte aligned, every float written
// (nothing need be in it on entry).  slab_rows: a multiple of 4 with
// slab_rows·e <= 10,240 (ebb::slab_rows(e) the most).  Launches on
// `stream`, sets *launched to the number of kernels launched (1 unless
// e = 0 or no rows and no lookups); returns cudaGetLastError(), or cudaErrorInvalidValue for a width (e > 256) or
// slab it does not take.
extern "C" int embedding_bag_fixed_backward_launch(
    const int* keys, const long long* order, const long long* starts,
    const float* d_out, const unsigned char* mask, long long l, int m, int e,
    long long v, int slab_rows, float* d_table, void* stream,
    int* launched) {
  *launched = 0;
  // nothing to write and nothing to check (lookups into no rows trap)
  if (e <= 0 || (v <= 0 && l <= 0)) {
    return static_cast<int>(cudaGetLastError());
  }
  const int r = slab_rows;
  const long long slabs = r > 0 ? (v + r - 1) / r : 0;
  const long long tiles =
      (slabs + ebb::kSlabsPerTile - 1) / ebb::kSlabsPerTile;
  if (e > ebb::kStageFloats / 32 || r <= 0 || r % 4 != 0 ||
      static_cast<long long>(r) * e > ebb::kSlabFloats || tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = ebb::chunk_lookups(e);
  const long long windows = (l + ebb::kWindow - 1) / ebb::kWindow;
  if (windows + tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(r) + chunk) * e +
      sizeof(int) * (2 * static_cast<size_t>(chunk) + 1 + ebb::kThreads / 32);
  // rows of up to 16 floats load a chunk ahead into registers
  void (*kernel)(const int*, const long long*, const long long*,
                 const float*, const unsigned char*, long long, int, int,
                 long long, int, int, long long, float*) =
      e <= 16 ? embedding_bag_fixed_backward_kernel<16>
              : embedding_bag_fixed_backward_kernel<0>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(windows + tiles), ebb::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(keys, order, starts, d_out,
                                                mask, l, m, e, v, r, chunk,
                                                windows, d_table);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
