// Per-slab arithmetic of B3's backward (the table's gradient of the
// fixed-length EmbeddingBag), shared by the CUDA kernel (embedding_bag.cu)
// and the host check (host_check.cpp, built with g++).
//
// The [V, E] gradient is cut into slabs of R consecutive rows, R·E floats
// at most kSlabFloats (20 KB), R a multiple of 4 so that every slab starts
// on 16 bytes.  The lookups come sorted by row (stable: the lookups of one
// row in lookup order), with each slab's first lookup, the `lower_bound`
// of its first row (the wrapper's torch.searchsorted).  A CTA takes
// kSlabsPerTile consecutive slabs and walks each one's lookups in chunks
// of `chunk_lookups(E)`, a lookup a thread; a slab without lookups is
// zeros, and a heavy slab is left to the windows (`window_row`).  Each
// lookup's E terms, d_out[pos / m] times its weight (`term`), are staged
// in shared memory; each run of equal rows within the chunk (a segment) is
// then folded in order into that row of the slab (`fold`), which holds the
// sums carried from the earlier chunks.  The slab starts at zero, so an
// untouched row is written as 0 and a touched one as ((0 + x1) + x2) +
// ..., in lookup order: the plain version's sum, one rounded operation at
// a time.
#pragma once

#ifdef __CUDACC__
#define EBB_HD __host__ __device__ __forceinline__
#else
#define EBB_HD inline
#endif

namespace ebb {

constexpr int kThreads = 256;       // a CTA's threads
constexpr int kSlabFloats = 5120;   // a slab's floats at most (20 KB)
constexpr int kStageFloats = 8192;  // a chunk's staged terms at most (32 KB)
constexpr int kSlabsPerTile = 2;    // consecutive slabs of one CTA
constexpr int kWindow = 8192;       // lookups of a window (heavy slabs)

// Rows of a slab of width e: as many as kSlabFloats holds, a multiple of
// 4; 0 when e > kSlabFloats / 4.
EBB_HD int slab_rows(int e) { return e > 0 ? (kSlabFloats / e) & ~3 : 0; }

// Lookups of a chunk: as many as the stage holds, one a thread at most, a
// multiple of 32, at least 32 (e <= kStageFloats / 32 keeps that in the
// stage).
EBB_HD int chunk_lookups(int e) {
  int c = kStageFloats / e;
  c = c < kThreads ? c : kThreads;
  c &= ~31;
  return c < 32 ? 32 : c;
}

// First i in [lo, hi) with keys[i] >= value, else hi (keys ascending).
EBB_HD long long lower_bound(const int* keys, long long lo, long long hi,
                             long long value) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (keys[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Lookup pos's weight: 1 without a mask, else its mask entry as 1 / 0.
EBB_HD float weight(const unsigned char* mask, long long pos) {
  return mask ? (mask[pos] ? 1.0f : 0.0f) : 1.0f;
}

// One term, g · w rounded once (a masked-out lookup still multiplies: a
// non-finite g times 0 is NaN, as in the reference).
EBB_HD float term(float g, float w) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(g, w);
#else
  return g * w;
#endif
}

// Fold one column of a segment's staged terms [a, b), in order, into its
// cell of the slab: acc = *cell; acc = acc + terms[q]; *cell = acc.  The
// stage is column-major (column c of a chunk's lookups at c · chunk), so
// a column's terms lie next to each other.
EBB_HD void fold(float* cell, const float* terms, int a, int b) {
  float acc = *cell;
#ifdef __CUDACC__
#pragma unroll 8
#endif
  for (int q = a; q < b; ++q) {
#ifdef __CUDA_ARCH__
    acc = __fadd_rn(acc, terms[q]);
#else
    acc = acc + terms[q];
#endif
  }
  *cell = acc;
}

// A slab with more than kWindow lookups (a heavy one) is split by rows
// among the windows of kWindow sorted lookups that meet it, [h0, h1]: a
// window owns the runs that start in it, so window h owns the slab's rows
// [window_row(h), window_row(h + 1)) and walks their lookups.  The first
// window owns the slab from row 0, the last up to its end; a window
// inside a run (the run started in an earlier window) may own none.
// keys: the sorted rows; r0: the slab's first row; n_rows: its rows.
EBB_HD int window_row(const int* keys, long long h, long long h0,
                      long long h1, long long r0, int n_rows) {
  if (h <= h0) return 0;
  if (h > h1) return n_rows;
  const long long x = h * kWindow;
  return static_cast<int>(keys[x] - r0) + (keys[x - 1] == keys[x] ? 1 : 0);
}

// Whether lookup j of a chunk starts a segment (row: the chunk's rows).
EBB_HD bool starts_segment(const int* row, int j) {
  return j == 0 || row[j] != row[j - 1];
}

}  // namespace ebb
