// Bitonic compare-exchange network over packed (value, index) keys and the
// filtered top-k built on it, shared by the CUDA top-k kernel (topk.cu)
// and the host check (host_check.cpp, g++).
//
// Total order ("precedes"): a before b iff a.value > b.value, ties broken
// by the smaller index -- jax.lax.top_k's rule, and trec_eval's rule once
// documents sit at column == tiebreak rank.  Values compare with > and ==,
// so -0.0 and +0.0 tie and the index decides.  Every NaN, of either sign and
// any payload, follows every number (-inf included) and NaNs tie among
// themselves: the full sort's order (core/sorting.py::sort_key puts NaN
// after the -inf padding of the top-k layout).  The network sorts 64-bit
// keys whose unsigned order is that order (make_key): one compare and one
// 8-byte move per element instead of two.  The value's bits are read back
// from the scores by index, so -0.0 stays -0.0.  Lengths are powers of two.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define BT_HD __host__ __device__ __forceinline__
#else
#define BT_HD inline
#endif

namespace bt {

typedef unsigned long long Key;

BT_HD uint32_t float_bits(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(v);
#else
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  return u;
#endif
}

// High words: a number's is at least 0x007fffff (make_key's word for
// -inf); every NaN gets kNanHigh, below it; init_key's "no element yet"
// sentinels get kEmptyHigh, below NaN.
constexpr uint32_t kNanHigh = 1u;
constexpr uint32_t kEmptyHigh = 0u;

// (v, i) -> a key whose unsigned order is that order, for 0 <= i < 2^31:
// the high word orders floats (sign flipped for positives, every bit for
// negatives; -0.0 as +0.0; NaN as kNanHigh), the low word is
// 2^32 - 1 - i.  Key 0 follows every such key.
BT_HD Key make_key(float v, int i) {
  uint32_t u = v == 0.0f ? 0u : float_bits(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  u = v != v ? kNanHigh : u;
  return (static_cast<Key>(u) << 32) |
         (0xffffffffu - static_cast<uint32_t>(i));
}

BT_HD int key_index(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// Pair t of the stage at distance j inside bitonic segments of size k
// (both powers of two): elements lo and lo + j, the larger key first.
// Segments whose index bit k is set run in reverse, as in
// repro/kernels/bitonic.py::_stage.
BT_HD void stage_pair(Key* key, int j, int k, int t) {
  const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const int hi = lo + j;
  const Key a = key[lo], b = key[hi];
  const bool first_a = ((lo & k) != 0) != (a > b);
  key[lo] = first_a ? a : b;
  key[hi] = first_a ? b : a;
}

// Sort key[0, n), largest key first (n a power of two).  A Team runs the
// loops over pairs: see below.
template <class Team>
BT_HD void sort_desc(const Team& team, Key* key, int n) {
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = team.rank(); t < n / 2; t += team.size()) {
        stage_pair(key, j, kk, t);
      }
      team.sync_stage(j, j > 1 ? j >> 1 : kk);
    }
  }
}

// -- the filtered top-k --------------------------------------------------
//
// A block keeps the k largest keys seen so far (`kept`, in no order) and
// the smallest of them, the running k-th.  It stages only the keys that
// exceed the running k-th; when the staging buffer fills, and at the end,
// select_top keeps the k largest of kept ∪ staged.  Exact in any arrival
// order: the k-th only grows, so a key that does not exceed it can never
// reach the final top k.  Heavy ties, signed zeros and -inf follow from
// the key order.  Only the final k are sorted (sort_desc).
//
// A Team runs the loops: rank() and size() stride them, sync() separates
// steps that read each other's writes, sync_stage(j, next) two network
// stages at distances j and next; hist_add, find_bin, reserve and
// reduce_min are its collective steps (below).  topk.cu's Team is a thread
// block; host_check.cpp's is one thread that runs every loop in order, so
// the host runs these very functions.

// Entry p < k of `kept` before any element arrived: (kEmptyHigh, d + p),
// after every real element of a row of d, NaN included (d + k2 < 2^31), so
// any element is admitted while fewer than k have arrived.  Rows shorter
// than k come back with these: -inf values and indices >= d.  Key 0 pads
// the final sort.
BT_HD Key init_key(int d, int p) {
  return (static_cast<Key>(kEmptyHigh) << 32) |
         (0xffffffffu - static_cast<uint32_t>(d + p));
}

// Admission: `key` is a real element (index < d; candidates carried from a
// split pass may hold sentinels) that can still enter the top k.
BT_HD bool admit(Key key, Key kth, int d) {
  return key > kth && key_index(key) < d;
}

// Shared state of select_top's collective steps.
struct SelectScratch {
  unsigned hist[256];  // counts of one 8-bit digit
  Key kth;             // reduce_min's result
  int taken;           // reserve's counter
  int bin;             // find_bin's results
  int above;
  int in_bin;
};

// out[0, k) = the k largest of kept[0, k) ∪ staged[0, count) (all keys
// distinct; `out` aliases neither), in no order; returns the smallest of
// them.  A radix select from the top byte: each pass counts the 8-bit digit
// of the keys that share the prefix found so far and moves to the bin that
// holds the k-th largest; it stops once that bin's keys all belong to the
// top k, which happens by the last byte at the latest (keys are distinct).
// Then every key >= the prefix is kept.  A few passes over some 5,000 keys
// in place of a bitonic sort of them.
template <class Team>
BT_HD Key select_top(const Team& team, SelectScratch& sc, const Key* kept,
                     int k, const Key* staged, int count, Key* out) {
  const int n = k + count;
  Key prefix = 0;
  int need = k;  // keys still to take from the keys sharing `prefix`
  for (int shift = 56;; shift -= 8) {
    const Key high = shift == 56 ? 0 : ~((Key(1) << (shift + 8)) - 1);
    for (int b = team.rank(); b < 256; b += team.size()) sc.hist[b] = 0;
    team.sync();
    for (int p = team.rank(); p < n; p += team.size()) {
      const Key key = p < k ? kept[p] : staged[p - k];
      if ((key & high) == prefix) {
        team.hist_add(sc.hist, static_cast<int>((key >> shift) & 255));
      }
    }
    team.sync();
    team.find_bin(sc, need);  // ends with sync(): every rank reads sc
    need -= sc.above;
    prefix |= static_cast<Key>(sc.bin) << shift;
    if (sc.in_bin == need) break;  // that bin is all in: keys >= prefix
  }
  if (team.rank() == 0) {
    sc.taken = 0;
    sc.kth = ~Key(0);
  }
  team.sync();
  Key low = ~Key(0);
  for (int p = team.rank(); p < n; p += team.size()) {
    const Key key = p < k ? kept[p] : staged[p - k];
    const bool take = key >= prefix;
    const int at = team.reserve(sc, take);
    if (take) {
      out[at] = key;
      low = key < low ? key : low;
    }
  }
  return team.reduce_min(sc, low);  // ends with sync()
}

}  // namespace bt
