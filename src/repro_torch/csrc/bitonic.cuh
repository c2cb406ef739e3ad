// Bitonic compare-exchange network over (value, index) pairs, shared by the
// CUDA top-k kernel (topk.cu) and the host check (host_check.cpp, g++).
//
// Total order ("precedes"): a before b iff a.value > b.value, ties broken
// by the smaller index -- jax.lax.top_k's rule, and trec_eval's rule once
// documents sit at column == tiebreak rank.  Values compare with > and ==,
// so -0.0 and +0.0 tie and the index decides.  Lengths are powers of two.
#pragma once

#ifdef __CUDACC__
#define BT_HD __host__ __device__ __forceinline__
#else
#define BT_HD inline
#endif

namespace bt {

BT_HD bool precedes(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Pair t of the stage at distance j inside bitonic segments of size k
// (both powers of two): elements lo and lo + j.  Segments whose index bit
// k is set run in reverse, as in repro/kernels/bitonic.py::_stage.
BT_HD void stage_pair(float* v, int* idx, int j, int k, int t) {
  const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const int hi = lo + j;
  const bool reverse = (lo & k) != 0;
  const float lv = v[lo], hv = v[hi];
  const int li = idx[lo], hi_i = idx[hi];
  const bool swap = reverse ? precedes(lv, li, hv, hi_i)
                            : precedes(hv, hi_i, lv, li);
  if (swap) {
    v[lo] = hv;
    v[hi] = lv;
    idx[lo] = hi_i;
    idx[hi] = li;
  }
}

// First stage of the merge of the running top-k2 `run` with a sorted tile
// whose top k2 is `tile[0, k2)`: run ++ reverse(tile top) is bitonic, and
// its half-cleaner leaves the k2 winners in the lower half.  Pair t.
BT_HD void keep_first(float* run_v, int* run_i, const float* tile_v,
                      const int* tile_i, int k2, int t) {
  const float tv = tile_v[k2 - 1 - t];
  const int ti = tile_i[k2 - 1 - t];
  if (precedes(tv, ti, run_v[t], run_i[t])) {
    run_v[t] = tv;
    run_i[t] = ti;
  }
}

}  // namespace bt
