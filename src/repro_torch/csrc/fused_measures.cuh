// Per-rank arithmetic of the fused measure pass, shared by the CUDA kernel
// (fused_measures.cu) and the host check (host_check.cpp, built with g++).
//
// A row is cut into chunks of kChunk ranks; a warp takes a chunk at a
// time, kLaneRanks consecutive ranks a lane.  `rank_inputs` gives each
// rank its binary relevance and judged counts.  The lane's totals of those
// three are scanned across the warp (and the block's warps, for long
// rows); then `walk_lane` moves the prefix `Prefix` rank by rank through
// the lane's ranks, adds the DCG gain of each rank with a grade (from the
// rank-term table: `dcg_divisor`, `rbp_term`, what depends on the rank
// alone, built once per rank position) and each relevant rank's share of
// the row reductions to `Acc` (`walk_rank`; `lane_zeros` counts the ranks
// before the first relevant one), and copies the prefix into the cutoff
// slots whose rank the lane holds (`lane_slots`).  The DCG and AP
// prefixes are walked from 0 within the lane and offset once their own
// scans are known.  `column` turns the slots, sums and per-query scalars
// into one of the 64 output columns.
//
// Rounding follows the JAX package bit for bit on the count columns (P,
// recall, success, judged, num_rel_ret): a division by a per-query value is
// IEEE division (`sdiv`), never a multiply by a reciprocal, while a
// division by a static cutoff k is `x * (1.0f / k)`, because XLA rewrites
// `x / k` for a constant k into exactly that.  Build without
// --use_fast_math.
#pragma once

#ifdef __CUDACC__
#define FM_HD __host__ __device__ __forceinline__
#define FM_UNROLL _Pragma("unroll")
#else
#include <math.h>
#define FM_HD inline
#define FM_UNROLL
#endif

namespace fm {

constexpr int kOutWidth = 64;     // output columns (55 used)
constexpr int kScalarWidth = 16;  // per-query scalar block (12 used)
constexpr int kNumCutoffs = 9;    // 5 10 15 20 30 100 200 500 1000
constexpr int kNumSuccess = 3;    // 1 5 10
constexpr int kNumSlots = 11;     // ranks 1 5 10 15 20 30 100 200 500 1000, D

constexpr int kLaneRanks = 8;                // ranks of a lane in a chunk
constexpr int kChunk = 32 * kLaneRanks;      // ranks of a warp's chunk
constexpr int kShortMaxD = 2048;             // longest row a warp takes alone
constexpr int kSlotChunks = 999 / kChunk + 1;  // chunks holding ranks <= 1000

// 1-based rank recorded in slot c (the last slot is the row's end).
FM_HD constexpr int slot_rank(int c, int d) {
  int k = d;
  switch (c) {
    case 0: k = 1; break;
    case 1: k = 5; break;
    case 2: k = 10; break;
    case 3: k = 15; break;
    case 4: k = 20; break;
    case 5: k = 30; break;
    case 6: k = 100; break;
    case 7: k = 200; break;
    case 8: k = 500; break;
    case 9: k = 1000; break;
    default: break;
  }
  return k < d ? k : d;
}

// Standard cutoff j (0..8) lives in slot j + 1; success cutoff s (0..2)
// (ranks 1, 5, 10) in slot s.
FM_HD constexpr int cutoff(int j) { return slot_rank(j + 1, 1 << 30); }

// 0-based position of slot c's rank in a row longer than every cutoff.
FM_HD constexpr int slot_pos(int c) { return slot_rank(c, 1 << 30) - 1; }

// Slot c holds the row's totals when its rank is D or beyond (always for
// the last slot); the others are copied from the prefix at their rank.
FM_HD bool slot_is_total(int c, int d) { return slot_pos(c) + 1 >= d; }

// The constant slots (bits c < 10) whose rank lies in `lane`'s ranks of
// chunk `chunk` of a row of d.
FM_HD unsigned lane_slots(int chunk, int lane, int d) {
  unsigned m = 0;
  for (int c = 0; c < kNumSlots - 1; ++c) {
    const int pos = slot_pos(c);
    if (!slot_is_total(c, d) && pos / kChunk == chunk &&
        pos % kChunk / kLaneRanks == lane) {
      m |= 1u << c;
    }
  }
  return m;
}

struct Prefix {
  float cum;  // relevant (binary) count
  float jn;   // judged non-relevant count
  float cj;   // judged count
  float dcg;  // DCG, linear gain (within the lane, in walk_lane)
  float ap;   // sum of precision at each relevant rank (likewise)
};

struct Acc {
  float bpref;     // sum of bpref terms over relevant ranks
  float zeros;     // ranks before the first relevant one
  float rel_at_r;  // relevant docs within rank <= R
  float rbp;       // RBP(0.8) sum
};

struct Cut {
  float cum, ap, dcg, cj;
};

// What one rank adds to the three scanned prefixes, and its grade.
struct Rank {
  float b;    // binary relevance
  float jn;   // judged and not relevant
  float cj;   // judged
  float rel;  // grade (the DCG gain's numerator where > 0)
};

FM_HD float sdiv(float num, float den) {
  return den > 0.0f ? num / fmaxf(den, 1e-30f) : 0.0f;
}

FM_HD float binrel_of(float rel, float level) {
  return rel >= level ? 1.0f : 0.0f;
}

// The rank-term table's two entries for 0-based position p.
FM_HD float dcg_divisor(int p) {
  return log2f(static_cast<float>(p + 1) + 1.0f);
}

FM_HD float rbp_term(int p) {
  // (1 - p) rounds in double first, as the JAX package's Python float does
  return static_cast<float>(1.0 - 0.8) *
         powf(0.8f, static_cast<float>(p + 1) - 1.0f);
}

// A rank past D has rel = judged = 0.
FM_HD Rank rank_inputs(float rel, float judged, float level) {
  Rank x;
  x.b = binrel_of(rel, level);
  x.jn = judged * (1.0f - x.b);
  x.cj = judged;
  x.rel = rel;
  return x;
}

// Advance `pre` past one rank and add the rank's share of the reductions
// but `zeros` (walk_lane counts those); `divisor` and `rbp_w` are its
// table entries.  The gain fmaxf(rel, 0) / divisor is zero where rel <= 0,
// and a rank that is not relevant adds zero to AP, bpref, R-precision and
// RBP, so their divisions are skipped there; a relevant rank has rel >=
// level > 0, and b = 1, so each product by b is the term itself.
FM_HD void walk_rank(const Rank& x, float rank, float divisor, float rbp_w,
                     float n_rel, float bpref_den, Prefix& pre, Acc& acc) {
  pre.cum += x.b;
  pre.jn += x.jn;
  pre.cj += x.cj;
  if (x.rel > 0.0f) {
    pre.dcg += x.rel / divisor;
    if (x.b != 0.0f) {
      pre.ap += pre.cum / rank;
      const float nr_above = pre.jn - x.jn;
      const float frac = sdiv(fminf(nr_above, n_rel), bpref_den);
      acc.bpref += nr_above > 0.0f ? 1.0f - frac : 1.0f;
      acc.rel_at_r += rank <= n_rel ? 1.0f : 0.0f;
      acc.rbp += rbp_w;
    }
  }
}

// The ranks with no relevant one at or above them in the row (`zeros`):
// a lane's ranks before its first relevant one and before d, when no
// relevant rank precedes the lane (`start_cum` is the cum before it).
FM_HD void lane_zeros(const Rank* x, int p0, int d, float start_cum,
                      Acc& acc) {
  if (start_cum == 0.0f) {
    int first = kLaneRanks;
    FM_UNROLL
    for (int i = kLaneRanks - 1; i >= 0; --i) {
      if (x[i].b != 0.0f) first = i;
    }
    const int valid = d - p0 < first ? d - p0 : first;
    acc.zeros += static_cast<float>(valid > 0 ? valid : 0);
  }
}

// A lane's kLaneRanks ranks from 0-based position p0 of a row of d, with
// their table entries: walks each and copies the prefix into cuts[c] at
// the rank of each slot c in `slots` (its DCG and AP still lane-relative).
// For a lane with no graded rank (rel > 0) and no slot the walk adds only
// `zeros` and moves `pre` past values that are not read again, so a warp
// where every lane is such takes lane_zeros alone, with the same result.
FM_HD void walk_lane(const Rank* x, const float* divisor, const float* rbp_w,
                     int p0, int d, float n_rel, float bpref_den,
                     unsigned slots, Prefix& pre, Acc& acc, Cut* cuts) {
  const float rank0 = static_cast<float>(p0 + 1);
  lane_zeros(x, p0, d, pre.cum, acc);
  FM_UNROLL
  for (int i = 0; i < kLaneRanks; ++i) {
    walk_rank(x[i], rank0 + static_cast<float>(i), divisor[i], rbp_w[i],
              n_rel, bpref_den, pre, acc);
    FM_UNROLL
    for (int c = 0; c < kNumSlots - 1; ++c) {
      if (slot_pos(c) % kLaneRanks == i && ((slots >> c) & 1u)) {
        cuts[c].cum = pre.cum;
        cuts[c].ap = pre.ap;
        cuts[c].dcg = pre.dcg;
        cuts[c].cj = pre.cj;
      }
    }
  }
}

// Column c of a row, in the order of
// repro_torch.kernels.fused_measures.COLUMNS (zero from column 55 on).
FM_HD float column(int c, const Cut* cuts, const Acc& acc,
                   const float* scal) {
  const float n_rel = scal[0];
  const Cut& all = cuts[kNumSlots - 1];
  switch (c) {
    case 0: return sdiv(all.ap, n_rel);
    case 1: return all.cum > 0.0f ? 1.0f / (1.0f + acc.zeros) : 0.0f;
    case 2: return sdiv(all.dcg, scal[2]);
    case 3: return sdiv(acc.bpref, n_rel);
    case 4: return all.cum;
    case 5: return sdiv(acc.rel_at_r, n_rel);
    case 54: return acc.rbp;
    default: break;
  }
  if (c < 6 + 4 * kNumCutoffs) {
    const int j = (c - 6) % kNumCutoffs;
    const Cut& s = cuts[j + 1];
    switch ((c - 6) / kNumCutoffs) {
      case 0: return s.cum * (1.0f / static_cast<float>(cutoff(j)));
      case 1: return sdiv(s.cum, n_rel);
      case 2: return sdiv(s.dcg, scal[3 + j]);
      default: return sdiv(s.ap, n_rel);
    }
  }
  if (c < 42 + kNumSuccess) return cuts[c - 42].cum > 0.0f ? 1.0f : 0.0f;
  if (c < 45 + kNumCutoffs) {
    const int j = c - 45;
    return cuts[j + 1].cj * (1.0f / static_cast<float>(cutoff(j)));
  }
  return 0.0f;
}

}  // namespace fm
