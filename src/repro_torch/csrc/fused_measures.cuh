// Per-rank arithmetic of the fused measure pass, shared by the CUDA kernel
// (fused_measures.cu) and the host check (host_check.cpp, built with g++).
//
// A row is walked in rank order.  `Prefix` carries the inclusive prefix
// sums of the rank axis; `step` advances it by one rank, adds that rank's
// share of the row reductions to `Acc`, and records the prefix at the
// cutoff ranks into `Cut` slots; `finalize` turns slots, sums and the
// per-query scalars into the 64 output columns.  The kernel computes each
// thread's starting prefix with a block scan and then calls `step` for its
// own ranks; the host check calls it for every rank in turn.
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
#else
#include <math.h>
#define FM_HD inline
#endif

namespace fm {

constexpr int kOutWidth = 64;     // output columns (55 used)
constexpr int kScalarWidth = 16;  // per-query scalar block (12 used)
constexpr int kNumCutoffs = 9;    // 5 10 15 20 30 100 200 500 1000
constexpr int kNumSuccess = 3;    // 1 5 10
constexpr int kNumSlots = 11;     // ranks 1 5 10 15 20 30 100 200 500 1000, D

// 1-based rank recorded in slot c (the last slot is the row's end).
FM_HD int slot_rank(int c, int d) {
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
FM_HD int cutoff(int j) { return slot_rank(j + 1, 1 << 30); }

struct Prefix {
  float cum;  // relevant (binary) count
  float jn;   // judged non-relevant count
  float cj;   // judged count
  float dcg;  // DCG, linear gain
  float ap;   // sum of precision at each relevant rank
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

FM_HD float sdiv(float num, float den) {
  return den > 0.0f ? num / fmaxf(den, 1e-30f) : 0.0f;
}

FM_HD float binrel_of(float rel, float level) {
  return rel >= level ? 1.0f : 0.0f;
}

FM_HD float gain_of(float rel, float rank) {
  return fmaxf(rel, 0.0f) / log2f(rank + 1.0f);
}

FM_HD float rbp_weight(float rank) {
  // (1 - p) rounds in double first, as the JAX package's Python float does
  return static_cast<float>(1.0 - 0.8) * powf(0.8f, rank - 1.0f);
}

// The four quantities whose prefix sums the kernel scans before `step`.
FM_HD void scan_inputs(float rel, float judged, float rank, float level,
                       float out[4]) {
  const float b = binrel_of(rel, level);
  out[0] = b;
  out[1] = judged * (1.0f - b);
  out[2] = judged;
  out[3] = gain_of(rel, rank);
}

// Advance `pre` past the rank at 0-based position p.  With acc and cuts
// null only the prefix moves (the kernel's first walk, which sizes the AP
// sum before its scan).
FM_HD void step(float rel, float judged, int p, int d, float level,
                float n_rel, float n_nonrel, Prefix& pre, Acc* acc,
                Cut* cuts) {
  const float rank = static_cast<float>(p + 1);
  float x[4];
  scan_inputs(rel, judged, rank, level, x);
  const float b = x[0];
  pre.cum += b;
  pre.jn += x[1];
  pre.cj += x[2];
  pre.dcg += x[3];
  pre.ap += b * (pre.cum / rank);
  if (acc != nullptr) {
    const float nr_above = pre.jn - x[1];
    const float term =
        nr_above > 0.0f
            ? 1.0f - sdiv(fminf(nr_above, n_rel), fminf(n_rel, n_nonrel))
            : 1.0f;
    acc->bpref += term * b;
    acc->zeros += pre.cum == 0.0f ? 1.0f : 0.0f;
    acc->rel_at_r += rank <= n_rel ? b : 0.0f;
    acc->rbp += b * rbp_weight(rank);
  }
  if (cuts != nullptr) {
    for (int c = 0; c < kNumSlots; ++c) {
      if (p + 1 == slot_rank(c, d)) {
        cuts[c].cum = pre.cum;
        cuts[c].ap = pre.ap;
        cuts[c].dcg = pre.dcg;
        cuts[c].cj = pre.cj;
      }
    }
  }
}

// The 64 output columns of one row, in the order of
// repro_torch.kernels.fused_measures.COLUMNS (zeros after column 55).
FM_HD void finalize(const Cut* cuts, const Acc& acc, const float* scal,
                    float* out) {
  const float n_rel = scal[0];
  const Cut& all = cuts[kNumSlots - 1];
  out[0] = sdiv(all.ap, n_rel);
  out[1] = all.cum > 0.0f ? 1.0f / (1.0f + acc.zeros) : 0.0f;
  out[2] = sdiv(all.dcg, scal[2]);
  out[3] = sdiv(acc.bpref, n_rel);
  out[4] = all.cum;
  out[5] = sdiv(acc.rel_at_r, n_rel);
  for (int j = 0; j < kNumCutoffs; ++j) {
    const Cut& c = cuts[j + 1];
    const float inv_k = 1.0f / static_cast<float>(cutoff(j));
    out[6 + j] = c.cum * inv_k;
    out[15 + j] = sdiv(c.cum, n_rel);
    out[24 + j] = sdiv(c.dcg, scal[3 + j]);
    out[33 + j] = sdiv(c.ap, n_rel);
    out[45 + j] = c.cj * inv_k;
  }
  for (int s = 0; s < kNumSuccess; ++s) {
    out[42 + s] = cuts[s].cum > 0.0f ? 1.0f : 0.0f;
  }
  out[54] = acc.rbp;
  for (int c = 55; c < kOutWidth; ++c) out[c] = 0.0f;
}

}  // namespace fm
