// Host check of the kernels' per-row arithmetic.  Runs the functions the
// CUDA kernels share through fused_measures.cuh and bitonic.cuh, rank by
// rank and stage by stage, on the CPU; tests/test_torch_host_check.py
// builds it with g++ and holds it against the plain PyTorch versions.
//
//   host_check fused Q D LEVEL  < rel, judged [Q,D], scalars [Q,16] (f32)
//                               > out [Q,64] f32
//   host_check topk Q D K       < scores [Q,D] f32
//                               > values [Q,K] f32, indices [Q,K] i32
//   host_check topk_split Q D K S STAGE   (the same streams)
//
// topk is the top-k kernel's one-pass launch; topk_split cuts each row
// into S chunks (pass 1) and merges their top k (pass 2), with a staging
// buffer of STAGE entries (the kernel's is 4,096).
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

#include "bitonic.cuh"
#include "fused_measures.cuh"

namespace {

void fused_row(const float* rel, const float* judged, const float* scal,
               float* out, int d, float level) {
  fm::Prefix pre = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  fm::Acc acc = {0.0f, 0.0f, 0.0f, 0.0f};
  fm::Cut cuts[fm::kNumSlots] = {};
  for (int p = 0; p < d; ++p) {
    fm::step(rel[p], judged[p], p, d, level, scal[0], scal[1], pre, &acc,
             cuts);
  }
  fm::finalize(cuts, acc, scal, out);
}

int next_pow2(int n, int minimum) {
  int b = minimum;
  while (b < n) b *= 2;
  return b;
}

// bitonic.cuh's Team as one thread: every loop in order, no barriers.
struct HostTeam {
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  void sync_stage(int, int) const {}
  void hist_add(unsigned* hist, int bin) const { ++hist[bin]; }
  void find_bin(bt::SelectScratch& sc, int need) const {
    int above = 0;
    for (int b = 255; b >= 0; --b) {
      const int in_bin = static_cast<int>(sc.hist[b]);
      if (above + in_bin >= need) {
        sc.bin = b;
        sc.above = above;
        sc.in_bin = in_bin;
        return;
      }
      above += in_bin;
    }
  }
  int reserve(bt::SelectScratch& sc, bool take) const {
    const int at = sc.taken;
    sc.taken += take ? 1 : 0;
    return at;
  }
  bt::Key reduce_min(bt::SelectScratch& sc, bt::Key v) const {
    if (v < sc.kth) sc.kth = v;
    return sc.kth;
  }
};

// One block of topk.cu's filtered top-k, one key at a time: positions
// [lo, hi) of a row of scores `v` (or of keys `c`, pass 2) in tiles of
// stage / 2, each tested against the k-th key as it stood before the tile;
// select_top when the staging buffer could not take another tile and at
// the end.  Writes the top-k keys to `out`, sorted when `sorted`.
void topk_block(const float* v, const bt::Key* c, long long lo, long long hi,
                int d, int k, int stage, bool sorted, bt::Key* out) {
  const int k2 = next_pow2(k, 128);
  const int tile = stage / 2;
  const HostTeam team;
  bt::SelectScratch sc;
  std::vector<bt::Key> kept(k2), spare(k2), staged(stage);
  for (int p = 0; p < k; ++p) kept[p] = bt::init_key(d, p);
  bt::Key kth = bt::init_key(d, k - 1);
  int count = 0;
  for (long long t0 = lo; t0 < hi; t0 += tile) {
    const long long t1 = t0 + tile < hi ? t0 + tile : hi;
    for (long long p = t0; p < t1; ++p) {
      const bt::Key key = c ? c[p] : bt::make_key(v[p], static_cast<int>(p));
      if (bt::admit(key, kth, d)) staged[count++] = key;
    }
    if (count > stage - tile) {
      kth = bt::select_top(team, sc, kept.data(), k, staged.data(), count,
                           spare.data());
      kept.swap(spare);
      count = 0;
    }
  }
  if (count > 0) {
    bt::select_top(team, sc, kept.data(), k, staged.data(), count,
                   spare.data());
    kept.swap(spare);
  }
  if (sorted) {
    for (int p = k; p < k2; ++p) kept[p] = 0;
    bt::sort_desc(team, kept.data(), k2);
  }
  for (int p = 0; p < k; ++p) out[p] = kept[p];
}

// topk.cu's two passes for one row of d: `splits` blocks over chunks of
// ceil(d / splits) columns (the last ones may be short or empty), each
// writing its top-k keys in no order, then one block over the splits·k
// candidates;
// the values are read back from the row by column.
void topk_split_row(const float* s, float* out_v, int* out_i, int d, int k,
                    int splits, int stage) {
  std::vector<bt::Key> top(k);
  if (splits <= 1) {
    topk_block(s, nullptr, 0, d, d, k, stage, true, top.data());
  } else {
    const long long chunk =
        (static_cast<long long>(d) + splits - 1) / splits;
    const long long n = static_cast<long long>(splits) * k;
    std::vector<bt::Key> cand(n);
    for (int b = 0; b < splits; ++b) {
      const long long lo = b * chunk;
      const long long hi = lo + chunk < d ? lo + chunk : d;
      topk_block(s, nullptr, lo, hi, d, k, stage, false, &cand[b * k]);
    }
    topk_block(nullptr, cand.data(), 0, n, d, k, stage, true, top.data());
  }
  for (int p = 0; p < k; ++p) {
    out_i[p] = bt::key_index(top[p]);
    out_v[p] = out_i[p] < d ? s[out_i[p]] : -INFINITY;
  }
}

template <typename T>
void read_all(std::vector<T>& buf) {
  if (fread(buf.data(), sizeof(T), buf.size(), stdin) != buf.size()) {
    fprintf(stderr, "host_check: short input\n");
    exit(2);
  }
}

template <typename T>
void write_all(const std::vector<T>& buf) {
  fwrite(buf.data(), sizeof(T), buf.size(), stdout);
}

}  // namespace

int main(int argc, char** argv) {
  const bool split = argc == 7 && strcmp(argv[1], "topk_split") == 0;
  if (argc != 5 && !split) {
    fprintf(stderr,
            "usage: host_check fused|topk Q D LEVEL|K\n"
            "       host_check topk_split Q D K S STAGE\n");
    return 2;
  }
  const int q = atoi(argv[2]);
  const int d = atoi(argv[3]);
  const size_t n = static_cast<size_t>(q) * d;
  if (strcmp(argv[1], "fused") == 0) {
    const float level = static_cast<float>(atof(argv[4]));
    std::vector<float> rel(n), judged(n), scal(q * fm::kScalarWidth);
    std::vector<float> out(q * fm::kOutWidth);
    read_all(rel);
    read_all(judged);
    read_all(scal);
    for (int r = 0; r < q; ++r) {
      fused_row(&rel[r * d], &judged[r * d], &scal[r * fm::kScalarWidth],
                &out[r * fm::kOutWidth], d, level);
    }
    write_all(out);
    return 0;
  }
  if (split || strcmp(argv[1], "topk") == 0) {
    // topk: the kernel's one-pass launch (one block per row, 4,096 staging
    // entries); topk_split: S chunks a row and a STAGE-entry buffer
    const int k = atoi(argv[4]);
    const int splits = split ? atoi(argv[5]) : 1;
    const int stage = split ? atoi(argv[6]) : 4096;
    if (k < 1 || stage < 2) {
      fprintf(stderr, "host_check: need K >= 1 and STAGE >= 2\n");
      return 2;
    }
    std::vector<float> scores(n), out_v(static_cast<size_t>(q) * k);
    std::vector<int> out_i(static_cast<size_t>(q) * k);
    read_all(scores);
    for (int r = 0; r < q; ++r) {
      topk_split_row(&scores[static_cast<size_t>(r) * d],
                     &out_v[static_cast<size_t>(r) * k],
                     &out_i[static_cast<size_t>(r) * k], d, k, splits, stage);
    }
    write_all(out_v);
    write_all(out_i);
    return 0;
  }
  fprintf(stderr, "host_check: unknown mode %s\n", argv[1]);
  return 2;
}
