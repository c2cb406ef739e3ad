// Host check of the kernels' per-row arithmetic.  Runs the functions the
// CUDA kernels share through fused_measures.cuh, bitonic.cuh and
// embedding_bag_bwd.cuh, rank by rank, stage by stage and slab by slab, on
// the CPU; tests/test_torch_host_check.py
// builds it with g++ and holds it against the plain PyTorch versions.
//
//   host_check fused Q D LEVEL  < rel, judged [Q,D], scalars [Q,16] (f32)
//                               > out [Q,64] f32
//   host_check topk Q D K       < scores [Q,D] f32
//                               > values [Q,K] f32, indices [Q,K] i32
//   host_check topk_split Q D K S STAGE   (the same streams)
//   host_check keys N           < scores [N] f32
//                               > make_key(score i, i) [N], then
//                                 init_key(N, 0) (u64)
//   host_check bag_bwd N M E FIELDS FIELD_ROWS R
//                               < ids [N,M] i32, mask [N,M] u8,
//                                 d_out [N,E] f32
//                               > d_table [FIELDS·FIELD_ROWS, E] f32
//                                 (exit 3 for a row out of range: the
//                                 kernel's trap; 4 for a row not
//                                 written exactly once)
//
// topk is the top-k kernel's one-pass launch; topk_split cuts each row
// into S chunks (pass 1) and merges their top k (pass 2), with a staging
// buffer of STAGE entries (the kernel's is 4,096).  bag_bwd is B3's
// backward (embedding_bag_bwd.cuh) with slabs of R rows: the wrapper's
// grouping (a stable sort of the rows, ids plus (n % FIELDS)·FIELD_ROWS),
// then each CTA's tile of slabs, chunk by chunk and segment by segment.
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "bitonic.cuh"
#include "embedding_bag_bwd.cuh"
#include "fused_measures.cuh"

namespace {

// fused_measures.cu's rows, lane by lane: each lane's registers are a row
// of these arrays, each shuffle a loop over them in the order it adds.
constexpr int kL = fm::kLaneRanks;
constexpr int kWarps = 4;  // the long-row block's warps
constexpr int kTile = kWarps * fm::kChunk;

struct Scan {
  float excl[32];
  float total;
};

// Hillis-Steele scan over n lanes (warp_incl / block_scan).
void scan_lanes(const float* v, int n, Scan& s) {
  float incl[32];
  for (int l = 0; l < n; ++l) incl[l] = v[l];
  for (int off = 1; off < n; off <<= 1) {
    for (int l = n - 1; l >= off; --l) incl[l] += incl[l - off];
  }
  for (int l = 0; l < n; ++l) s.excl[l] = l > 0 ? incl[l - 1] : 0.0f;
  s.total = incl[n - 1];
}

// warp_sum: the xor butterfly (every lane ends with lane 0's sum).
float butterfly(const float* v) {
  float x[32], y[32];
  for (int l = 0; l < 32; ++l) x[l] = v[l];
  for (int off = 16; off > 0; off >>= 1) {
    for (int l = 0; l < 32; ++l) y[l] = x[l] + x[l ^ off];
    for (int l = 0; l < 32; ++l) x[l] = y[l];
  }
  return x[0];
}

// One warp's chunk: the lanes' rank inputs, table terms and scanned totals.
struct Chunk {
  fm::Rank x[32][kL];
  float div[32][kL];
  float w[32][kL];
  Scan s[3];
  fm::Prefix pre[32];
  unsigned slots[32];
  Scan dcg, ap;
};

void chunk_inputs(const float* rel, const float* judged, const float* tdiv,
                  const float* tw, int chunk, int d, float level, Chunk& c) {
  float t[3][32];
  for (int l = 0; l < 32; ++l) {
    const int p0 = chunk * fm::kChunk + l * kL;
    for (int k = 0; k < 3; ++k) t[k][l] = 0.0f;
    for (int i = 0; i < kL; ++i) {
      const int p = p0 + i;
      const bool in = p < d;
      c.x[l][i] = fm::rank_inputs(in ? rel[p] : 0.0f, in ? judged[p] : 0.0f,
                                  level);
      c.div[l][i] = in ? tdiv[p] : 1.0f;
      c.w[l][i] = in ? tw[p] : 0.0f;
      t[0][l] += c.x[l][i].b;
      t[1][l] += c.x[l][i].jn;
      t[2][l] += c.x[l][i].cj;
    }
    c.slots[l] = chunk < fm::kSlotChunks ? fm::lane_slots(chunk, l, d) : 0u;
  }
  for (int k = 0; k < 3; ++k) scan_lanes(t[k], 32, c.s[k]);
}

// Walk every lane from its prefix, then scan the lanes' DCG and AP sums
// (the kernels' shortcut for a warp with no graded rank and no slot, which
// gives the same result, is not taken).
void chunk_walk(Chunk& c, int chunk, int d, float n_rel, float bden,
                fm::Acc* acc, fm::Cut* cuts) {
  float dcg[32], ap[32];
  for (int l = 0; l < 32; ++l) {
    fm::walk_lane(c.x[l], c.div[l], c.w[l], chunk * fm::kChunk + l * kL, d,
                  n_rel, bden, c.slots[l], c.pre[l], acc[l], cuts);
    dcg[l] = c.pre[l].dcg;
    ap[l] = c.pre[l].ap;
  }
  scan_lanes(dcg, 32, c.dcg);
  scan_lanes(ap, 32, c.ap);
}

// The slots' DCG and AP: the sum before the chunk, the lanes' before the
// slot's lane, then the lane's through the slot.
void chunk_fix(const Chunk& c, float dcg_before, float ap_before,
               fm::Cut* cuts) {
  for (int l = 0; l < 32; ++l) {
    const float dcg_base = dcg_before + c.dcg.excl[l];
    const float ap_base = ap_before + c.ap.excl[l];
    for (int k = 0; k < fm::kNumSlots - 1; ++k) {
      if ((c.slots[l] >> k) & 1u) {
        cuts[k].dcg = dcg_base + cuts[k].dcg;
        cuts[k].ap = ap_base + cuts[k].ap;
      }
    }
  }
}

// A warp's lanes' reductions, each summed by the butterfly.
fm::Acc warp_acc(const fm::Acc* lanes) {
  float v[4][32];
  for (int l = 0; l < 32; ++l) {
    v[0][l] = lanes[l].bpref;
    v[1][l] = lanes[l].zeros;
    v[2][l] = lanes[l].rel_at_r;
    v[3][l] = lanes[l].rbp;
  }
  return {butterfly(v[0]), butterfly(v[1]), butterfly(v[2]),
          butterfly(v[3])};
}

// The 64 columns, two a lane.
void epilogue(fm::Cut* cuts, const fm::Cut& all, const fm::Acc& acc,
              const float* scal, float* out, int d) {
  for (int k = 0; k < fm::kNumSlots; ++k) {
    if (fm::slot_is_total(k, d)) cuts[k] = all;
  }
  for (int l = 0; l < 32; ++l) {
    out[l] = fm::column(l, cuts, acc, scal);
    out[l + 32] = fm::column(l + 32, cuts, acc, scal);
  }
}

// A short row (d <= kShortMaxD): one warp walks its chunks in order.
void fused_short_row(const float* rel, const float* judged, const float* scal,
                     const float* tdiv, const float* tw, float* out, int d,
                     float level) {
  const float n_rel = scal[0];
  const float bden = fminf(n_rel, scal[1]);
  float carry[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // cum jn cj dcg ap
  fm::Acc acc[32] = {};
  fm::Cut cuts[fm::kNumSlots] = {};
  std::vector<Chunk> cv(1);
  Chunk& c = cv[0];
  for (int chunk = 0; chunk * fm::kChunk < d; ++chunk) {
    chunk_inputs(rel, judged, tdiv, tw, chunk, d, level, c);
    for (int l = 0; l < 32; ++l) {
      c.pre[l] = {carry[0] + c.s[0].excl[l], carry[1] + c.s[1].excl[l],
                  carry[2] + c.s[2].excl[l], 0.0f, 0.0f};
    }
    chunk_walk(c, chunk, d, n_rel, bden, acc, cuts);
    chunk_fix(c, carry[3], carry[4], cuts);
    for (int k = 0; k < 3; ++k) carry[k] += c.s[k].total;
    carry[3] += c.dcg.total;
    carry[4] += c.ap.total;
  }
  const fm::Cut all = {carry[0], carry[4], carry[3], carry[2]};
  epilogue(cuts, all, warp_acc(acc), scal, out, d);
}

// A long row: a block of kWarps warps, tile by tile, warp w on the tile's
// chunk w; warp totals exchanged (the scanned three, then DCG and AP); the
// lanes' reductions summed per warp, then over the warps in order.
void fused_long_row(const float* rel, const float* judged, const float* scal,
                    const float* tdiv, const float* tw, float* out, int d,
                    float level) {
  const float n_rel = scal[0];
  const float bden = fminf(n_rel, scal[1]);
  float carry[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // cum jn cj dcg ap
  std::vector<fm::Acc> acc(kWarps * 32, fm::Acc{0.0f, 0.0f, 0.0f, 0.0f});
  fm::Cut cuts[fm::kNumSlots] = {};
  std::vector<Chunk> cs(kWarps);
  for (int tile = 0; tile * kTile < d; ++tile) {
    Scan b[3];
    for (int w = 0; w < kWarps; ++w) {
      chunk_inputs(rel, judged, tdiv, tw, tile * kWarps + w, d, level, cs[w]);
    }
    for (int k = 0; k < 3; ++k) {
      float tot[kWarps];
      for (int w = 0; w < kWarps; ++w) tot[w] = cs[w].s[k].total;
      scan_lanes(tot, kWarps, b[k]);
    }
    float tot_dcg[kWarps], tot_ap[kWarps];
    for (int w = 0; w < kWarps; ++w) {
      Chunk& c = cs[w];
      for (int l = 0; l < 32; ++l) {
        float p[3];
        for (int k = 0; k < 3; ++k) {
          p[k] = (carry[k] + b[k].excl[w]) + c.s[k].excl[l];
        }
        c.pre[l] = {p[0], p[1], p[2], 0.0f, 0.0f};
      }
      chunk_walk(c, tile * kWarps + w, d, n_rel, bden, &acc[w * 32], cuts);
      tot_dcg[w] = c.dcg.total;
      tot_ap[w] = c.ap.total;
    }
    Scan bd, ba;
    scan_lanes(tot_dcg, kWarps, bd);
    scan_lanes(tot_ap, kWarps, ba);
    for (int w = 0; w < kWarps; ++w) {
      chunk_fix(cs[w], carry[3] + bd.excl[w], carry[4] + ba.excl[w], cuts);
    }
    for (int k = 0; k < 3; ++k) carry[k] += b[k].total;
    carry[3] += bd.total;
    carry[4] += ba.total;
  }
  // per warp: the butterfly; then warp 0 adds the warps' sums in order
  fm::Acc sum = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int w = 0; w < kWarps; ++w) {
    const fm::Acc a = warp_acc(&acc[w * 32]);
    sum.bpref += a.bpref;
    sum.zeros += a.zeros;
    sum.rel_at_r += a.rel_at_r;
    sum.rbp += a.rbp;
  }
  const fm::Cut all = {carry[0], carry[4], carry[3], carry[2]};
  epilogue(cuts, all, sum, scal, out, d);
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

// One walk of embedding_bag.cu's backward: the sorted lookups [lo, hi) of
// the slab whose rows start at r0, the slab's rows [ra, rb) stored.
struct BagBwd {
  const std::vector<int>& sorted;
  const std::vector<long long>& order;
  const std::vector<unsigned char>& mask;
  const std::vector<float>& d_out;
  int m, e, chunk;
  std::vector<float> slab, stage;
  std::vector<int> row, seg, writes;

  void walk(long long r0, int ra, int rb, long long lo, long long hi,
            float* d_table) {
    std::fill(slab.begin(), slab.end(), 0.0f);
    while (lo < hi) {
      const int cnt = static_cast<int>(std::min<long long>(chunk, hi - lo));
      for (int j = 0; j < cnt; ++j) {
        const long long pos = order[lo + j];
        row[j] = static_cast<int>(sorted[lo + j] - r0);
        const float w = ebb::weight(mask.data(), pos);
        for (int c = 0; c < e; ++c) {
          stage[c * chunk + j] = ebb::term(d_out[(pos / m) * e + c], w);
        }
      }
      int segs = 0;
      for (int j = 0; j < cnt; ++j) {
        if (ebb::starts_segment(row.data(), j)) seg[segs++] = j;
      }
      seg[segs] = cnt;
      for (int sid = 0; sid < segs; ++sid) {
        for (int c = 0; c < e; ++c) {
          ebb::fold(&slab[static_cast<size_t>(row[seg[sid]]) * e + c],
                    &stage[c * chunk], seg[sid], seg[sid + 1]);
        }
      }
      lo += cnt;
    }
    std::copy(slab.begin() + ra * e, slab.begin() + rb * e,
              d_table + (r0 + ra) * e);
    for (int x = ra; x < rb; ++x) ++writes[r0 + x];
  }
};

// embedding_bag.cu's backward: the wrapper's grouping, then every slab
// that is not heavy, then every window's rows of the heavy slabs it meets.
// Returns 3 for a row out of range, 4 unless every row is written once.
int bag_bwd(const std::vector<int>& ids,
            const std::vector<unsigned char>& mask,
            const std::vector<float>& d_out, int n, int m, int e, int fields,
            long long field_rows, int r, float* d_table) {
  const long long l = static_cast<long long>(n) * m;
  const long long v = fields * field_rows;
  std::vector<int> keys(l);
  std::vector<long long> order(l);
  for (long long i = 0; i < l; ++i) {
    keys[i] = static_cast<int>(ids[i] + (i / m) % fields * field_rows);
    order[i] = i;
  }
  std::stable_sort(order.begin(), order.end(), [&](long long a, long long b) {
    return keys[a] < keys[b];
  });
  std::vector<int> sorted(l);
  for (long long i = 0; i < l; ++i) sorted[i] = keys[order[i]];
  if (l > 0 && (sorted[0] < 0 || sorted[l - 1] >= v)) return 3;
  const long long slabs = (v + r - 1) / r;
  // the wrapper's searchsorted: each slab's first lookup, then l
  std::vector<long long> starts(slabs + 1);
  for (long long s = 0; s <= slabs; ++s) {
    starts[s] = ebb::lower_bound(sorted.data(), 0, l, s * r);
  }
  const int chunk = ebb::chunk_lookups(e);
  BagBwd bw{sorted, order, mask, d_out, m, e, chunk,
            std::vector<float>(static_cast<size_t>(r) * e),
            std::vector<float>(chunk * e), std::vector<int>(chunk),
            std::vector<int>(chunk + 1), std::vector<int>(v)};
  auto rows_of = [&](long long s) {
    return static_cast<int>(std::min<long long>(r, v - s * r));
  };
  for (long long s = 0; s < slabs; ++s) {
    if (starts[s + 1] - starts[s] <= ebb::kWindow) {
      bw.walk(s * r, 0, rows_of(s), starts[s], starts[s + 1], d_table);
    }
  }
  const long long windows = (l + ebb::kWindow - 1) / ebb::kWindow;
  for (long long h = 0; h < windows; ++h) {
    const long long first = h * ebb::kWindow;
    const long long last = std::min(first + ebb::kWindow, l) - 1;
    for (int side = 0; side < 2; ++side) {
      const long long s = sorted[side == 0 ? first : last] / r;
      if (side == 1 && s == sorted[first] / r) break;
      const long long lo_s = starts[s];
      const long long hi_s = starts[s + 1];
      if (hi_s - lo_s <= ebb::kWindow) continue;
      const long long r0 = s * r;
      const long long h0 = lo_s / ebb::kWindow;
      const long long h1 = (hi_s - 1) / ebb::kWindow;
      const int ra = ebb::window_row(sorted.data(), h, h0, h1, r0, rows_of(s));
      const int rb =
          ebb::window_row(sorted.data(), h + 1, h0, h1, r0, rows_of(s));
      if (ra >= rb) continue;
      bw.walk(r0, ra, rb, ebb::lower_bound(sorted.data(), lo_s, hi_s, r0 + ra),
              ebb::lower_bound(sorted.data(), lo_s, hi_s, r0 + rb), d_table);
    }
  }
  for (long long x = 0; x < v; ++x) {
    if (bw.writes[x] != 1) return 4;
  }
  return 0;
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
  if (argc == 3 && strcmp(argv[1], "keys") == 0) {
    const int n = atoi(argv[2]);
    std::vector<float> scores(n);
    std::vector<bt::Key> keys(static_cast<size_t>(n) + 1);
    read_all(scores);
    for (int i = 0; i < n; ++i) keys[i] = bt::make_key(scores[i], i);
    keys[n] = bt::init_key(n, 0);
    write_all(keys);
    return 0;
  }
  if (argc == 8 && strcmp(argv[1], "bag_bwd") == 0) {
    const int n = atoi(argv[2]);
    const int m = atoi(argv[3]);
    const int e = atoi(argv[4]);
    const int fields = atoi(argv[5]);
    const long long field_rows = atoll(argv[6]);
    const int r = atoi(argv[7]);
    if (n < 0 || m < 0 || e < 1 || e > ebb::kStageFloats / 32 ||
        fields < 1 || field_rows < 1 || r < 1) {
      fprintf(stderr, "host_check: bad bag_bwd shape\n");
      return 2;
    }
    const size_t l = static_cast<size_t>(n) * m;
    std::vector<int> ids(l);
    std::vector<unsigned char> mask(l);
    std::vector<float> d_out(static_cast<size_t>(n) * e);
    read_all(ids);
    read_all(mask);
    read_all(d_out);
    // NaN everywhere first: every float of the output must be written
    std::vector<float> d_table(static_cast<size_t>(fields) * field_rows * e,
                               NAN);
    const int rc = bag_bwd(ids, mask, d_out, n, m, e, fields, field_rows,
                           r, d_table.data());
    if (rc != 0) {
      fprintf(stderr, rc == 3 ? "host_check: a row is out of range\n"
                              : "host_check: a row not written once\n");
      return rc;
    }
    write_all(d_table);
    return 0;
  }
  const bool split = argc == 7 && strcmp(argv[1], "topk_split") == 0;
  if (argc != 5 && !split) {
    fprintf(stderr,
            "usage: host_check fused|topk Q D LEVEL|K\n"
            "       host_check topk_split Q D K S STAGE\n"
            "       host_check keys N\n"
            "       host_check bag_bwd N M E FIELDS FIELD_ROWS R\n");
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
    // the rank-term table, as the kernels build it
    std::vector<float> tdiv(d), tw(d);
    for (int p = 0; p < d; ++p) {
      tdiv[p] = fm::dcg_divisor(p);
      tw[p] = fm::rbp_term(p);
    }
    for (int r = 0; r < q; ++r) {
      const size_t at = static_cast<size_t>(r) * d;
      (d <= fm::kShortMaxD ? fused_short_row : fused_long_row)(
          &rel[at], &judged[at], &scal[r * fm::kScalarWidth], tdiv.data(),
          tw.data(), &out[r * fm::kOutWidth], d, level);
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
