// Fused trec_eval measure pass for Hopper (sm_90a): all 55 standard columns
// of every query from its rank-sorted relevance row, in one read of the row.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_measures.py::_kernel
// (built by _measure_call, wrapped by fused_measures), which keeps a
// [block_q, D] tile in VMEM and takes log2(D) shifted-add prefix sums over
// it.  VMEM holds many megabytes; a Hopper SM has 227 KB of shared memory
// and D reaches 65,536, so a row is walked in chunks of 256 ranks instead,
// one chunk per warp at a time, 8 consecutive ranks a lane (two 16-byte
// loads of each input), with the running prefixes carried from chunk to
// chunk.
//
// Bound on this card: bytes.  Per query it reads 2·D·4 bytes (rel, judged)
// and 16·4 of scalars and writes 64·4.  What keeps the arithmetic under
// that:
// - The rank-only terms (the DCG divisor log2(rank + 1) and the RBP weight
//   0.2·0.8^(rank-1)) come from a table built once per rank position: in
//   shared memory per block for short rows, by a prologue launch into
//   device memory (read through L1/L2) for long ones.
// - Each rank's inputs are computed once and kept in registers.  The three
//   IEEE divisions (the DCG gain, AP's precision, bpref's fraction) run
//   only at ranks with a grade (rel > 0), the last two only at relevant
//   ones, and a warp with no graded rank and no cutoff in its chunk skips
//   the walk.
// - Scans are warp shuffles.  Short rows (D <= 2,048) take one warp each,
//   8 rows a block, three blocks an SM, on a persistent grid, with no
//   block barrier; each warp's next chunk (of its row or its next row) is
//   loaded before the current one is scanned.  Long rows take a block of 4
//   warps each, a chunk a warp, with two exchanges of warp totals a
//   1,024-rank tile (the three scanned counts before the walk; DCG and AP,
//   which the walk sums, after it), and the next tile's loads in flight.
// - A lane records only the cutoff slots whose rank it holds (known from
//   the constant cutoffs once per thread), and the 64 columns are computed
//   by 32 lanes, two each, and stored coalesced.
// A D that is not a multiple of 4 leaves rows off 16-byte alignment, so
// that D takes scalar loads throughout.
//
// The per-rank arithmetic lives in fused_measures.cuh, shared with the
// host check, which walks rows chunk by chunk and lane by lane as the
// kernels do.  Build without --use_fast_math: see the header.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_measures.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // a short-row block: 8 warps, a row each
// Three short-row blocks an SM (registers capped at 85, no spill) keep
// more rows in flight than the two that 96 registers allow.
constexpr int kShortBlocksPerSm = 3;
constexpr int kWarps = kThreads / 32;
constexpr int kLongWarps = 4;  // a long row's block: 4 warps, a chunk each
constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kTile = kLongWarps * fm::kChunk;  // ranks of a long row's tile
constexpr int kL = fm::kLaneRanks;

static_assert(kL == 8, "a lane loads two float4 of each input");
static_assert(fm::kShortMaxD % fm::kChunk == 0, "short table is whole chunks");
static_assert(fm::kSlotChunks <= kLongWarps, "constant cutoffs in tile 0");

struct LaneData {
  float rel[kL];
  float jd[kL];
};

__device__ __forceinline__ void put4(float* dst, float4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// A lane's ranks [p0, p0 + 8) of one row; zeros past d.  With kVec, d is a
// multiple of 4 and the rows 16-byte aligned, so each half is whole or
// past d.
template <bool kVec>
__device__ __forceinline__ void load_lane(const float* __restrict__ r,
                                          const float* __restrict__ j,
                                          int p0, int d, LaneData& x) {
  if (kVec) {
#pragma unroll
    for (int h = 0; h < kL; h += 4) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 b = a;
      if (p0 + h < d) {
        a = __ldcs(reinterpret_cast<const float4*>(r + p0 + h));
        b = __ldcs(reinterpret_cast<const float4*>(j + p0 + h));
      }
      put4(x.rel + h, a);
      put4(x.jd + h, b);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const bool in = p0 + i < d;
      x.rel[i] = in ? __ldcs(r + p0 + i) : 0.0f;
      x.jd[i] = in ? __ldcs(j + p0 + i) : 0.0f;
    }
  }
}

// Inclusive and exclusive scans of a lane value over the warp, and the
// warp's total.
struct Scan {
  float excl, total;
};

__device__ __forceinline__ float warp_incl(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__device__ __forceinline__ Scan warp_scan(float v, int lane) {
  const float incl = warp_incl(v, lane);
  float ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = 0.0f;
  return {ex, __shfl_sync(kFull, incl, 31)};
}

// Exclusive prefix of warp `warp` and the sum over a long row's block's
// kLongWarps warps, from their totals `tot` in shared memory (lane w reads
// warp w's).
__device__ __forceinline__ Scan block_scan(const float* tot, int lane,
                                           int warp) {
  float v = lane < kLongWarps ? tot[lane] : 0.0f;
#pragma unroll
  for (int off = 1; off < kLongWarps; off <<= 1) {
    const float y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  float ex = __shfl_sync(kFull, v, warp > 0 ? warp - 1 : 0);
  if (warp == 0) ex = 0.0f;
  return {ex, __shfl_sync(kFull, v, kLongWarps - 1)};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The constant slots of chunks 0 .. kSlotChunks-1 for this lane, 10 bits
// per chunk.
__device__ __forceinline__ unsigned long long slot_bits(int lane, int d) {
  unsigned long long bits = 0;
  for (int c = 0; c < fm::kSlotChunks; ++c) {
    bits |= static_cast<unsigned long long>(fm::lane_slots(c, lane, d))
            << (10 * c);
  }
  return bits;
}

__device__ __forceinline__ unsigned chunk_slots(unsigned long long bits,
                                                int chunk) {
  return chunk < fm::kSlotChunks
             ? static_cast<unsigned>(bits >> (10 * chunk)) & 0x3ffu
             : 0u;
}

// Per-rank inputs of a lane's ranks, and its totals of the scanned three;
// returns whether the lane holds a graded rank (rel > 0).
__device__ __forceinline__ bool lane_inputs(const LaneData& in, float level,
                                            fm::Rank* x, float t[3]) {
  t[0] = t[1] = t[2] = 0.0f;
  bool graded = false;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    x[i] = fm::rank_inputs(in.rel[i], in.jd[i], level);
    t[0] += x[i].b;
    t[1] += x[i].jn;
    t[2] += x[i].cj;
    graded = graded || in.rel[i] > 0.0f;
  }
  return graded;
}

// walk_lane, or lane_zeros alone where no lane of the warp has a graded
// rank or a slot in this chunk (the same result: see the header).
// Returns the scans of the lanes' DCG and AP sums.
struct Walked {
  Scan dcg, ap;
};

__device__ __forceinline__ Walked walk_warp(const fm::Rank* x,
                                            const float* div, const float* w,
                                            bool graded, int p0, int d,
                                            float n_rel, float bden,
                                            unsigned slots, fm::Prefix& pre,
                                            fm::Acc& acc, fm::Cut* cuts,
                                            int lane) {
  if (!__any_sync(kFull, graded || slots != 0u)) {
    fm::lane_zeros(x, p0, d, pre.cum, acc);
    return {{0.0f, 0.0f}, {0.0f, 0.0f}};
  }
  fm::walk_lane(x, div, w, p0, d, n_rel, bden, slots, pre, acc, cuts);
  return {warp_scan(pre.dcg, lane), warp_scan(pre.ap, lane)};
}

// The row's 64 columns from its slots (the constant ones recorded in
// `cuts`, the rest the totals `all`), by one warp, two columns a lane.
__device__ __forceinline__ void epilogue(fm::Cut* cuts, const fm::Cut& all,
                                         const fm::Acc& acc,
                                         const float* scal, float* dst,
                                         int lane, int d) {
  if (lane < fm::kNumSlots && fm::slot_is_total(lane, d)) cuts[lane] = all;
  __syncwarp();
  dst[lane] = fm::column(lane, cuts, acc, scal);
  dst[lane + 32] = fm::column(lane + 32, cuts, acc, scal);
  __syncwarp();  // cuts is reused by the warp's next row
}

// Short rows: one warp per row, rows strided over a persistent grid.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kShortBlocksPerSm)
    fused_short_rows(const float* __restrict__ rel,
                     const float* __restrict__ judged,
                     const float* __restrict__ scalars,
                     float* __restrict__ out, int q, int d, float level) {
  __shared__ __align__(16) float tdiv[fm::kShortMaxD];
  __shared__ __align__(16) float tw[fm::kShortMaxD];
  __shared__ fm::Cut cuts_all[kWarps][fm::kNumSlots];
  __shared__ unsigned long long slot_sh[kThreads];

  const int dpad = (d + fm::kChunk - 1) / fm::kChunk * fm::kChunk;
  for (int p = threadIdx.x; p < dpad; p += kThreads) {
    tdiv[p] = p < d ? fm::dcg_divisor(p) : 1.0f;
    tw[p] = p < d ? fm::rbp_term(p) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  // read once a chunk (kept in a register, it was recomputed each chunk)
  slot_sh[threadIdx.x] = slot_bits(lane, d);
  fm::Cut* cuts = cuts_all[warp];

  int row = blockIdx.x * kWarps + warp;
  int base = 0;
  LaneData cur;
  if (row < q) {
    load_lane<kVec>(rel + static_cast<size_t>(row) * d,
                    judged + static_cast<size_t>(row) * d, lane * kL, d, cur);
  }
  float carry[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // cum jn cj dcg ap
  fm::Acc acc = {0.0f, 0.0f, 0.0f, 0.0f};
  while (row < q) {
    // the next chunk, of this row or the warp's next one, in flight first
    int nrow = row;
    int nbase = base + fm::kChunk;
    if (nbase >= d) {
      nbase = 0;
      nrow += stride;
    }
    LaneData nxt;
    if (nrow < q) {
      load_lane<kVec>(rel + static_cast<size_t>(nrow) * d,
                      judged + static_cast<size_t>(nrow) * d,
                      nbase + lane * kL, d, nxt);
    }

    const float* scal = scalars + static_cast<size_t>(row) * fm::kScalarWidth;
    const float n_rel = __ldg(scal);
    const float bden = fminf(n_rel, __ldg(scal + 1));
    const int p0 = base + lane * kL;
    float div[kL], w[kL];
    put4(div, *reinterpret_cast<const float4*>(tdiv + p0));
    put4(div + 4, *reinterpret_cast<const float4*>(tdiv + p0 + 4));
    put4(w, *reinterpret_cast<const float4*>(tw + p0));
    put4(w + 4, *reinterpret_cast<const float4*>(tw + p0 + 4));
    fm::Rank x[kL];
    float t[3];
    const bool graded = lane_inputs(cur, level, x, t);
    Scan s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = warp_scan(t[k], lane);
    fm::Prefix pre = {carry[0] + s[0].excl, carry[1] + s[1].excl,
                      carry[2] + s[2].excl, 0.0f, 0.0f};
    const unsigned slots =
        chunk_slots(slot_sh[threadIdx.x], base / fm::kChunk);
    const Walked wk = walk_warp(x, div, w, graded, p0, d, n_rel, bden, slots,
                                pre, acc, cuts, lane);
    if (slots != 0u) {
      const float dcg_base = carry[3] + wk.dcg.excl;
      const float ap_base = carry[4] + wk.ap.excl;
#pragma unroll
      for (int c = 0; c < fm::kNumSlots - 1; ++c) {
        if ((slots >> c) & 1u) {
          cuts[c].dcg = dcg_base + cuts[c].dcg;
          cuts[c].ap = ap_base + cuts[c].ap;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) carry[k] += s[k].total;
    carry[3] += wk.dcg.total;
    carry[4] += wk.ap.total;

    if (nrow != row) {  // the row's last chunk
      const fm::Acc all_acc = {warp_sum(acc.bpref), warp_sum(acc.zeros),
                               warp_sum(acc.rel_at_r), warp_sum(acc.rbp)};
      const fm::Cut all = {carry[0], carry[4], carry[3], carry[2]};
      epilogue(cuts, all, all_acc, scal,
               out + static_cast<size_t>(row) * fm::kOutWidth, lane, d);
#pragma unroll
      for (int k = 0; k < 5; ++k) carry[k] = 0.0f;
      acc = {0.0f, 0.0f, 0.0f, 0.0f};
    }
    cur = nxt;
    row = nrow;
    base = nbase;
  }
}

// The rank-term table of long rows: [0, d) DCG divisors, [d, 2d) RBP
// weights.
__global__ void rank_table(float* __restrict__ table, int d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < d) {
    table[p] = fm::dcg_divisor(p);
    table[d + p] = fm::rbp_term(p);
  }
}

// Long rows: one block per row, tiles of kLongWarps chunks, warp w taking
// the tile's chunk w.
template <bool kVec>
__global__ void __launch_bounds__(kLongThreads)
    fused_long_rows(const float* __restrict__ rel,
                    const float* __restrict__ judged,
                    const float* __restrict__ scalars,
                    const float* __restrict__ table, float* __restrict__ out,
                    int d, float level) {
  // warp totals of the tile: the scanned three, then DCG and AP (written
  // before one barrier, read before the next, so one copy serves every
  // tile)
  __shared__ float tot[3][kLongWarps];
  __shared__ float tot_after[2][kLongWarps];
  __shared__ fm::Cut cuts[fm::kNumSlots];
  __shared__ fm::Acc red[kLongWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const float* r = rel + row * d;
  const float* jd = judged + row * d;
  const float* scal = scalars + row * fm::kScalarWidth;
  const float n_rel = __ldg(scal);
  const float bden = fminf(n_rel, __ldg(scal + 1));
  const unsigned long long sbits = slot_bits(lane, d);

  LaneData cur;
  load_lane<kVec>(r, jd, warp * fm::kChunk + lane * kL, d, cur);
  float carry[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // cum jn cj dcg ap
  fm::Acc acc = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int tile = 0; tile * kTile < d; ++tile) {
    const int chunk = tile * kLongWarps + warp;
    const int p0 = chunk * fm::kChunk + lane * kL;
    LaneData nxt;
    if ((tile + 1) * kTile < d) {
      load_lane<kVec>(r, jd, p0 + kTile, d, nxt);
    }
    float div[kL], w[kL];
    if (kVec) {
#pragma unroll
      for (int h = 0; h < kL; h += 4) {
        float4 a = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p0 + h < d) {
          a = __ldg(reinterpret_cast<const float4*>(table + p0 + h));
          b = __ldg(reinterpret_cast<const float4*>(table + d + p0 + h));
        }
        put4(div + h, a);
        put4(w + h, b);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const bool in = p0 + i < d;
        div[i] = in ? __ldg(table + p0 + i) : 1.0f;
        w[i] = in ? __ldg(table + d + p0 + i) : 0.0f;
      }
    }
    fm::Rank x[kL];
    float t[3];
    const bool graded = lane_inputs(cur, level, x, t);
    Scan s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = warp_scan(t[k], lane);
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tot[k][warp] = s[k].total;
    }
    __syncthreads();
    Scan b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = block_scan(tot[k], lane, warp);
    fm::Prefix pre = {(carry[0] + b[0].excl) + s[0].excl,
                      (carry[1] + b[1].excl) + s[1].excl,
                      (carry[2] + b[2].excl) + s[2].excl, 0.0f, 0.0f};
    const unsigned slots = chunk_slots(sbits, chunk);
    const Walked wk = walk_warp(x, div, w, graded, p0, d, n_rel, bden, slots,
                                pre, acc, cuts, lane);
    if (lane == 31) {
      tot_after[0][warp] = wk.dcg.total;
      tot_after[1][warp] = wk.ap.total;
    }
    __syncthreads();
    const Scan bd = block_scan(tot_after[0], lane, warp);
    const Scan ba = block_scan(tot_after[1], lane, warp);
    if (slots != 0u) {
      const float dcg_base = (carry[3] + bd.excl) + wk.dcg.excl;
      const float ap_base = (carry[4] + ba.excl) + wk.ap.excl;
#pragma unroll
      for (int c = 0; c < fm::kNumSlots - 1; ++c) {
        if ((slots >> c) & 1u) {
          cuts[c].dcg = dcg_base + cuts[c].dcg;
          cuts[c].ap = ap_base + cuts[c].ap;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) carry[k] += b[k].total;
    carry[3] += bd.total;
    carry[4] += ba.total;
    cur = nxt;
  }

  const fm::Acc wsum = {warp_sum(acc.bpref), warp_sum(acc.zeros),
                        warp_sum(acc.rel_at_r), warp_sum(acc.rbp)};
  if (lane == 0) red[warp] = wsum;
  __syncthreads();  // also orders the cut writes before the epilogue
  if (warp == 0) {
    fm::Acc all_acc = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = 0; v < kLongWarps; ++v) {
      all_acc.bpref += red[v].bpref;
      all_acc.zeros += red[v].zeros;
      all_acc.rel_at_r += red[v].rel_at_r;
      all_acc.rbp += red[v].rbp;
    }
    const fm::Cut all = {carry[0], carry[4], carry[3], carry[2]};
    epilogue(cuts, all, all_acc, scal, out + row * fm::kOutWidth, lane, d);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks of the short-row kernel that fit on the card at once.
int short_grid(bool vec) {
  int dev = 0;
  cudaGetDevice(&dev);
  static int cached[2][64];
  int& n = cached[vec][dev & 63];
  if (n == 0) {
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (vec) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_short_rows<true>, kThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_short_rows<false>, kThreads, 0);
    }
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

}  // namespace

// rel, judged: [q, d] f32 rank-sorted rows; scalars: [q, 16] f32;
// out: [q, 64] f32; table: 2·d f32 of scratch (used when rows are long).
// Rows of d <= 2,048 take one launch (a warp per row); longer rows two
// (the rank-term table, then a block per row).  Launches on `stream`, sets
// *launched to the number of kernels launched; returns cudaGetLastError().
extern "C" int fused_measures_launch(const float* rel, const float* judged,
                                     const float* scalars, float* out,
                                     float* table, int q, int d, float level,
                                     void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q > 0 && d > 0) {
    const bool vec = d % 4 == 0 && aligned16(rel) && aligned16(judged) &&
                     aligned16(table);
    if (d <= fm::kShortMaxD) {
      const int need = (q + kWarps - 1) / kWarps;
      const int grid = need < short_grid(vec) ? need : short_grid(vec);
      if (vec) {
        fused_short_rows<true><<<grid, kThreads, 0, st>>>(
            rel, judged, scalars, out, q, d, level);
      } else {
        fused_short_rows<false><<<grid, kThreads, 0, st>>>(
            rel, judged, scalars, out, q, d, level);
      }
      ++*launched;
    } else {
      rank_table<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(table,
                                                                     d);
      ++*launched;
      if (vec) {
        fused_long_rows<true><<<q, kLongThreads, 0, st>>>(
            rel, judged, scalars, table, out, d, level);
      } else {
        fused_long_rows<false><<<q, kLongThreads, 0, st>>>(
            rel, judged, scalars, table, out, d, level);
      }
      ++*launched;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
