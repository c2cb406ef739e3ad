// Per-row top-k for Hopper (sm_90a): the k largest scores of every row with
// their column indices, ties to the lower index (jax.lax.top_k's order).
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::_topk_kernel and its
// sorting network repro/kernels/bitonic.py (sort_desc, merge_desc, _stage,
// _compare_exchange).  That kernel walks the grid's document axis in order
// on one core, bitonic-sorts every tile and merges it into a running top-k
// carried in VMEM scratch.  Sorting every tile in shared memory is what
// bounded this kernel's first version on the card: a bitonic stage moves
// 32 bytes of shared memory per pair, and a 2,048-wide tile takes 66 of
// them.  Here a block of 512 threads owns a span of a row and sorts only
// the final k:
//
// * Keys.  Each (score, column) pair is one 64-bit key whose unsigned order
//   is the top-k order (bitonic.cuh::make_key).  The output values are
//   read back from the scores by column, bit for bit.
// * Filter.  The block keeps the k largest keys so far, in no order, and
//   their minimum, the running k-th.  Each thread tests four scores a tile
//   (one 16-byte load; two tiles' loads in flight together) against it,
//   and only larger keys go to a 4,096-entry staging buffer (a warp scan
//   and one block barrier a tile).  When the buffer could not take another
//   tile, and at the end, a radix select over kept ∪ staged keeps the k
//   largest (bitonic.cuh::select_top: a few 256-bin histogram passes, warp-
//   aggregated shared atomics).  On random scores about k·(1 + ln(D/k))
//   keys pass: some 5,000-9,000 of a 65,536-wide row.  Exact in any order:
//   the running k-th only grows.
// * One sort.  The final k (padded to k2 = next_pow2(k, 128)) are
//   bitonic-sorted once in shared memory; stages at distance <= 32 stay
//   inside a warp and end with __syncwarp.
// * Split rows.  One block per row leaves most of the card idle when Q is
//   small (retrieval: one row of 10^6).  The wrapper then cuts each row
//   into S contiguous chunks: pass 1 runs a (Q, S) grid and writes every
//   chunk's top-k keys, unsorted, to scratch [Q, S, k]; pass 2 runs the
//   same routine once per row over those S·k candidates.
//
// Bound on this card: bytes (the Q·D·4 bytes of scores read once, Q·k·8
// written); the filter does one compare per score.  What remains above
// the bound is the selects, the final sort and, for a split row, the
// second pass over S·k candidates.
//
// The key order, the network, the admission test and the select live in
// bitonic.cuh, which host_check.cpp runs on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                 // scores a thread tests per tile
constexpr int kTile = kThreads * kVec;  // 2,048 scores between selects
constexpr int kStage = 2 * kTile;       // staged keys before a select
constexpr int kUnroll = 2;              // tiles whose loads are in flight

// The thread block as a bitonic.cuh Team.  Pair t of a network stage runs
// on thread t % kThreads, so a stage at distance j <= 32 touches only the
// 64-entry span [64·(t/32), +64) that one warp owns: two such stages in a
// row need only a warp barrier.  The collective steps aggregate over a warp
// first: one shared-memory atomic per warp and distinct value.
struct BlockTeam {
  BT_HD int rank() const {
#ifdef __CUDA_ARCH__
    return static_cast<int>(threadIdx.x);
#else
    return 0;
#endif
  }
  BT_HD int size() const { return kThreads; }
  BT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  BT_HD void sync_stage(int j, int next) const {
#ifdef __CUDA_ARCH__
    if (j > 32 || next > 32) {
      __syncthreads();
    } else {
      __syncwarp();
    }
#endif
  }
  // hist[bin] += 1
  BT_HD void hist_add(unsigned* hist, int bin) const {
#ifdef __CUDA_ARCH__
    const unsigned active = __activemask();
    const unsigned peers = __match_any_sync(active, bin);
    if ((threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(hist + bin, __popc(peers));
    }
#endif
  }
  // The largest bin b with sum(hist[b+1:]) < need: sc.bin, sc.above (that
  // sum) and sc.in_bin (hist[b]), for every thread after the barrier.
  // Warp 0 scans the 256 bins from the top, eight a lane.
  BT_HD void find_bin(bt::SelectScratch& sc, int need) const {
#ifdef __CUDA_ARCH__
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sc.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
      if (lane == __ffs(hit) - 1) {
        int above = incl - sum;
        for (int j = 0; j < 8; ++j) {
          if (above + static_cast<int>(c[j]) >= need) {
            sc.bin = 255 - 8 * lane - j;
            sc.above = above;
            sc.in_bin = static_cast<int>(c[j]);
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
#endif
  }
  // A slot of sc.taken for each thread with `take` (in no fixed order).
  BT_HD int reserve(bt::SelectScratch& sc, bool take) const {
#ifdef __CUDA_ARCH__
    const unsigned active = __activemask();
    const unsigned ball = __ballot_sync(active, take);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(active) - 1;
    int base = 0;
    if (lane == leader && ball) base = atomicAdd(&sc.taken, __popc(ball));
    base = __shfl_sync(active, base, leader);
    return base + __popc(ball & ((1u << lane) - 1));
#else
    return 0;
#endif
  }
  // The smallest `v` of the block, for every thread after the barrier.
  BT_HD bt::Key reduce_min(bt::SelectScratch& sc, bt::Key v) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const bt::Key o = __shfl_xor_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
    if ((threadIdx.x & 31) == 0) atomicMin(&sc.kth, v);
    __syncthreads();
    return sc.kth;
#else
    return v;
#endif
  }
};

// Keys of the four row positions p0 .. p0 + 3 (pass 1: scores, p0 on a
// 16-byte boundary of the row; pass 2: the keys pass 1 wrote).  Positions
// outside [lo, hi) come back as key 0, which no admission test passes.
__device__ __forceinline__ void load4(const float* __restrict__ v,
                                      long long p0, long long lo,
                                      long long hi, bt::Key (&key)[kVec]) {
  if (p0 >= lo && p0 + kVec <= hi) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(v + p0));
    key[0] = bt::make_key(f.x, static_cast<int>(p0));
    key[1] = bt::make_key(f.y, static_cast<int>(p0 + 1));
    key[2] = bt::make_key(f.z, static_cast<int>(p0 + 2));
    key[3] = bt::make_key(f.w, static_cast<int>(p0 + 3));
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long p = p0 + e;
    key[e] = p >= lo && p < hi ? bt::make_key(__ldg(v + p), static_cast<int>(p))
                               : 0;
  }
}

__device__ __forceinline__ void load4(const bt::Key* __restrict__ c,
                                      long long p0, long long lo,
                                      long long hi, bool vec,
                                      bt::Key (&key)[kVec]) {
  if (vec && p0 >= lo && p0 + kVec <= hi) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(c + p0));
    const ulonglong2 b =
        __ldg(reinterpret_cast<const ulonglong2*>(c + p0 + 2));
    key[0] = a.x;
    key[1] = a.y;
    key[2] = b.x;
    key[3] = b.y;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long p = p0 + e;
    key[e] = p >= lo && p < hi ? __ldg(c + p) : 0;
  }
}

// Block (row, s) takes positions [s·chunk, (s+1)·chunk) of its row and
// keeps the top k.  Pass 1 (kCand false) reads a row of d scores; pass 2
// reads a row of row_len keys from `cand`.  With `out_key` the block writes
// its keys to out_key[(row·S + s)·k ...] (pass 1 of a split row); else the
// indices and the scores they point at to out_i / out_v [row·k ...].
template <bool kCand>
__global__ void __launch_bounds__(kThreads, 2)
    topk_filtered(const float* __restrict__ scores,
                  const bt::Key* __restrict__ cand, long long row_len,
                  long long chunk, int d, int k, int k2,
                  bt::Key* __restrict__ out_key, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  extern __shared__ bt::Key smem[];
  bt::Key* kept = smem;             // [k2]: the top k so far, in no order
  bt::Key* spare = smem + k2;       // [k2]: select_top's output
  bt::Key* stage = smem + 2 * k2;   // [kStage]
  __shared__ bt::SelectScratch sc;
  __shared__ int warp_total[2][kWarps];

  const BlockTeam team;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* v = scores + row * d;
  const bt::Key* c = kCand ? cand + row * row_len : nullptr;
  const long long lo = static_cast<long long>(blockIdx.y) * chunk;
  const long long hi = lo + chunk < row_len ? lo + chunk : row_len;

  for (int p = tid; p < k; p += kThreads) kept[p] = bt::init_key(d, p);
  bt::Key kth = bt::init_key(d, k - 1);

  // groups of four positions from a0: pass 1 starts at the 16-byte
  // boundary at or before lo, pass 2 at lo (16-byte loads where aligned)
  const long long a0 =
      kCand ? lo
            : lo - static_cast<long long>(
                       ((reinterpret_cast<uintptr_t>(v) >> 2) + lo) & 3);
  const bool vec =
      kCand && (reinterpret_cast<uintptr_t>(c + lo) & 15) == 0;
  const long long groups = hi > lo ? (hi - a0 + kVec - 1) / kVec : 0;
  int count = 0;  // staged keys, the same in every thread
  int par = 0;    // warp_total buffer of the next tile that stages
  for (long long g0 = 0; g0 < groups; g0 += kThreads * kUnroll) {
    bt::Key key[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p0 = a0 + kVec * (g0 + u * kThreads + tid);
      if (kCand) {
        load4(c, p0, lo, hi, vec, key[u]);
      } else {
        load4(v, p0, lo, hi, key[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g0 + u * kThreads < groups) {  // the same in every thread
        bool take[kVec];
        int n = 0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          take[e] = bt::admit(key[u][e], kth, d);
          n += take[e];
        }
        int incl = 0;  // inclusive scan of n over the warp
        if (__any_sync(0xffffffffu, n != 0)) {
          incl = n;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += y;
          }
        }
        if (lane == 31) warp_total[par][warp] = incl;
        // Readers of warp_total[par] finish before the next barrier, and the
        // next tile that stages writes the other buffer: one barrier a tile.
        if (__syncthreads_or(n != 0)) {
          int before = 0, total = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const int t = warp_total[par][w];
            total += t;
            before += w < warp ? t : 0;
          }
          int pos = count + before + incl - n;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            if (take[e]) stage[pos++] = key[u][e];
          }
          count += total;
          par ^= 1;
          if (count > kStage - kTile) {
            __syncthreads();
            kth = bt::select_top(team, sc, kept, k, stage, count, spare);
            bt::Key* t = kept;
            kept = spare;
            spare = t;
            count = 0;
          }
        }
      }
    }
  }
  __syncthreads();
  if (count > 0) {
    bt::select_top(team, sc, kept, k, stage, count, spare);
    kept = spare;
  }
  if (out_key != nullptr) {  // pass 1 of a split row: keys in no order
    const long long o = (row * gridDim.y + blockIdx.y) * k;
    for (int p = tid; p < k; p += kThreads) out_key[o + p] = kept[p];
    return;
  }
  for (int p = k + tid; p < k2; p += kThreads) kept[p] = 0;
  __syncthreads();
  bt::sort_desc(team, kept, k2);
  __syncthreads();
  for (int p = tid; p < k; p += kThreads) {
    const int i = bt::key_index(kept[p]);
    out_i[row * k + p] = i;
    out_v[row * k + p] = i < d ? v[i] : -__int_as_float(0x7f800000);
  }
}

}  // namespace

// scores: [q, d] f32 -> out_v: [q, k] f32, out_i: [q, k] i32; k2 is
// next_pow2(k, 128) <= 4096 and d + k2 < 2^31.  splits == 1: one pass, one
// block per row.  splits > 1: pass 1 cuts each row into `splits` chunks of
// `chunk` columns (splits·chunk >= d) and writes their top-k keys to
// `cand` ([q, splits, k] u64), pass 2 merges them.  Launches on `stream`,
// sets *launched to the number of kernels launched; returns
// cudaGetLastError().
extern "C" int topk_launch(const float* scores, float* out_v, int* out_i,
                           bt::Key* cand, int q, int d, int k, int k2,
                           int splits, long long chunk, void* stream,
                           int* launched) {
  *launched = 0;
  const size_t smem =
      (2 * static_cast<size_t>(k2) + kStage) * sizeof(bt::Key);
  if (smem + 2048 > 48 * 1024) {  // beyond the default, with static aside
    cudaFuncSetAttribute(topk_filtered<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaFuncSetAttribute(topk_filtered<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q > 0 && d > 0) {
    if (splits <= 1) {
      topk_filtered<false><<<dim3(q, 1), kThreads, smem, st>>>(
          scores, nullptr, d, d, d, k, k2, nullptr, out_v, out_i);
      ++*launched;
    } else {
      topk_filtered<false><<<dim3(q, splits), kThreads, smem, st>>>(
          scores, nullptr, d, chunk, d, k, k2, cand, nullptr, nullptr);
      ++*launched;
      const long long n = static_cast<long long>(splits) * k;
      topk_filtered<true><<<dim3(q, 1), kThreads, smem, st>>>(
          scores, cand, n, n, d, k, k2, nullptr, out_v, out_i);
      ++*launched;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
