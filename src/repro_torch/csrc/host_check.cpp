// Host check of the kernels' per-row arithmetic.  Runs the functions the
// CUDA kernels share through fused_measures.cuh and bitonic.cuh, rank by
// rank and stage by stage, on the CPU; tests/test_torch_host_check.py
// builds it with g++ and holds it against the plain PyTorch versions.
//
//   host_check fused Q D LEVEL  < rel, judged [Q,D], scalars [Q,16] (f32)
//                               > out [Q,64] f32
//   host_check topk Q D K       < scores [Q,D] f32
//                               > values [Q,K] f32, indices [Q,K] i32
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

// The tile loop of topk.cu, one pair at a time.
void topk_row(const float* s, float* out_v, int* out_i, int d, int k) {
  const int k2 = next_pow2(k, 128);
  const int block_d = 2 * k2 > 512 ? 2 * k2 : 512;
  std::vector<float> tv(block_d), rv(k2);
  std::vector<int> ti(block_d), ri(k2);
  for (int base = 0; base < d; base += block_d) {
    for (int p = 0; p < block_d; ++p) {
      const int g = base + p;
      tv[p] = g < d ? s[g] : -INFINITY;
      ti[p] = g;
    }
    for (int kk = 2; kk <= block_d; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int t = 0; t < block_d / 2; ++t) {
          bt::stage_pair(tv.data(), ti.data(), j, kk, t);
        }
      }
    }
    if (base == 0) {
      for (int p = 0; p < k2; ++p) {
        rv[p] = tv[p];
        ri[p] = ti[p];
      }
    } else {
      for (int t = 0; t < k2; ++t) {
        bt::keep_first(rv.data(), ri.data(), tv.data(), ti.data(), k2, t);
      }
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        for (int t = 0; t < k2 / 2; ++t) {
          bt::stage_pair(rv.data(), ri.data(), j, 2 * k2, t);
        }
      }
    }
  }
  for (int p = 0; p < k; ++p) {
    out_v[p] = rv[p];
    out_i[p] = ri[p];
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
  if (argc != 5) {
    fprintf(stderr, "usage: host_check fused|topk Q D LEVEL|K\n");
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
  if (strcmp(argv[1], "topk") == 0) {
    const int k = atoi(argv[4]);
    std::vector<float> scores(n), out_v(q * k);
    std::vector<int> out_i(q * k);
    read_all(scores);
    for (int r = 0; r < q; ++r) {
      topk_row(&scores[r * d], &out_v[r * k], &out_i[r * k], d, k);
    }
    write_all(out_v);
    write_all(out_i);
    return 0;
  }
  fprintf(stderr, "host_check: unknown mode %s\n", argv[1]);
  return 2;
}
