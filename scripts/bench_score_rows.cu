// Carve-outs of the selective-sum kernel's pass on one GPU: where its
// time goes between staging rows and scoring them.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/bench_score_rows scripts/bench_score_rows.cu && build/bench_score_rows
//
// At the kernel phase's shape of chip_smoke.py (Q 32 query tokens,
// N = 32 probes x cap 1024 rows each, D 128, nbits 4, PB 64; random codes
// and tables), with csrc/score_rows.cuh's ring and lookups and the
// launcher's grid (one wave: blocks per token from the card's resident
// blocks), it times three passes:
//   full  - stage every row through the cp.async ring and score it (the
//           kernel's own loop);
//   stage - stage every row, score nothing (two bytes of each row summed);
//   score - stage nothing (the ring's copies skipped), score what the ring
//           holds.
// Each is timed after two flushes of the 50 MB L2: "dirty" writes 256 MB
// (cudaMemsetAsync, as chip_smoke.py's flush does, leaving the L2 full of
// lines the pass must write back) and "clean" reads 256 MB (leaving it
// full of lines it may drop). Median of 25 CUDA-event-timed runs each,
// printed as one JSON line with the card's name. Exits non-zero without a
// card or if the full pass disagrees with a host sum beyond 1e-4.
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <vector>

#include "../src/repro_torch/kernels/csrc/score_rows.cuh"

namespace {

using score_rows::WarpRing;

enum Mode { kFull = 0, kStage = 1, kScore = 2 };

template <int MODE>
__global__ void __launch_bounds__(score_rows::kMaxWarps * 32)
    pass(const uint8_t* __restrict__ packed, const float* __restrict__ v, float* __restrict__ out,
         int n, int pb, int dim) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NBITS = 4, NB = 16;
  const int q = blockIdx.y;
  const long long lo = static_cast<long long>(n) * blockIdx.x / gridDim.x;
  const long long hi = static_cast<long long>(n) * (blockIdx.x + 1) / gridDim.x;
  const uint8_t* base = packed + static_cast<size_t>(q) * n * pb;
  float* o = out + static_cast<size_t>(q) * n;
  float* v_s = score_rows::vtable_at(smem, score_rows::ring_bytes(blockDim.x >> 5, pb));
  WarpRing<true> ring(smem, lo, hi, pb);
  auto row_of = [&](long long f) {
    return MODE == kScore ? nullptr : base + static_cast<size_t>(f) * pb;
  };
  score_rows::load_vtable(v_s, v + static_cast<size_t>(q) * dim * NB, dim * NB);
  for (int i = 0; i < score_rows::kStages - 1; ++i) ring.issue(i, row_of);
  score_rows::cp_async_wait<score_rows::kStages - 1>();
  __syncthreads();
  for (int i = 0; i < ring.n_mine; ++i) {
    ring.issue(i + score_rows::kStages - 1, row_of);
    score_rows::cp_async_wait<score_rows::kStages - 1>();
    __syncwarp();
    const uint8_t* r = ring.row(i);
    const float s = MODE == kStage ? static_cast<float>(r[0] + r[pb - 1])
                                   : score_rows::score_staged<NBITS>(r, pb, v_s);
    const long long f = ring.flat(i);
    if (f < hi) o[f] = s;
    __syncwarp();
  }
}

// Reads n floats, writes one sum per block: fills the L2 with clean lines.
__global__ void read_all(const float4* __restrict__ a, size_t n4, float* __restrict__ sink) {
  float s = 0.f;
  for (size_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    const float4 x = a[i];
    s += x.x + x.y + x.z + x.w;
  }
  if (s == 1234.5f) sink[blockIdx.x] = s;  // keeps the loads; never true for zeros
}

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    std::fprintf(stderr, "bench_score_rows: %s: %s\n", what, cudaGetErrorString(e));
    std::exit(1);
  }
}

}  // namespace

int main() {
  int n_dev = 0;
  if (cudaGetDeviceCount(&n_dev) != cudaSuccess || n_dev == 0) {
    std::fprintf(stderr, "bench_score_rows: no CUDA device\n");
    return 2;
  }
  const int q = 32, n = 32 * 1024, pb = 64, dim = 128, nb = 16;
  const size_t flush_bytes = 256u << 20;
  std::mt19937 rng(0);
  std::vector<uint8_t> h_packed(static_cast<size_t>(q) * n * pb);
  for (auto& x : h_packed) x = static_cast<uint8_t>(rng());
  std::vector<float> h_v(static_cast<size_t>(q) * dim * nb);
  std::normal_distribution<float> normal;
  for (auto& x : h_v) x = normal(rng);

  uint8_t* packed;
  float *v, *out, *sink;
  void* flush;
  check(cudaMalloc(&packed, h_packed.size()), "malloc");
  check(cudaMalloc(&v, h_v.size() * 4), "malloc");
  check(cudaMalloc(&out, static_cast<size_t>(q) * n * 4), "malloc");
  check(cudaMalloc(&flush, flush_bytes), "malloc");
  check(cudaMalloc(&sink, 4096 * 4), "malloc");
  check(cudaMemset(flush, 0, flush_bytes), "memset");
  check(cudaMemcpy(packed, h_packed.data(), h_packed.size(), cudaMemcpyHostToDevice), "copy");
  check(cudaMemcpy(v, h_v.data(), h_v.size() * 4, cudaMemcpyHostToDevice), "copy");

  const int warps = score_rows::kMaxWarps, threads = warps * 32;
  const size_t smem = score_rows::ring_bytes(warps, pb) + score_rows::kVtableAlign +
                      static_cast<size_t>(dim) * nb * 4;
  void (*kernels[3])(const uint8_t*, const float*, float*, int, int, int) = {
      pass<kFull>, pass<kStage>, pass<kScore>};
  const char* names[3] = {"full", "stage", "score"};
  int per_sm = 0, sms = 0;
  for (auto k : kernels) {
    check(score_rows::allow_smem(k, smem), "smem");
  }
  check(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[0], threads, smem), "occ");
  check(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0), "sms");
  const int blocks = std::min(score_rows::blocks_per_token(q, per_sm * sms), n / 32);

  // The full pass against a host sum on a sample of rows.
  kernels[kFull]<<<dim3(blocks, q), threads, smem>>>(packed, v, out, n, pb, dim);
  check(cudaDeviceSynchronize(), "full pass");
  std::vector<float> h_out(static_cast<size_t>(q) * n);
  check(cudaMemcpy(h_out.data(), out, h_out.size() * 4, cudaMemcpyDeviceToHost), "copy");
  double err = 0;
  for (size_t r = 0; r < h_out.size(); r += 997) {
    const size_t t = r / n;
    double s = 0;
    for (int d = 0; d < dim; ++d) {
      const int code = (h_packed[r * pb + d / 2] >> (4 * (d % 2))) & 15;
      s += h_v[(t * dim + d) * nb + code];
    }
    err = std::max(err, std::fabs(s - h_out[r]));
  }
  if (!(err <= 1e-4)) {
    std::fprintf(stderr, "bench_score_rows: full pass off by %g\n", err);
    return 1;
  }

  cudaEvent_t e0, e1;
  check(cudaEventCreate(&e0), "event");
  check(cudaEventCreate(&e1), "event");
  std::string json = "{";
  for (int flush_kind = 0; flush_kind < 2; ++flush_kind) {
    for (int m = 0; m < 3; ++m) {
      std::vector<float> ms;
      for (int it = 0; it < 28; ++it) {
        if (flush_kind == 0) {
          check(cudaMemsetAsync(flush, 0, flush_bytes), "flush");
        } else {
          read_all<<<4 * sms, 512>>>(static_cast<const float4*>(flush), flush_bytes / 16, sink);
        }
        check(cudaEventRecord(e0), "record");
        kernels[m]<<<dim3(blocks, q), threads, smem>>>(packed, v, out, n, pb, dim);
        check(cudaEventRecord(e1), "record");
        check(cudaEventSynchronize(e1), "run");
        float t = 0;
        check(cudaEventElapsedTime(&t, e0, e1), "elapsed");
        if (it >= 3) ms.push_back(t);  // three warm-up runs
      }
      std::sort(ms.begin(), ms.end());
      char buf[96];
      std::snprintf(buf, sizeof buf, "%s\"%s_%s_ms\": %.5f", json.size() > 1 ? ", " : "",
                    names[m], flush_kind == 0 ? "dirty" : "clean", ms[ms.size() / 2]);
      json += buf;
    }
  }
  cudaDeviceProp prop;
  check(cudaGetDeviceProperties(&prop, 0), "props");
  std::printf("%s, \"blocks_per_token\": %d, \"max_abs_err\": %g, \"device\": \"%s\"}\n",
              json.c_str(), blocks, err, prop.name);
  return 0;
}
