// EmbeddingBag(sum) in padded form: out[s] = sum_l w[s, l] * table[idx[s, l]].
//
// Replaces: repro/kernels/embedding_bag.py, embedding_bag_kernel_call (Pallas
// body _embedding_bag_kernel), which computes the bags as a one-hot x
// table-block contraction on the TPU's matrix unit, accumulated over vocab
// blocks: O(S * L * V * D) work, meant for a modest vocabulary or a shard.
// Here the function is computed directly as a gather-sum, O(S * L * D), which
// is what a vocabulary of millions of rows needs.
//
// Semantics kept from the TPU kernel: an index outside [0, V) (negative, or
// >= V) contributes exactly 0 (its one-hot row matches no table row, or a
// zero padding row). Here such a row is never loaded, so no index value
// reads outside the table.
//
// Bound on the H100: bytes. Every bag reads L rows of D floats from random
// places in the table, its L indices and weights, and writes D floats:
// S*L*D*4 + S*L*(idx + 4) + S*D*4 bytes (two-tower user tower at serve_bulk,
// S = 262,144, L = 8, D = 256: 2.43 GB, 0.73 ms at 3.35 TB/s). One fma per
// row element is far below the card's float32 rate for that traffic.
//
// Design: one warp per bag, eight bags per 256-thread block. The warp loads
// its bag's indices and weights 32 at a time (one per lane) and broadcasts
// them with __shfl_sync; the lanes stride the D columns of each row, so a
// row is read by contiguous, coalesced loads: float4 loads where D % 4 == 0
// and rows sit on 16 bytes, else scalar loads. Columns are taken in chunks
// of 128 outside the l-loop (4 accumulators a lane), so registers stay
// bounded for any D. Rows are fetched kUnroll at a time before their fmas,
// so each warp keeps several row loads in flight. The sum is float32, in
// index order l = 0 .. L-1, with fmaf, and each output is written once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / 32;
constexpr int kChunk = 128;  // columns a warp covers per pass (4 per lane)
constexpr int kUnroll = 4;   // rows fetched before their fmas
constexpr unsigned kFull = 0xffffffffu;

template <typename Idx, bool VEC4>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table, const Idx* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out, long long s,
                         int l, int d, long long v, long long row_stride) {
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (bag >= s) return;  // the whole warp leaves together
  const Idx* bag_idx = idx + bag * l;
  const float* bag_w = w + bag * l;
  float* o = out + bag * d;

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    // Column offsets of this lane's 4 accumulators within the chunk:
    // VEC4: 4 adjacent columns at 4 * lane; scalar: lane + 32 * k.
    const int cols = min(kChunk, d - c0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l0 = 0; l0 < l; l0 += 32) {
      const int n = min(32, l - l0);
      const long long my_i = lane < n ? static_cast<long long>(bag_idx[l0 + lane]) : -1;
      const float my_w = lane < n ? bag_w[l0 + lane] : 0.f;
      for (int j0 = 0; j0 < n; j0 += kUnroll) {
        float vals[kUnroll][4];
        float wts[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // j0 + u may pass n on the last step: lanes >= n hold index -1,
          // which is never loaded. Every lane takes part in the shuffles.
          const long long r = __shfl_sync(kFull, my_i, (j0 + u) & 31);
          wts[u] = __shfl_sync(kFull, my_w, (j0 + u) & 31);
          ok[u] = j0 + u < n && r >= 0 && r < v;
          const float* row = table + (ok[u] ? r : 0) * row_stride + c0;
          if (VEC4) {
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (ok[u] && 4 * lane < cols) t = __ldg(reinterpret_cast<const float4*>(row) + lane);
            vals[u][0] = t.x;
            vals[u][1] = t.y;
            vals[u][2] = t.z;
            vals[u][3] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = lane + 32 * k;
              vals[u][k] = ok[u] && c < cols ? __ldg(row + c) : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;  // outside [0, V) or past the bag: exactly 0
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = fmaf(wts[u], vals[u][k], acc[k]);
        }
      }
    }
    if (VEC4) {
      if (4 * lane < cols)
        reinterpret_cast<float4*>(o + c0)[lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        if (c < cols) o[c0 + c] = acc[k];
      }
    }
  }
}

template <typename Idx>
cudaError_t launch(const float* table, const Idx* idx, const float* w, float* out, long long s,
                   int l, int d, long long v, long long row_stride, cudaStream_t stream) {
  const long long blocks = (s + kBagsPerBlock - 1) / kBagsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // float4 loads need every row start on 16 bytes: the base and the row
  // stride, and whole float4s per row (d % 4 == 0; the output then too).
  const bool vec4 = d % 4 == 0 && row_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec4) {
    embedding_bag_kernel<Idx, true>
        <<<grid, kThreads, 0, stream>>>(table, idx, w, out, s, l, d, v, row_stride);
  } else {
    embedding_bag_kernel<Idx, false>
        <<<grid, kThreads, 0, stream>>>(table, idx, w, out, s, l, d, v, row_stride);
  }
  return cudaGetLastError();
}

}  // namespace

// table f32 rows of d floats, row_stride floats apart (v rows); idx int32 or
// int64 [s, l] (idx64 selects), w f32 [s, l], out f32 [s, d], all but the
// table contiguous. s, l and d must be positive: the wrapper returns zeros
// for an empty bag set without a launch.
extern "C" int warp_embedding_bag(const void* table, const void* idx, const void* w, void* out,
                                  long long s, int l, int d, long long v, long long row_stride,
                                  int idx64, void* stream) {
  if (s <= 0 || l <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(table);
  const auto* ww = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch(t, static_cast<const long long*>(idx), ww, o, s, l, d, v, row_stride, st);
  return launch(t, static_cast<const int*>(idx), ww, o, s, l, d, v, row_stride, st);
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
