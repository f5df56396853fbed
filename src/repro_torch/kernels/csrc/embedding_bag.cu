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

// ---------------------------------------------------------------- backward
//
// The gradient of out[s] = sum_l w[s, l] * table[idx[s, l]] given g = dout
// [S, D]. The TPU kernel is forward only; JAX differentiates jnp.take + sum,
// whose transpose is a scatter-add into the table rows. Two kernels:
//
//   dtable[v] = sum_{(s, l): idx[s, l] = v} w[s, l] * g[s]   (dense [V, D])
//   dw[s, l]  = <table[idx[s, l]], g[s]>, 0 where idx is outside [0, V)
//
// Both are deterministic: no float atomics, every output written once by
// one warp, its terms summed in a fixed order with fmaf.
//
// dtable: the wrapper sorts the flattened keys (idx, or V for an index
// outside [0, V)) with a stable sort, so each table row's contributions
// form one run in increasing s * L + l order. One warp per sorted position;
// the warp that starts a run sums it and writes the row, the others leave.
// Rows no bag names are the wrapper's zeros. A warp reads its run 32
// entries at a time (one per lane: position, weight) and broadcasts them
// with __shfl_sync; the lanes stride the D columns of g[s], in chunks of
// 128 outside the run loop. Bound: bytes. The dense [V, D] float32 output
// dominates (two-tower's user table: 5.12 GB, 1.53 ms at 3.35 TB/s); the
// runs read g once per contribution.
//
// dw: one warp per bag, as the forward; per slot the lanes stride D over
// the row and g[s] and the warp sums its lanes by a fixed butterfly.

constexpr int kRunBatch = 32;

__global__ void __launch_bounds__(kThreads)
    grad_table_kernel(const long long* __restrict__ key, const long long* __restrict__ pos,
                      const float* __restrict__ w, const float* __restrict__ g,
                      float* __restrict__ dtable, long long n, int l, int d, long long v) {
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (p >= n) return;
  const long long row = key[p];
  // Keys outside [0, V) sort last and name no row; a run is written by the
  // warp at its first position only. Both tests are warp-uniform.
  if (row < 0 || row >= v) return;
  if (p > 0 && key[p - 1] == row) return;
  float* out = dtable + row * d;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int cols = min(kChunk, d - c0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long q0 = p;; q0 += kRunBatch) {
      const long long q = q0 + lane;
      const bool in = q < n && key[q] == row;
      const long long f = in ? pos[q] : 0;
      const float wt = in ? w[f] : 0.f;
      // The run is contiguous from q0, so the lanes inside it are a prefix.
      const unsigned inside = __ballot_sync(kFull, in);
      const int cnt = inside == kFull ? 32 : __ffs(~inside) - 1;
      for (int j = 0; j < cnt; ++j) {
        const long long fj = __shfl_sync(kFull, f, j);
        const float wj = __shfl_sync(kFull, wt, j);
        const float* gs = g + (fj / l) * d + c0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = lane + 32 * k;
          if (c < cols) acc[k] = fmaf(wj, __ldg(gs + c), acc[k]);
        }
      }
      if (cnt < 32) break;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      if (c < cols) out[c0 + c] = acc[k];
    }
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    grad_weights_kernel(const float* __restrict__ table, const Idx* __restrict__ idx,
                        const float* __restrict__ g, float* __restrict__ dw, long long s, int l,
                        int d, long long v, long long row_stride) {
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (bag >= s) return;
  const Idx* bag_idx = idx + bag * l;
  const float* gs = g + bag * d;
  float* o = dw + bag * l;
  for (int l0 = 0; l0 < l; l0 += 32) {
    const int n = min(32, l - l0);
    const long long my_i = lane < n ? static_cast<long long>(bag_idx[l0 + lane]) : -1;
    float mine = 0.f;  // lane j keeps slot l0 + j's dot product
    for (int j = 0; j < n; ++j) {
      const long long r = __shfl_sync(kFull, my_i, j);
      float part = 0.f;
      if (r >= 0 && r < v) {  // warp-uniform
        const float* row = table + r * row_stride;
        for (int c = lane; c < d; c += 32) part = fmaf(__ldg(row + c), __ldg(gs + c), part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
      if (lane == j) mine = part;
    }
    if (lane < n) o[l0 + lane] = mine;
  }
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

// The table's gradient: key, pos int64 [n] (the stably sorted keys of the
// flattened [s, l] ids, V for an index outside [0, V), and their flat
// positions s * l + j), w f32 [s, l], g f32 [s, d], dtable f32 [v, d]
// contiguous and zeroed by the caller (rows no bag names stay 0).
extern "C" int warp_embedding_bag_grad_table(const void* key, const void* pos, const void* w,
                                             const void* g, void* dtable, long long n, int l,
                                             int d, long long v, void* stream) {
  if (n <= 0 || l <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBagsPerBlock - 1) / kBagsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  grad_table_kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const long long*>(pos),
      static_cast<const float*>(w), static_cast<const float*>(g), static_cast<float*>(dtable), n,
      l, d, v);
  return static_cast<int>(cudaGetLastError());
}

// The weights' gradient: table as for the forward, idx int32 or int64
// [s, l] (idx64 selects), g f32 [s, d], dw f32 [s, l], all but the table
// contiguous.
extern "C" int warp_embedding_bag_grad_weights(const void* table, const void* idx, const void* g,
                                               void* dw, long long s, int l, int d, long long v,
                                               long long row_stride, int idx64, void* stream) {
  if (s <= 0 || l <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (s + kBagsPerBlock - 1) / kBagsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* gg = static_cast<const float*>(g);
  auto* o = static_cast<float*>(dw);
  if (idx64)
    grad_weights_kernel<long long><<<grid, kThreads, 0, st>>>(
        t, static_cast<const long long*>(idx), gg, o, s, l, d, v, row_stride);
  else
    grad_weights_kernel<int><<<grid, kThreads, 0, st>>>(t, static_cast<const int*>(idx), gg, o, s,
                                                        l, d, v, row_stride);
  return static_cast<int>(cudaGetLastError());
}
