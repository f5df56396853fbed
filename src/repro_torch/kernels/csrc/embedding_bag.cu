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
// Bound on the H100: bytes. A sum of the nonzero terms reads only the rows
// of nonzero weight (the `needed` rows of kernels/embedding_bag.py::work),
// each bag's L indices and weights, and writes D floats a bag:
// needed*D*4 + S*L*(idx + 4) + S*D*4 bytes (the two-tower user tower at
// serve_bulk, S = 262,144, L = 8, D = 256, its prefix mask as the weights,
// 56% of them nonzero: 1.50 GB, 0.448 ms at 3.35 TB/s; DIN's history, S =
// 65,536, L = 100, D = 18: 0.138 ms). One fma per row element is far below
// the card's float32 rate for that traffic.
//
// Design: the card is held back by the row loads in flight and by the
// bytes of each row actually fetched, so the kernel reads only the rows
// that count and keeps many of them in flight, whatever D is:
//  - A group of G lanes takes one bag, each lane VEC adjacent columns (the
//    widest float4 / float2 / float loads the width, the row stride and the
//    bases allow) and NV such vectors G apart: G = D / VEC lanes up to 32
//    (DIN's D 18 in float2: 9 lanes, three bags a warp; xDeepFM's linear
//    term at D 1: one thread a bag, 32 bags a warp), else the whole warp
//    with NV vectors a lane, in passes of at most 8 floats a lane (one pass
//    over a 256-wide row in float4). A group's lanes load one row as one
//    contiguous run, so a warp's load touches few cache lines however
//    narrow the row.
//  - The warp stages its bags' ids and weights 32 slots at a time, one bag
//    per coalesced load (lane j on slot j), and compacts each bag's slots
//    that count by a ballot and a popcount rank into shared memory, in slot
//    order: a slot whose weight is 0.0 or -0.0, or whose id lies outside
//    [0, V), loads no row (it would add exactly 0: fmaf(0, x, acc) == acc
//    for finite x, and the sum never reaches -0.0).
//  - Each group then fetches kRowsInFlight of its compacted rows before
//    their fmas, and writes its output row once, as whole vectors.
// Each output element is fmaf over its bag's nonzero, in-range terms in
// increasing l, from +0.0: on a finite table the result is bit for bit the
// sum that fmas every in-range term. A NaN or Inf row under weight 0 adds
// nothing here (the plain version gives NaN there, as jnp.take + sum does;
// the TPU kernel's one-hot product gives NaN in every bag of the row's
// vocab block): no version promises anything for a non-finite table.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

__device__ __forceinline__ void fma_into(float* acc, float a, float x) { acc[0] = fmaf(a, x, acc[0]); }
__device__ __forceinline__ void fma_into(float* acc, float a, float2 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
}
__device__ __forceinline__ void fma_into(float* acc, float a, float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}
__device__ __forceinline__ void store(float* o, const float* a) { *o = a[0]; }
__device__ __forceinline__ void store(float2* o, const float* a) { *o = make_float2(a[0], a[1]); }
__device__ __forceinline__ void store(float4* o, const float* a) {
  *o = make_float4(a[0], a[1], a[2], a[3]);
}

// The widest vector (4, 2 or 1 floats) whose loads stay aligned: d and the
// stride whole vectors, every base on the vector's bytes.
int vec_width(int d, long long stride, const void* a, const void* b) {
  const auto aligned = [&](int k) {
    return d % k == 0 && stride % k == 0 && reinterpret_cast<uintptr_t>(a) % (4 * k) == 0 &&
           reinterpret_cast<uintptr_t>(b) % (4 * k) == 0;
  };
  return aligned(4) ? 4 : aligned(2) ? 2 : 1;
}

constexpr int kBagWarps = 4;                   // warps a block of the forward
constexpr int kBagThreads = 32 * kBagWarps;
constexpr int kRowsInFlight = 8;               // rows a group fetches before their fmas
constexpr int kLaneFloats = 8;                 // floats a lane holds per row and pass

constexpr int kPitch = 33;                     // entries a bag's staged chunk spans

// The forward: G = lanes lanes a bag, 32 / G bags a warp. Shared memory
// holds, per warp, the compacted rows and weights of one 32-slot chunk of
// its bags, entry j of bag i at i * kPitch + j: a bag's entries are written
// to adjacent words, and the groups' reads of their entry j fall in
// different banks.
template <int VEC, int NV, typename Idx>
__global__ void __launch_bounds__(kBagThreads)
    embedding_bag_kernel(const float* __restrict__ table, const Idx* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out, long long s,
                         int l, int d, long long v, long long row_stride, int lanes) {
  using VT = typename Vec<VEC>::T;
  constexpr int kStage = 64 / sizeof(Idx);  // bags whose slot loads are in flight together
  extern __shared__ unsigned char staged[];
  const int per = 32 / lanes;  // bags a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane / lanes, k = lane - group * lanes;
  const long long bag0 = (static_cast<long long>(blockIdx.x) * kBagWarps + warp) * per;
  if (bag0 >= s) return;  // the whole warp leaves together
  Idx* rows = reinterpret_cast<Idx*>(staged) + warp * kPitch * per;
  float* wts = reinterpret_cast<float*>(reinterpret_cast<Idx*>(staged) + kBagWarps * kPitch * per) +
               warp * kPitch * per;
  const unsigned below = (1u << lane) - 1u;
  const long long bag = bag0 + group;
  const bool mine = group < per && bag < s;
  const int nv = d / VEC;
  const int span = lanes * NV;  // vectors of one pass

  for (int q0 = 0; q0 < nv; q0 += span) {
    float acc[NV * VEC];
#pragma unroll
    for (int c = 0; c < NV * VEC; ++c) acc[c] = 0.f;
    for (int l0 = 0; l0 < l; l0 += 32) {
      const int j = l0 + lane;
      int n = 0;  // this group's compacted slots in the chunk
      for (int i0 = 0; i0 < per; i0 += kStage) {  // warp-uniform
        Idx id[kStage];
        float wt[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const long long b = bag0 + i0 + u;
          const bool in = i0 + u < per && b < s && j < l;
          id[u] = in ? idx[b * l + j] : Idx(-1);
          wt[u] = in ? w[b * l + j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          if (i0 + u >= per) break;  // warp-uniform
          const long long r = static_cast<long long>(id[u]);
          const bool ok = r >= 0 && r < v && wt[u] != 0.f;  // -0.0f == 0.f
          const unsigned mask = __ballot_sync(kFull, ok);
          if (ok) {
            const int at = (i0 + u) * kPitch + __popc(mask & below);
            rows[at] = id[u];
            wts[at] = wt[u];
          }
          if (group == i0 + u) n = __popc(mask);
        }
      }
      __syncwarp();
      if (mine) {
        for (int j0 = 0; j0 < n; j0 += kRowsInFlight) {
          VT vals[kRowsInFlight][NV];
          float a[kRowsInFlight];
#pragma unroll
          for (int u = 0; u < kRowsInFlight; ++u) {
            const bool in = j0 + u < n;
            const int at = group * kPitch + j0 + u;
            a[u] = in ? wts[at] : 0.f;
            const VT* row = reinterpret_cast<const VT*>(
                                table + (in ? static_cast<long long>(rows[at]) : 0LL) * row_stride) +
                            q0 + k;
#pragma unroll
            for (int c = 0; c < NV; ++c)
              vals[u][c] = in && q0 + k + lanes * c < nv ? __ldg(row + lanes * c) : VT{};
          }
#pragma unroll
          for (int u = 0; u < kRowsInFlight; ++u) {
            if (j0 + u >= n) break;
#pragma unroll
            for (int c = 0; c < NV; ++c) fma_into(acc + c * VEC, a[u], vals[u][c]);
          }
        }
      }
      __syncwarp();  // the chunk's entries are read before the next is staged
    }
    if (mine) {
      VT* o = reinterpret_cast<VT*>(out + bag * d) + q0 + k;
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (q0 + k + lanes * c < nv) store(o + lanes * c, acc + c * VEC);
    }
  }
}

template <typename Idx, int VEC, int NV>
cudaError_t launch_bags(const float* table, const Idx* idx, const float* w, float* out,
                        long long s, int l, int d, long long v, long long row_stride, int lanes,
                        cudaStream_t stream) {
  const int per = 32 / lanes;
  const long long blocks = ((s + per - 1) / per + kBagWarps - 1) / kBagWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kBagWarps) * kPitch * per * (sizeof(Idx) + sizeof(float));
  if (smem > 48 * 1024) {  // int64 ids at 32 bags a warp: 50,688 bytes
    const cudaError_t err = cudaFuncSetAttribute(embedding_bag_kernel<VEC, NV, Idx>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  embedding_bag_kernel<VEC, NV, Idx><<<dim3(static_cast<unsigned>(blocks)), kBagThreads, smem,
                                       stream>>>(table, idx, w, out, s, l, d, v, row_stride, lanes);
  return cudaGetLastError();
}

// Lanes a bag: D / VEC up to 32, else 32 with NV vectors a lane (the least
// power of two covering the row, at most kLaneFloats floats; a wider row
// takes several passes).
template <typename Idx>
cudaError_t launch(const float* table, const Idx* idx, const float* w, float* out, long long s,
                   int l, int d, long long v, long long row_stride, cudaStream_t stream) {
  const int vec = vec_width(d, row_stride, table, out);
  const int nv = d / vec;
  const int lanes = nv < 32 ? nv : 32;
  int per_lane = 1;
  while (per_lane * lanes < nv && 2 * per_lane * vec <= kLaneFloats) per_lane *= 2;
#define BAG_LAUNCH(VEC, NV) \
  return launch_bags<Idx, VEC, NV>(table, idx, w, out, s, l, d, v, row_stride, lanes, stream)
  if (vec == 4) {
    if (per_lane == 1) BAG_LAUNCH(4, 1);
    BAG_LAUNCH(4, 2);
  }
  if (vec == 2) {
    if (per_lane == 1) BAG_LAUNCH(2, 1);
    if (per_lane == 2) BAG_LAUNCH(2, 2);
    BAG_LAUNCH(2, 4);
  }
  if (per_lane == 1) BAG_LAUNCH(1, 1);
  if (per_lane == 2) BAG_LAUNCH(1, 2);
  if (per_lane == 4) BAG_LAUNCH(1, 4);
  BAG_LAUNCH(1, 8);
#undef BAG_LAUNCH
}

// ---------------------------------------------------------------- backward
//
// The gradient of out[s] = sum_l w[s, l] * table[idx[s, l]] given g = dout
// [S, D]. The TPU kernel is forward only; JAX differentiates jnp.take + sum,
// whose transpose is a scatter-add into the table rows:
//
//   dtable[v] = sum_{(s, l): idx[s, l] = v} w[s, l] * g[s]   (dense [V, D])
//   dw[s, l]  = <table[idx[s, l]], g[s]>, 0 where idx is outside [0, V)
//
// Both are deterministic: no float atomics, every output element written
// once by one thread or one warp, its terms summed in a fixed order with
// fmaf.
//
// What bounds them. The least work is bytes: dtable's dense [V, D] output
// written once, the ids, weights and g read once; dw one table row read per
// slot. At wide D that is nearly all output: the two-tower's user table
// (V 5M, D 256) is 5.12 GB, 1.54 ms at 3.35 TB/s, so a wide design has to
// write it as a fill would and keep everything else off its way. At narrow
// D the bytes are few (DIN's history, S 65,536, L 100, D 18, V 1M: 72 MB of
// dtable, 80 MB of ids and weights, 472 MB of rows for dw, 0.195 ms) and
// the cost is the work per id around them: the index sort over the
// S * L = 6.55M ids, the gathers of g and of the weights per id, a 72-byte
// row per slot. So at narrow D the design makes each step one pass over
// its data at the width of that data, with no launch or warp per id that
// does nothing:
//
//  1. Keys, sorted here. A key is the id, or V for an id outside [0, V), so
//     a key needs only bit_length(V) bits (20 at DIN). A least significant
//     digit first radix sort takes them in passes of at most kMaxDigitBits
//     bits (3 of 7 at DIN) with their flat positions, 32-bit wherever
//     S * L and V are below 2^31. Each pass is stable by construction:
//     per-tile digit counts (integer atomics in shared memory: a count does
//     not depend on their order), an exclusive scan of the counts
//     digit-major across tiles (one block per digit), and a scatter by
//     ranks within the tile (one ballot per digit bit finds a key's equal
//     digits among its 32, per-warp counts, warps in order), through shared
//     memory so that each digit's run is stored contiguously. The first pass
//     makes the keys from the ids; the last leaves keys and positions in
//     buffer 0.
//  2. Row offsets from the sorted keys (offsets[r] = the keys below r, each
//     r written once by the warp whose keys bracket it), so each row's
//     contributions are positions [offsets[r], offsets[r + 1]), in
//     increasing flat position.
//  3. The rows pass writes every row, zeros where no id names it (the
//     wrapper allocates dtable with torch.empty). D <= 32: one thread per
//     row holds its D accumulators in registers, reads g[s] with the widest
//     aligned vector the width allows (float2 at D 18) and keeps several
//     contributions' loads in flight before their fmas; a row named more
//     than kHotRow times is taken by its whole warp (lanes on columns, 32
//     contributions' loads at once). D > 32: the rows no id names are
//     zeroed by one short warp each, so the card's writes stay on adjacent
//     rows as a fill's do, and the named rows are summed by one warp per 32
//     sorted positions, each row by the warp that holds its first position,
//     lanes on columns. Every element's sum is fmaf over its row's
//     contributions in increasing flat position from 0, the chain of the
//     earlier one-warp-per-run kernel: dtable is bit for bit what that
//     design gave.
//  4. dw, D <= 32: one thread per (bag, slot). The bags' g rows are staged
//     once per block in shared memory; each thread reads its slot's table
//     row with the widest aligned vector loads the stride allows, sums the
//     dot product in column order with fmaf and writes dw coalesced (a
//     warp's slots are adjacent); an id outside [0, V) writes exactly 0.
//     D > 32: one warp per slot, lanes striding the columns, summed by a
//     fixed butterfly.

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;                           // keys a thread takes per tile
constexpr int kSortTile = kSortThreads * kSortItems;    // keys per block: 2048
constexpr int kWarpKeys = 32 * kSortItems;              // consecutive keys a warp ranks
constexpr int kMaxDigitBits = 8;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kHotRow = 64;      // contributions past which the warp takes a narrow row
constexpr int kRowGroup = 4;     // rows a thread of the narrow rows pass starts together
constexpr int kWideChunk = 256;  // columns one walk of a wide row covers (8 a lane)

// part + <x, gb[0 .. VEC)>, in column order.
__device__ __forceinline__ float dot_from(float part, float x, const float* gb) {
  return fmaf(x, gb[0], part);
}
__device__ __forceinline__ float dot_from(float part, float2 x, const float* gb) {
  return fmaf(x.y, gb[1], fmaf(x.x, gb[0], part));
}
__device__ __forceinline__ float dot_from(float part, float4 x, const float* gb) {
  return fmaf(x.w, gb[3], fmaf(x.z, gb[2], fmaf(x.y, gb[1], fmaf(x.x, gb[0], part))));
}

// The sort key of an id: the id in [0, v), else v.
template <typename U, typename Idx>
__device__ __forceinline__ U key_of(Idx id, long long v) {
  const long long i = static_cast<long long>(id);
  return static_cast<U>(i >= 0 && i < v ? i : v);
}

// Inclusive prefix sum over the block of kSortThreads; *total gets the
// block's sum. Every thread calls it; warp_sums holds kSortWarps entries.
template <typename U>
__device__ __forceinline__ U block_inclusive_scan(U x, U* warp_sums, U* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  U before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const U t = warp_sums[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();  // warp_sums may be written again by the next call
  *total = all;
  return x + before;
}

// Pass step 1: each tile's digit counts, hist[digit * tiles + tile]. The
// first pass (ids given) makes the keys from the ids.
template <typename U, typename Idx>
__global__ void __launch_bounds__(kSortThreads)
    sort_histogram_kernel(const Idx* __restrict__ ids, const U* __restrict__ keys,
                          U* __restrict__ hist, long long n, long long v, int shift, int radix,
                          long long tiles) {
  __shared__ unsigned counts[kMaxRadix];
  for (int i = threadIdx.x; i < radix; i += kSortThreads) counts[i] = 0;
  __syncthreads();
  const long long t0 = static_cast<long long>(blockIdx.x) * kSortTile;
  U key[kSortItems];  // all loads in flight before the first count
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const long long i = t0 + k * kSortThreads + threadIdx.x;
    key[k] = i < n ? (ids ? key_of<U>(ids[i], v) : keys[i]) : 0;
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k)
    if (t0 + k * kSortThreads + threadIdx.x < n)
      atomicAdd(&counts[static_cast<int>((key[k] >> shift) & static_cast<U>(radix - 1))], 1u);
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kSortThreads) hist[d * tiles + blockIdx.x] = counts[d];
}

// Pass step 2: block d turns digit d's tile counts into their exclusive
// prefix in tile order, in place, and writes their sum to totals[d].
template <typename U>
__global__ void __launch_bounds__(kSortThreads)
    sort_scan_kernel(U* __restrict__ hist, U* __restrict__ totals, long long tiles) {
  __shared__ U warp_sums[kSortWarps];
  U* row = hist + blockIdx.x * tiles;
  U carry = 0;
  for (long long b = 0; b < tiles; b += kSortThreads) {
    const long long i = b + threadIdx.x;
    const U x = i < tiles ? row[i] : 0;
    U sum;
    const U incl = block_inclusive_scan(x, warp_sums, &sum);
    if (i < tiles) row[i] = carry + incl - x;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Pass step 3: move the tile's keys and positions to their place in the
// pass's order. A key's place: the keys of lower digits (the exclusive sum
// of totals), this digit's keys in earlier tiles (the scanned hist), in
// earlier warps of this tile, in earlier rounds of its warp, and in lower
// lanes of its round (the lanes whose digit equals its own: one ballot per
// digit bit). Warp w ranks the tile's keys [w * kWarpKeys, (w + 1) *
// kWarpKeys), 32 a round, so the order is the input's: stable. The tile is
// first put in digit order in shared memory, then written out in that
// order, so each digit's run goes out in contiguous stores.
template <typename U, typename Idx>
__global__ void __launch_bounds__(kSortThreads)
    sort_scatter_kernel(const Idx* __restrict__ ids, const U* __restrict__ keys_in,
                        const U* __restrict__ pos_in, U* __restrict__ keys_out,
                        U* __restrict__ pos_out, const U* __restrict__ hist,
                        const U* __restrict__ totals, long long n, long long v, int shift,
                        int digit_bits, long long tiles) {
  __shared__ unsigned short warp_counts[kSortWarps][kMaxRadix];  // at most kSortTile
  __shared__ U start[kMaxRadix];  // the digit's first place in the output
  __shared__ U local[kMaxRadix];  // the digit's first place in the tile
  __shared__ U warp_sums[kSortWarps];
  __shared__ U stage[kSortTile];
  __shared__ unsigned char staged_digit[kSortTile];
  const int radix = 1 << digit_bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSortWarps * kMaxRadix; i += kSortThreads)
    warp_counts[i / kMaxRadix][i % kMaxRadix] = 0;
  {
    const U t = threadIdx.x < radix ? totals[threadIdx.x] : 0;
    U all;
    const U incl = block_inclusive_scan(t, warp_sums, &all);
    if (threadIdx.x < radix) start[threadIdx.x] = incl - t + hist[threadIdx.x * tiles + blockIdx.x];
  }
  const U mask = static_cast<U>(radix - 1);
  const unsigned below = (1u << lane) - 1u;
  const long long t0 = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long w0 = t0 + warp * kWarpKeys;
  const int in_tile = static_cast<int>(min(static_cast<long long>(kSortTile), n - t0));
  U key[kSortItems], pos[kSortItems];
  unsigned rank[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {  // all loads in flight before the first round
    const long long i = w0 + k * 32 + lane;
    key[k] = i < n ? (ids ? key_of<U>(ids[i], v) : keys_in[i]) : 0;
    pos[k] = i < n ? (ids ? static_cast<U>(i) : pos_in[i]) : 0;
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const bool in = w0 + k * 32 + lane < n;
    const int digit = static_cast<int>((key[k] >> shift) & mask);
    // The lanes in the tile holding this digit (lanes past the end: none).
    unsigned peers = __ballot_sync(kFull, in);
    for (int b = 0; b < digit_bits; ++b) {
      const unsigned set = __ballot_sync(kFull, (digit >> b) & 1);
      peers &= (digit >> b) & 1 ? set : ~set;
    }
    const unsigned before = in ? warp_counts[warp][digit] : 0u;
    __syncwarp();
    if (in && (peers & below) == 0)
      warp_counts[warp][digit] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
    rank[k] = before + __popc(peers & below);
  }
  __syncthreads();
  // Each digit's keys in the tile's earlier warps, and in the whole tile.
  U count = 0;
  if (threadIdx.x < radix) {
    for (int w = 0; w < kSortWarps; ++w) {
      const unsigned c = warp_counts[w][threadIdx.x];
      warp_counts[w][threadIdx.x] = static_cast<unsigned short>(count);
      count += c;
    }
  }
  {
    U all;
    const U incl = block_inclusive_scan(count, warp_sums, &all);
    if (threadIdx.x < radix) local[threadIdx.x] = incl - count;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (w0 + k * 32 + lane >= n) continue;
    const int digit = static_cast<int>((key[k] >> shift) & mask);
    const unsigned at = static_cast<unsigned>(local[digit]) + warp_counts[warp][digit] + rank[k];
    stage[at] = key[k];
    staged_digit[at] = static_cast<unsigned char>(digit);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = k * kSortThreads + threadIdx.x;
    const int digit = staged_digit[i];
    if (i < in_tile) keys_out[start[digit] + static_cast<U>(i) - local[digit]] = stage[i];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (w0 + k * 32 + lane >= n) continue;
    const int digit = static_cast<int>((key[k] >> shift) & mask);
    stage[static_cast<unsigned>(local[digit]) + warp_counts[warp][digit] + rank[k]] = pos[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = k * kSortThreads + threadIdx.x;
    const int digit = staged_digit[i];
    if (i < in_tile) pos_out[start[digit] + static_cast<U>(i) - local[digit]] = stage[i];
  }
}

// offsets[r] = the number of sorted keys below r, r in [0, v]. With key'(p)
// = key[p] for p < n and v at p = n, warp w takes positions p0 = 32 w ..
// p0 + 31 of [0, n] and writes, 32 rows at a time, every r in
// (key'(p0 - 1), key'(p_last)]: offsets[r] = the first of its positions p
// with key'(p) >= r, found by a binary search over its lanes' keys. The
// warps' row ranges tile [0, v], so each r is written once.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    row_offsets_kernel(const U* __restrict__ key, U* __restrict__ offsets, long long n,
                       long long v) {
  const int lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  if (p0 > n) return;  // the whole warp leaves together
  const long long p = p0 + lane;
  const long long mine = p < n ? static_cast<long long>(key[p]) : (p == n ? v : LLONG_MAX);
  const long long prev = p0 == 0 ? -1 : static_cast<long long>(key[p0 - 1]);
  const long long last = __shfl_sync(kFull, mine, static_cast<int>(min(31LL, n - p0)));
  for (long long r0 = prev + 1; r0 <= last; r0 += 32) {
    const long long r = r0 + lane;
    int i = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(kFull, mine, i + s - 1) < r) i += s;
    if (__shfl_sync(kFull, mine, i) < r) ++i;
    if (r <= last) offsets[r] = static_cast<U>(p0 + i);
  }
}

// dtable at D <= W <= 32: one thread per row, the grid striding over the
// rows kRowGroup at a time (the group's offsets loaded together, so a run
// of rows no bag names costs one round trip, not one each), VEC-wide loads
// of g, kRowLoads contributions' loads in flight before their fmas; a row
// of more than kHotRow contributions is taken by the warp, lane c on column
// c, 32 contributions' loads at once.
template <int W, int VEC, typename U>
__global__ void __launch_bounds__(kThreads)
    grad_rows_kernel(const U* __restrict__ offsets, const U* __restrict__ pos,
                     const float* __restrict__ w, const float* __restrict__ g,
                     float* __restrict__ dtable, long long v, int l, int d) {
  using VT = typename Vec<VEC>::T;
  constexpr int NV = W / VEC;  // vectors a row holds at most
  constexpr int R = W >= 32 ? 2 : (W >= 8 ? 4 : 8);  // kRowLoads at this width
  const int lane = threadIdx.x & 31;
  const int nv = d / VEC;
  const U ul = static_cast<U>(l);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long base = first; base - lane < v; base += kRowGroup * stride) {  // warp-uniform
    long long los[kRowGroup], his[kRowGroup];
#pragma unroll
    for (int k = 0; k < kRowGroup; ++k) {
      const long long row = base + k * stride;
      los[k] = row < v ? static_cast<long long>(offsets[row]) : 0;
      his[k] = row < v ? static_cast<long long>(offsets[row + 1]) : 0;
    }
#pragma unroll 1
    for (int k = 0; k < kRowGroup; ++k) {
      const long long row = base + k * stride;
      const bool mine = row < v;
      const long long lo = los[0], hi = his[0];
#pragma unroll
      for (int q = 0; q + 1 < kRowGroup; ++q) {  // the next row's to the front, in registers
        los[q] = los[q + 1];
        his[q] = his[q + 1];
      }
      const bool hot = hi - lo > kHotRow;
      if (mine && !hot) {
        float acc[W];
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = 0.f;
        for (long long j0 = lo; j0 < hi; j0 += R) {
          VT vals[R][NV];
          float wt[R];
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const bool ok = j0 + u < hi;
            const U f = ok ? pos[j0 + u] : U(0);
            wt[u] = ok ? w[f] : 0.f;
            const VT* gs = reinterpret_cast<const VT*>(g + static_cast<long long>(f / ul) * d);
#pragma unroll
            for (int c = 0; c < NV; ++c) vals[u][c] = ok && c < nv ? __ldg(gs + c) : VT{};
          }
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (j0 + u >= hi) break;
#pragma unroll
            for (int c = 0; c < NV; ++c) fma_into(acc + c * VEC, wt[u], vals[u][c]);
          }
        }
        VT* out = reinterpret_cast<VT*>(dtable + row * d);
#pragma unroll
        for (int c = 0; c < NV; ++c)
          if (c < nv) store(out + c, acc + c * VEC);
      }
      // Hot rows, one after another, by the whole warp.
      for (unsigned left = __ballot_sync(kFull, mine && hot); left; left &= left - 1) {
        const int src = __ffs(left) - 1;
        const long long r = __shfl_sync(kFull, row, src);
        const long long rlo = __shfl_sync(kFull, lo, src), rhi = __shfl_sync(kFull, hi, src);
        float acc = 0.f;
        for (long long q0 = rlo; q0 < rhi; q0 += 32) {
          const bool in = q0 + lane < rhi;
          const U f = in ? pos[q0 + lane] : U(0);
          const float wt = in ? w[f] : 0.f;
          const long long srow = static_cast<long long>(f / ul);
          const int cnt = static_cast<int>(min(32LL, rhi - q0));
          float gv[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const long long sj = __shfl_sync(kFull, srow, j);
            gv[j] = j < cnt && lane < d ? __ldg(g + sj * d + lane) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float wj = __shfl_sync(kFull, wt, j);
            if (j < cnt) acc = fmaf(wj, gv[j], acc);
          }
        }
        if (lane < d) dtable[r * d + lane] = acc;
      }
    }
  }
}

// dtable at D > 32, the rows no id names: one warp per row writes zeros
// (the other rows are grad_rows_heads_kernel's). One short warp per row
// keeps the card's writes on adjacent rows, as a fill would.
template <typename U, bool VEC4>
__global__ void __launch_bounds__(kThreads)
    grad_rows_zero_warp_kernel(const U* __restrict__ offsets, float* __restrict__ dtable, long long v,
                          int d) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (row >= v || offsets[row] != offsets[row + 1]) return;  // the whole warp leaves together
  float* out = dtable + row * d;
  if (VEC4) {
    for (int c = 4 * lane; c < d; c += 128)
      *reinterpret_cast<float4*>(out + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int c = lane; c < d; c += 32) out[c] = 0.f;
  }
}

// dtable at D > 32, the rows some id names: one warp per 32 sorted
// positions sums the row of each position that starts a run of equal keys
// (below V), one row at a time. Lanes stride the columns in chunks of
// kWideChunk (8 accumulators a lane: two float4 of adjacent columns where
// aligned, else columns lane + 32 k), so a row of up to 256 floats is one
// walk over its contributions, read 32 at a time and broadcast.
template <typename U, bool VEC4>
__global__ void __launch_bounds__(kThreads)
    grad_rows_heads_kernel(const U* __restrict__ keys, const U* __restrict__ offsets,
                           const U* __restrict__ pos, const float* __restrict__ w,
                           const float* __restrict__ g, float* __restrict__ dtable, long long n,
                           long long v, int l, int d) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5)) * 32;
  if (p0 >= n) return;  // the whole warp leaves together
  const long long p = p0 + lane;
  const long long key = p < n ? static_cast<long long>(keys[p]) : v;
  const long long prev = p == 0 ? -1 : (p < n ? static_cast<long long>(keys[p - 1]) : v);
  const bool head = key < v && key != prev;
  const long long my_hi = head ? static_cast<long long>(offsets[key + 1]) : 0;
  const U ul = static_cast<U>(l);
  // Column of accumulator k within a chunk.
  const auto column = [&](int k) { return VEC4 ? 4 * lane + 128 * (k / 4) + k % 4 : lane + 32 * k; };
  for (unsigned left = __ballot_sync(kFull, head); left; left &= left - 1) {
    const int src = __ffs(left) - 1;
    const long long lo = p0 + src;
    const long long hi = __shfl_sync(kFull, my_hi, src);
    float* out = dtable + __shfl_sync(kFull, key, src) * d;
    for (int c0 = 0; c0 < d; c0 += kWideChunk) {
      const int cols = min(kWideChunk, d - c0);
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      for (long long q0 = lo; q0 < hi; q0 += 32) {
        const bool in = q0 + lane < hi;
        const U f = in ? pos[q0 + lane] : U(0);
        const float wt = in ? w[f] : 0.f;
        const long long srow = static_cast<long long>(f / ul);
        const int cnt = static_cast<int>(min(32LL, hi - q0));
        for (int j = 0; j < cnt; ++j) {
          const float* gs = g + __shfl_sync(kFull, srow, j) * d + c0;
          const float wj = __shfl_sync(kFull, wt, j);
          if (VEC4) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (column(4 * h) < cols)
                fma_into(acc + 4 * h, wj, __ldg(reinterpret_cast<const float4*>(gs + column(4 * h))));
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (column(k) < cols) acc[k] = fmaf(wj, __ldg(gs + column(k)), acc[k]);
          }
        }
      }
      if (VEC4) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (column(4 * h) < cols) store(reinterpret_cast<float4*>(out + c0 + column(4 * h)), acc + 4 * h);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (column(k) < cols) out[c0 + column(k)] = acc[k];
      }
    }
  }
}

// dw at D <= W <= 32: one thread per flat slot f = s * l + j. gsm holds the
// g rows of the bags the block's slots lie in.
template <int W, int VEC, typename Idx>
__global__ void __launch_bounds__(kThreads)
    grad_slots_kernel(const float* __restrict__ table, const Idx* __restrict__ idx,
                      const float* __restrict__ g, float* __restrict__ dw, long long s, int l, int d,
                      long long v, long long row_stride) {
  using VT = typename Vec<VEC>::T;
  constexpr int NV = W / VEC;
  extern __shared__ float gsm[];
  const long long n = s * l;
  const long long f0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long b0 = f0 / l;
  const long long b1 = (min(f0 + kThreads, n) - 1) / l + 1;  // one past the block's last bag
  const int staged = static_cast<int>((b1 - b0) * d);
  for (int i = threadIdx.x; i < staged; i += kThreads) gsm[i] = g[b0 * d + i];
  __syncthreads();
  const long long f = f0 + threadIdx.x;
  if (f >= n) return;
  const long long r = static_cast<long long>(idx[f]);
  float part = 0.f;
  if (r >= 0 && r < v) {
    const VT* row = reinterpret_cast<const VT*>(table + r * row_stride);
    const float* gb = gsm + (f / l - b0) * d;
    const int nv = d / VEC;
    VT vals[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) vals[c] = c < nv ? __ldg(row + c) : VT{};
#pragma unroll
    for (int c = 0; c < NV; ++c)
      if (c < nv) part = dot_from(part, vals[c], gb + c * VEC);
  }
  dw[f] = part;
}

// dw at D > 32: one warp per slot; lanes stride the columns of the row and
// g[s], and the warp sums its lanes by a fixed butterfly.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    grad_slots_warp_kernel(const float* __restrict__ table, const Idx* __restrict__ idx,
                           const float* __restrict__ g, float* __restrict__ dw, long long s, int l,
                           int d, long long v, long long row_stride) {
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (f >= s * l) return;  // the whole warp leaves together
  const long long r = static_cast<long long>(idx[f]);
  float part = 0.f;
  if (r >= 0 && r < v) {  // warp-uniform
    const float* row = table + r * row_stride;
    const float* gs = g + (f / l) * d;
    for (int c = lane; c < d; c += 32) part = fmaf(__ldg(row + c), __ldg(gs + c), part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) dw[f] = part;
}

// Launches K::run<W, VEC>(a...) at the narrowest width tier W >= d
// (1, 4, 8, 16, 32) and vector width vec (1, 2 or 4; d % vec == 0).
template <class K, int W, class... A>
cudaError_t at_vec(int vec, A... a) {
  if (vec == 4) return K::template run<W, 4>(a...);
  if (vec == 2) return K::template run<W, 2>(a...);
  return K::template run<W, 1>(a...);
}

template <class K, class... A>
cudaError_t at_width(int d, int vec, A... a) {
  if (d <= 1) return K::template run<1, 1>(a...);
  if (d <= 4) return at_vec<K, 4>(vec, a...);
  if (d <= 8) return at_vec<K, 8>(vec, a...);
  if (d <= 16) return at_vec<K, 16>(vec, a...);
  return at_vec<K, 32>(vec, a...);
}

dim3 grid_of(long long items, long long per) { return dim3(static_cast<unsigned>((items + per - 1) / per)); }

// As many blocks of kThreads as the card holds at once of this kernel, and
// no more than the items need (per_block items a block).
template <typename K>
dim3 resident_grid(K kernel, long long items, long long per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long resident = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const long long blocks = (items + per_block - 1) / per_block;
  return dim3(static_cast<unsigned>(blocks < resident ? blocks : resident));
}

template <typename U>
struct RowsLaunch {
  template <int W, int VEC>
  static cudaError_t run(const U* offsets, const U* pos, const float* w, const float* g,
                         float* dtable, long long v, int l, int d, cudaStream_t st) {
    grad_rows_kernel<W, VEC, U><<<resident_grid(grad_rows_kernel<W, VEC, U>, v, kThreads),
                                  kThreads, 0, st>>>(offsets, pos, w, g, dtable, v, l, d);
    return cudaGetLastError();
  }
};

template <typename Idx>
struct SlotsLaunch {
  template <int W, int VEC>
  static cudaError_t run(const float* table, const Idx* idx, const float* g, float* dw,
                         long long s, int l, int d, long long v, long long row_stride,
                         cudaStream_t st) {
    // The bags kThreads consecutive slots can touch: (l + kThreads - 2) / l + 1.
    const long long bags = (l + kThreads - 2LL) / l + 1;
    const size_t smem = static_cast<size_t>(bags) * d * sizeof(float);
    grad_slots_kernel<W, VEC, Idx><<<grid_of(s * l, kThreads), kThreads, smem, st>>>(
        table, idx, g, dw, s, l, d, v, row_stride);
    return cudaGetLastError();
  }
};

// The sort's plan for n keys in [0, v], v >= 1: passes of digit_bits bits
// covering bit_length(v), and the tiles of kSortTile keys. Twin:
// repro_torch.kernels.ref.bag_sort_plan.
struct SortPlan {
  int passes, digit_bits;
  long long tiles;
};

SortPlan sort_plan(long long n, long long v) {
  int bits = 1;
  while (bits < 63 && (v >> bits) != 0) ++bits;
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  return {passes, (bits + passes - 1) / passes, (n + kSortTile - 1) / kSortTile};
}

template <typename U, typename Idx>
cudaError_t grad_table(const Idx* idx, const float* w, const float* g, float* dtable, U* keys,
                       U* pos, U* hist, long long hist_len, U* offsets, long long s, int l, int d,
                       long long v, cudaStream_t st) {
  const long long n = s * l;
  const SortPlan plan = sort_plan(n, v);
  const int radix = 1 << plan.digit_bits;
  if (hist_len < radix * (plan.tiles + 1)) return cudaErrorInvalidValue;
  U* totals = hist + radix * plan.tiles;
  const dim3 tiles(static_cast<unsigned>(plan.tiles));
  cudaError_t err;
  for (int p = 0; p < plan.passes; ++p) {
    const int out = (plan.passes - 1 - p) & 1;  // the last pass writes buffer 0
    const Idx* ids = p == 0 ? idx : nullptr;
    const U* kin = keys + (1 - out) * n;
    const U* pin = pos + (1 - out) * n;
    const int shift = p * plan.digit_bits;
    sort_histogram_kernel<U, Idx>
        <<<tiles, kSortThreads, 0, st>>>(ids, kin, hist, n, v, shift, radix, plan.tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sort_scan_kernel<U><<<dim3(radix), kSortThreads, 0, st>>>(hist, totals, plan.tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sort_scatter_kernel<U, Idx><<<tiles, kSortThreads, 0, st>>>(
        ids, kin, pin, keys + out * n, pos + out * n, hist, totals, n, v, shift, plan.digit_bits,
        plan.tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  row_offsets_kernel<U><<<grid_of(n + 1, kThreads), kThreads, 0, st>>>(keys, offsets, n, v);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (d <= 32)
    return at_width<RowsLaunch<U>>(d, vec_width(d, d, g, dtable), offsets, pos, w, g, dtable, v,
                                   l, d, st);
  const dim3 zero_grid = grid_of(v, kBagsPerBlock), heads_grid = grid_of(n, 32 * kBagsPerBlock);
  if (vec_width(d, d, g, dtable) == 4) {
    grad_rows_zero_warp_kernel<U, true><<<zero_grid, kThreads, 0, st>>>(offsets, dtable, v, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    grad_rows_heads_kernel<U, true>
        <<<heads_grid, kThreads, 0, st>>>(keys, offsets, pos, w, g, dtable, n, v, l, d);
  } else {
    grad_rows_zero_warp_kernel<U, false><<<zero_grid, kThreads, 0, st>>>(offsets, dtable, v, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    grad_rows_heads_kernel<U, false>
        <<<heads_grid, kThreads, 0, st>>>(keys, offsets, pos, w, g, dtable, n, v, l, d);
  }
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t grad_weights(const float* table, const Idx* idx, const float* g, float* dw,
                         long long s, int l, int d, long long v, long long row_stride,
                         cudaStream_t st) {
  if (d <= 32)
    return at_width<SlotsLaunch<Idx>>(d, vec_width(d, row_stride, table, table), table, idx, g,
                                      dw, s, l, d, v, row_stride, st);
  grad_slots_warp_kernel<Idx><<<grid_of(s * l, kBagsPerBlock), kThreads, 0, st>>>(
      table, idx, g, dw, s, l, d, v, row_stride);
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


// The table's gradient, every row of it: idx int32 or int64 [s, l] (idx64
// selects), w f32 [s, l], g f32 [s, d], dtable f32 [v, d], all contiguous;
// scratch the caller allocates and this entry fills: keys and pos [2, s * l]
// and offsets [v + 1] of 32-bit (wide 0) or 64-bit (wide 1) integers, hist
// of hist_len such integers, at least radix * (tiles + 1) of the sort's plan
// (twin: ref.bag_sort_plan). On return keys[0] and pos[0] hold the stably
// sorted keys and their flat positions, offsets each row's range in them.
// 32-bit needs s * l and v below 2^31. s, l, d and v must be positive.
extern "C" int warp_embedding_bag_grad_table(const void* idx, const void* w, const void* g,
                                             void* dtable, void* keys, void* pos, void* hist,
                                             long long hist_len, void* offsets, long long s, int l,
                                             int d, long long v, int idx64, int wide,
                                             void* stream) {
  if (s <= 0 || l <= 0 || d <= 0 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = s * l;
  const long long most = n + 1 > v ? n + 1 : v;  // the largest grid: one warp per item
  if ((most + kBagsPerBlock - 1) / kBagsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!wide && (n >= (1LL << 31) || v >= (1LL << 31))) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ww = static_cast<const float*>(w);
  const auto* gg = static_cast<const float*>(g);
  auto* dt = static_cast<float*>(dtable);
  auto st = static_cast<cudaStream_t>(stream);
  if (wide) {
    using U = unsigned long long;
    auto* k = static_cast<U*>(keys);
    auto* p = static_cast<U*>(pos);
    auto* h = static_cast<U*>(hist);
    auto* o = static_cast<U*>(offsets);
    return idx64 ? grad_table(static_cast<const long long*>(idx), ww, gg, dt, k, p, h, hist_len, o,
                              s, l, d, v, st)
                 : grad_table(static_cast<const int*>(idx), ww, gg, dt, k, p, h, hist_len, o, s,
                              l, d, v, st);
  }
  using U = unsigned;
  auto* k = static_cast<U*>(keys);
  auto* p = static_cast<U*>(pos);
  auto* h = static_cast<U*>(hist);
  auto* o = static_cast<U*>(offsets);
  return idx64 ? grad_table(static_cast<const long long*>(idx), ww, gg, dt, k, p, h, hist_len, o, s,
                            l, d, v, st)
               : grad_table(static_cast<const int*>(idx), ww, gg, dt, k, p, h, hist_len, o, s, l,
                            d, v, st);
}

// The weights' gradient: table as for the forward, idx int32 or int64
// [s, l] (idx64 selects), g f32 [s, d], dw f32 [s, l], all but the table
// contiguous. Every slot is written.
extern "C" int warp_embedding_bag_grad_weights(const void* table, const void* idx, const void* g,
                                               void* dw, long long s, int l, int d, long long v,
                                               long long row_stride, int idx64, void* stream) {
  if (s <= 0 || l <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((s * l + kBagsPerBlock - 1) / kBagsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(table);
  const auto* gg = static_cast<const float*>(g);
  auto* o = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return static_cast<int>(
        grad_weights(t, static_cast<const long long*>(idx), gg, o, s, l, d, v, row_stride, st));
  return static_cast<int>(
      grad_weights(t, static_cast<const int*>(idx), gg, o, s, l, d, v, row_stride, st));
}
