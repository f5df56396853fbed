// Selective sum over pre-gathered code rows (gather="materialize").
//
// Replaces: repro/kernels/decompress_score.py, selective_sum_kernel_call
// (Pallas body _selective_sum_kernel): out[q, n] = sum_d v[q, d, code(q, n, d)]
// for packed u8[Q, N, PB] and v f32[Q, D, 2^b].
//
// Bound on the H100: bytes. Every code byte is read once and every score
// written once: Q*N*PB + 4*Q*N bytes (Q = 32, N = nprobe*cap = 32768,
// PB = 64: 67.1 MB + 4.2 MB, about 21 us at 3.35 TB/s). The arithmetic is
// one shared-memory load and one add per dimension, far below the card's
// rate for that traffic.
//
// Design: one block per (query token q, block of 512 rows). The block
// copies q's v-table into shared memory once (8 KiB at D = 128, b = 4,
// read from L2 after the first block of q) and then streams its rows:
// half-warps read each 64-byte row with 32-bit loads, contiguous across
// the half-warp, so loads coalesce. The TPU kernel's select-accumulate over
// the 2^b buckets is replaced by the shared-memory gather (score_row.cuh).
#include "score_row.cuh"

namespace {

constexpr int kRowsPerBlock = 512;

template <int NBITS>
__global__ void __launch_bounds__(warp::kThreads)
    selective_sum_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ v,
                         float* __restrict__ out, int n, int pb, int dim, bool vec4) {
  extern __shared__ float v_s[];
  const int q = blockIdx.y;
  const int nb = 1 << NBITS;
  warp::load_vtable(v_s, v + static_cast<size_t>(q) * dim * nb, dim * nb);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int lane_g = lane & (warp::kGroup - 1);
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r_end = min(n, r0 + kRowsPerBlock);
  const uint8_t* base = packed + static_cast<size_t>(q) * n * pb;
  float* o = out + static_cast<size_t>(q) * n;
  // The loop bound is uniform across each warp, so every lane reaches the
  // shuffles in score_row together.
  for (int c0 = r0 + (threadIdx.x >> 5) * 2; c0 < r_end; c0 += warp::kRowsPerStep) {
    const int r = c0 + half;
    const bool ok = r < r_end;
    const float s = warp::score_row<NBITS>(
        ok ? base + static_cast<size_t>(r) * pb : nullptr, pb, vec4, v_s, lane_g);
    if (ok && lane_g == 0) o[r] = s;
  }
}

template <int NBITS>
cudaError_t launch(const uint8_t* packed, const float* v, float* out, int q, int n,
                   int pb, int dim, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dim) * (1 << NBITS) * sizeof(float);
  cudaError_t err = warp::allow_smem(selective_sum_kernel<NBITS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, q);
  selective_sum_kernel<NBITS><<<grid, warp::kThreads, smem, stream>>>(
      packed, v, out, n, pb, dim, warp::aligned4(packed, pb));
  return cudaGetLastError();
}

}  // namespace

extern "C" int warp_selective_sum(const void* packed, const void* v, void* out, int q,
                                  int n, int pb, int dim, int nbits, void* stream) {
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: return launch<2>(p, vv, o, q, n, pb, dim, s);
    case 4: return launch<4>(p, vv, o, q, n, pb, dim, s);
    case 8: return launch<8>(p, vv, o, q, n, pb, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
