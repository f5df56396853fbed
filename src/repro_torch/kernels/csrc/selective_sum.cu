// Selective sum over pre-gathered code rows (gather="materialize").
//
// Replaces: repro/kernels/decompress_score.py, selective_sum_kernel_call
// (Pallas body _selective_sum_kernel): out[q, n] = sum_d v[q, d, code(q, n, d)]
// for packed u8[Q, N, PB] and v f32[Q, D, 2^b].
//
// Bound on the H100: bytes. Every code byte is read once and every score
// written once: Q*N*PB + 4*Q*N bytes (Q = 32, N = nprobe*cap = 32768,
// PB = 64: 67.1 MB + 4.2 MB, about 21 us at 3.35 TB/s). Beside it sits a
// second floor, the shared-memory lookups: Q*N*D = 134M of them, one
// warp-wide LDS per 32, ~16 us at one LDS per SM clock and 1.98 GHz; the
// card issues them nearer one per two clocks (PERF.md).
//
// Design (score_rows.cuh): one thread per row, so the v-table lookups of a
// warp are conflict-free at nbits <= 4; rows staged through a per-warp
// cp.async ring, kStages chunks of 32 rows in flight per warp. Each query
// token's N rows split into S equal ranges, one block each, S from the
// number of blocks the card holds at once (one wave at Q = 32 and at the
// batched Q = 128). A block copies its token's v-table into shared memory
// once (cp.async), alongside its first chunks; a table too wide for one
// block (nbits 8 from D 208) is walked in chunks of dimensions (CHUNKED).
#include "score_rows.cuh"

namespace {

template <int NBITS, bool VEC16, bool CHUNKED>
__global__ void __launch_bounds__(score_rows::kMaxWarps * 32)
    selective_sum_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ v,
                         float* __restrict__ out, int n, int pb, int dim, int dc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q = blockIdx.y;
  const int nb = 1 << NBITS;
  const int blocks = gridDim.x;
  const long long lo = static_cast<long long>(n) * blockIdx.x / blocks;
  const long long hi = static_cast<long long>(n) * (blockIdx.x + 1) / blocks;
  if (lo >= hi) return;  // uniform across the block

  const uint8_t* base = packed + static_cast<size_t>(q) * n * pb;
  float* o = out + static_cast<size_t>(q) * n;
  const int warps = blockDim.x >> 5;
  float* v_s = score_rows::vtable_at(smem, score_rows::ring_bytes(warps, dc * NBITS / 8));
  auto row_of = [&](long long f) { return base + static_cast<size_t>(f) * pb; };
  score_rows::score_range<NBITS, VEC16, CHUNKED, score_rows::kProbeFull>(
      smem, v_s, v + static_cast<size_t>(q) * dim * nb, lo, hi, pb, dim, dc, false, false,
      row_of, [] {}, [&](long long f, float s, bool first) { o[f] = first ? s : o[f] + s; });
}

template <int NBITS, bool VEC16>
cudaError_t launch(const uint8_t* packed, const float* v, float* out, int q, int n, int pb,
                   int dim, cudaStream_t stream, int* plan) {
  const int dc = score_rows::dims_per_chunk(dim, NBITS, 0);
  if (dc == 0) return cudaErrorInvalidValue;
  const size_t vbytes = score_rows::vtable_bytes(dc, NBITS);
  const int warps = score_rows::warps_that_fit(vbytes, dc * NBITS / 8);
  const size_t smem = score_rows::ring_bytes(warps, dc * NBITS / 8) + vbytes;
  auto kernel = selective_sum_kernel<NBITS, VEC16, false>;
  if (dc < dim) kernel = selective_sum_kernel<NBITS, VEC16, true>;
  cudaError_t err = score_rows::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = warps * 32;
  const int resident =
      score_rows::resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem);
  const long long chunks = (static_cast<long long>(n) + score_rows::kChunk - 1) / score_rows::kChunk;
  int s = score_rows::blocks_per_token(q, resident);
  if (s > chunks) s = static_cast<int>(chunks);
  if (plan != nullptr) {  // the launch's shape, for reports; nothing runs
    plan[0] = threads;
    plan[1] = static_cast<int>(smem);
    plan[2] = resident;
    plan[3] = s;
    plan[4] = dc;
    return cudaSuccess;
  }
  kernel<<<dim3(s, q), threads, smem, stream>>>(packed, v, out, n, pb, dim, dc);
  return cudaGetLastError();
}

int dispatch(const void* packed, const void* v, void* out, int q, int n, int pb, int dim,
             int nbits, void* stream, int* plan) {
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec16 = score_rows::aligned16(packed, pb);
  switch (nbits * 2 + (vec16 ? 1 : 0)) {
    case 4: return launch<2, false>(p, vv, o, q, n, pb, dim, s, plan);
    case 5: return launch<2, true>(p, vv, o, q, n, pb, dim, s, plan);
    case 8: return launch<4, false>(p, vv, o, q, n, pb, dim, s, plan);
    case 9: return launch<4, true>(p, vv, o, q, n, pb, dim, s, plan);
    case 16: return launch<8, false>(p, vv, o, q, n, pb, dim, s, plan);
    case 17: return launch<8, true>(p, vv, o, q, n, pb, dim, s, plan);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int warp_selective_sum(const void* packed, const void* v, void* out, int q,
                                  int n, int pb, int dim, int nbits, void* stream) {
  return dispatch(packed, v, out, q, n, pb, dim, nbits, stream, nullptr);
}

// The launch warp_selective_sum would make for these arguments, without
// making it: plan = {threads per block, dynamic shared memory per block,
// blocks resident on the card, blocks per query token, v-table dims per
// chunk}.
extern "C" int warp_selective_sum_plan(const void* packed, int q, int n, int pb, int dim,
                                       int nbits, int* plan) {
  return dispatch(packed, nullptr, nullptr, q, n, pb, dim, nbits, nullptr, plan);
}
