// Fused CSR gather + selective sum over the dense probe grid
// (gather="fused", layout="dense").
//
// Replaces: repro/kernels/fused_gather_score.py,
// fused_gather_score_kernel_call (Pallas bodies _fused_kernel and
// _fused_kernel_db, shared _unpack_score): for each query token q and probe
// p, slot c of the output is pscore[q, p] + sum_d v[q, d, code_d] of code row
// starts[q, p] + c when c < sizes[q, p], and exactly 0 otherwise.
// codes u8[N, PB] (the resident index, never gathered), starts/sizes
// i32[Q, P], pscore f32[Q, P], v f32[Q, D, 2^b] -> out f32[Q, P, cap].
//
// Bound on the H100: bytes. The rows actually probed are read once
// (sum of the probed cluster sizes times PB: about 32*32*181*64 B = 12 MB
// at warp-xtr width and the mean cluster size) and the dense output is
// written once (4*Q*P*cap = 4.2 MB, mostly the zero tail of the grid).
//
// Design: one block per (q, p), looping over the cluster's rows with the
// shared scoring routine (score_row.cuh); the block zero-fills the slots
// past the cluster's size. The TPU kernel clamps its fetch to
// n_tokens - tile_c and rolls the tile back into place; here each row is
// loaded only when it is valid (masked load), so no clamp, roll, minimum
// index size or cap == 0 special case exists. Rows outside [0, n_tokens)
// — which a well-formed CSR never yields — are treated as invalid.
#include "score_row.cuh"

namespace {

template <int NBITS>
__global__ void __launch_bounds__(warp::kThreads)
    fused_gather_score_kernel(const uint8_t* __restrict__ codes,
                              const int* __restrict__ starts, const int* __restrict__ sizes,
                              const float* __restrict__ pscore, const float* __restrict__ v,
                              float* __restrict__ out, int n_tokens, int n_probes, int cap,
                              int pb, int dim, bool vec4) {
  extern __shared__ float v_s[];
  const int p = blockIdx.x;
  const int q = blockIdx.y;
  const int qp = q * n_probes + p;
  const int start = starts[qp];
  const int size = min(sizes[qp], cap);
  const float ps = pscore[qp];
  float* o = out + static_cast<size_t>(qp) * cap;

  for (int c = max(size, 0) + threadIdx.x; c < cap; c += blockDim.x) o[c] = 0.f;
  if (size <= 0) return;  // uniform across the block: an empty probe

  const int nb = 1 << NBITS;
  warp::load_vtable(v_s, v + static_cast<size_t>(q) * dim * nb, dim * nb);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int lane_g = lane & (warp::kGroup - 1);
  for (int c0 = (threadIdx.x >> 5) * 2; c0 < size; c0 += warp::kRowsPerStep) {
    const int c = c0 + half;
    const long long row = static_cast<long long>(start) + c;
    const bool ok = c < size && row >= 0 && row < n_tokens;
    const float s = warp::score_row<NBITS>(
        ok ? codes + static_cast<size_t>(row) * pb : nullptr, pb, vec4, v_s, lane_g);
    if (c < size && lane_g == 0) o[c] = ok ? s + ps : 0.f;
  }
}

template <int NBITS>
cudaError_t launch(const uint8_t* codes, const int* starts, const int* sizes,
                   const float* pscore, const float* v, float* out, int n_tokens, int q,
                   int p, int cap, int pb, int dim, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dim) * (1 << NBITS) * sizeof(float);
  cudaError_t err = warp::allow_smem(fused_gather_score_kernel<NBITS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p, q);
  fused_gather_score_kernel<NBITS><<<grid, warp::kThreads, smem, stream>>>(
      codes, starts, sizes, pscore, v, out, n_tokens, p, cap, pb, dim,
      warp::aligned4(codes, pb));
  return cudaGetLastError();
}

}  // namespace

extern "C" int warp_fused_gather_score(const void* codes, const void* starts,
                                       const void* sizes, const void* pscore, const void* v,
                                       void* out, int n_tokens, int q, int p, int cap, int pb,
                                       int dim, int nbits, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* ps = static_cast<const float*>(pscore);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: return launch<2>(c, st, sz, ps, vv, o, n_tokens, q, p, cap, pb, dim, s);
    case 4: return launch<4>(c, st, sz, ps, vv, o, n_tokens, q, p, cap, pb, dim, s);
    case 8: return launch<8>(c, st, sz, ps, vv, o, n_tokens, q, p, cap, pb, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
