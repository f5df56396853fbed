// Fused gather + selective sum over a ragged tile worklist
// (gather="fused", layout="ragged" — the serving path).
//
// Replaces: repro/kernels/fused_gather_score.py,
// ragged_fused_gather_score_kernel_call (Pallas bodies _ragged_kernel and
// _ragged_kernel_db): tile w scores code rows row0[w] + c for c < nvalid[w]
// against the v-table of query token qtok[w] and adds pscore[w]; every other
// slot, and every slot of a padding tile (nvalid == 0), is exactly 0.
// codes u8[N, PB], row0/nvalid/qtok i32[W], pscore f32[W], v f32[Q, D, 2^b]
// -> out f32[W * tile_c].
//
// Bound on the H100: bytes. The valid rows are read once (sum of nvalid
// times PB: about 12 MB per 32-token query at warp-xtr width and the mean
// cluster size) and the flat output written once (4*W*tile_c bytes).
//
// Design: one block per kTilesPerBlock consecutive worklist tiles. Tiles are
// query-token-major, so a block's tiles almost always share one query token:
// the block reloads its shared-memory v-table only when qtok changes.
// A padding tile returns early after writing its zeros — it fetches no codes
// and loads no table — so work follows the real tile count, not the static
// worklist bound. Rows are loaded only for valid slots (masked loads
// replace the TPU kernel's clamp to n_tokens - tile_c and its roll).
#include "score_row.cuh"

namespace {

constexpr int kTilesPerBlock = 4;

template <int NBITS>
__global__ void __launch_bounds__(warp::kThreads)
    ragged_fused_gather_score_kernel(const uint8_t* __restrict__ codes,
                                     const int* __restrict__ row0,
                                     const int* __restrict__ nvalid,
                                     const int* __restrict__ qtok,
                                     const float* __restrict__ pscore,
                                     const float* __restrict__ v, float* __restrict__ out,
                                     int n_tokens, int n_tiles, int tile_c, int n_q, int pb,
                                     int dim, bool vec4) {
  extern __shared__ float v_s[];
  const int nb = 1 << NBITS;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int lane_g = lane & (warp::kGroup - 1);
  const int w0 = blockIdx.x * kTilesPerBlock;
  const int w1 = min(n_tiles, w0 + kTilesPerBlock);
  int cur_q = -1;
  for (int w = w0; w < w1; ++w) {
    float* o = out + static_cast<size_t>(w) * tile_c;
    const int nv = min(nvalid[w], tile_c);
    const int qt = qtok[w];
    // nv and qt are the same for every thread, so these branches and the
    // barriers inside them are block-uniform.
    if (nv <= 0 || qt < 0 || qt >= n_q) {
      for (int c = threadIdx.x; c < tile_c; c += blockDim.x) o[c] = 0.f;
      continue;
    }
    if (qt != cur_q) {
      __syncthreads();  // every thread is done with the previous table
      warp::load_vtable(v_s, v + static_cast<size_t>(qt) * dim * nb, dim * nb);
      __syncthreads();
      cur_q = qt;
    }
    const int r0 = row0[w];
    const float ps = pscore[w];
    for (int c0 = (threadIdx.x >> 5) * 2; c0 < tile_c; c0 += warp::kRowsPerStep) {
      const int c = c0 + half;
      const long long row = static_cast<long long>(r0) + c;
      const bool ok = c < nv && row >= 0 && row < n_tokens;
      const float s = warp::score_row<NBITS>(
          ok ? codes + static_cast<size_t>(row) * pb : nullptr, pb, vec4, v_s, lane_g);
      if (c < tile_c && lane_g == 0) o[c] = ok ? s + ps : 0.f;
    }
  }
}

template <int NBITS>
cudaError_t launch(const uint8_t* codes, const int* row0, const int* nvalid,
                   const int* qtok, const float* pscore, const float* v, float* out,
                   int n_tokens, int n_tiles, int tile_c, int n_q, int pb, int dim,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dim) * (1 << NBITS) * sizeof(float);
  cudaError_t err = warp::allow_smem(ragged_fused_gather_score_kernel<NBITS>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  ragged_fused_gather_score_kernel<NBITS><<<blocks, warp::kThreads, smem, stream>>>(
      codes, row0, nvalid, qtok, pscore, v, out, n_tokens, n_tiles, tile_c, n_q, pb, dim,
      warp::aligned4(codes, pb));
  return cudaGetLastError();
}

}  // namespace

extern "C" int warp_ragged_fused_gather_score(const void* codes, const void* row0,
                                              const void* nvalid, const void* qtok,
                                              const void* pscore, const void* v, void* out,
                                              int n_tokens, int n_tiles, int tile_c, int n_q,
                                              int pb, int dim, int nbits, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* r = static_cast<const int*>(row0);
  const auto* nv = static_cast<const int*>(nvalid);
  const auto* qt = static_cast<const int*>(qtok);
  const auto* ps = static_cast<const float*>(pscore);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: return launch<2>(c, r, nv, qt, ps, vv, o, n_tokens, n_tiles, tile_c, n_q, pb, dim, s);
    case 4: return launch<4>(c, r, nv, qt, ps, vv, o, n_tokens, n_tiles, tile_c, n_q, pb, dim, s);
    case 8: return launch<8>(c, r, nv, qt, ps, vv, o, n_tokens, n_tiles, tile_c, n_q, pb, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
