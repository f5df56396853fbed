// Fused CSR gather + selective sum over the dense probe grid
// (gather="fused", layout="dense").
//
// Replaces: repro/kernels/fused_gather_score.py,
// fused_gather_score_kernel_call (Pallas bodies _fused_kernel and
// _fused_kernel_db, shared _unpack_score): for each query token q and probe
// p, slot c of the output is pscore[q, p] + sum_d v[q, d, code_d] of code row
// starts[q, p] + c when c < min(sizes[q, p], cap), and exactly 0 otherwise.
// codes u8[N, PB] (the resident index, never gathered), starts/sizes
// i32[Q, P], pscore f32[Q, P], v f32[Q, D, 2^b] -> out f32[Q, P, cap].
//
// Bound on the H100: bytes. The rows actually probed are read once
// (sum of the probed cluster sizes times PB: about 32*32*181*64 B = 12 MB
// at warp-xtr width and the mean cluster size) and the dense output is
// written once (4*Q*P*cap = 4.2 MB, mostly the zero tail of the grid).
//
// Design. Cluster sizes are skewed (log-normal, clamped at cap), so one
// block per (q, p) lasts as long as the largest cluster while most SMs
// idle. Instead each query token's probed rows are flattened, in probe
// order, into 0 .. T_q - 1 (T_q = sum_p min(sizes[q, p], cap); pre[p] the
// prefix sums) and split into S equal ranges, one block each, S from the
// number of blocks the card holds at once; flat row f belongs to the probe
// p with pre[p] <= f < pre[p + 1], slot c = f - pre[p]. The zero tails
// (slots c >= min(size, cap)) are flattened the same way, tail slot z of
// probe p at p * cap - pre[p] + (c - min(size, cap)), and split into S
// equal ranges too, written with 16-byte stores. Python twin of the split
// and both maps: ref.score_split. Rows are scored as in selective_sum.cu
// (score_rows.cuh: one thread per row, conflict-free lookups, a cp.async
// ring per warp; the v-table in chunks of dimensions where it is too wide
// for one block). Rows outside [0, n_tokens), which a well-formed CSR never
// yields, are not loaded and their slots are 0.
//
// Measurement carve-outs (warp_fused_gather_score_probe; the TPU kernel's
// `probe`): the same kernel instantiated at PROBE = score_rows::kProbeDma
// (rows staged, not scored) or kProbeCompute (rows scored, not staged);
// both write the zero tails and add the probe scores as the full kernel
// does.
#include "score_rows.cuh"

namespace {

using score_rows::last_at_most;

template <int NBITS, bool VEC16, bool CHUNKED, int PROBE>
__global__ void __launch_bounds__(score_rows::kMaxWarps * 32)
    fused_gather_score_kernel(const uint8_t* __restrict__ codes,
                              const int* __restrict__ starts, const int* __restrict__ sizes,
                              const float* __restrict__ pscore, const float* __restrict__ v,
                              float* __restrict__ out, int n_tokens, int n_probes, int cap,
                              int pb, int dim, int dc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q = blockIdx.y;
  const int nb = 1 << NBITS;
  const int warps = blockDim.x >> 5;
  float* v_s = score_rows::vtable_at(smem, score_rows::ring_bytes(warps, dc * NBITS / 8));
  int* pre = reinterpret_cast<int*>(v_s + dc * nb);    // [n_probes + 1]
  int* st = pre + n_probes + 1;                          // [n_probes]
  float* ps = reinterpret_cast<float*>(st + n_probes);   // [n_probes]
  float* o = out + static_cast<size_t>(q) * n_probes * cap;
  const float* v_tok = v + static_cast<size_t>(q) * dim * nb;

  // Everything the block needs from the probe arrays and the v-table (its
  // first chunk), in one round trip: the table by cp.async, starts, probe
  // scores and the clamped sizes by plain loads.
  score_rows::load_vtable(v_s, v_tok, dc * nb);
  for (int p = threadIdx.x; p < n_probes; p += blockDim.x) {
    const size_t qp = static_cast<size_t>(q) * n_probes + p;
    pre[p + 1] = min(max(sizes[qp], 0), cap);
    st[p] = starts[qp];
    ps[p] = pscore[qp];
  }
  if (threadIdx.x == 0) pre[0] = 0;
  __syncthreads();
  // pre[p] = sum of the clamped sizes before probe p.
  score_rows::warp0_prefix_sum(pre + 1, n_probes);
  __syncthreads();

  const long long total = pre[n_probes];
  const long long s = blockIdx.x, n_blocks = gridDim.x;
  const long long lo = total * s / n_blocks, hi = total * (s + 1) / n_blocks;
  auto probe_of = [&](long long f) {
    return last_at_most(n_probes, f, [&](int p) { return static_cast<long long>(pre[p]); });
  };
  auto row_of = [&](long long f) -> const uint8_t* {
    const int p = probe_of(f);
    const long long row = static_cast<long long>(st[p]) + (f - pre[p]);
    return row >= 0 && row < n_tokens ? codes + static_cast<size_t>(row) * pb : nullptr;
  };
  // This block's share of the zero tails, while its first rows load.
  auto zero_tails = [&] {
    const long long tails = static_cast<long long>(n_probes) * cap - total;
    long long z = tails * s / n_blocks;
    const long long z1 = tails * (s + 1) / n_blocks;
    auto tail_start = [&](int p) { return static_cast<long long>(p) * cap - pre[p]; };
    for (int p = z < z1 ? last_at_most(n_probes, z, tail_start) : n_probes;
         z < z1 && p < n_probes; ++p) {
      const int m = pre[p + 1] - pre[p];
      const long long t0 = tail_start(p);
      const long long end = min(z1, t0 + (cap - m));
      if (end > z) {
        score_rows::zero_fill(o + static_cast<size_t>(p) * cap + m + (z - t0), end - z);
        z = end;
      }
    }
  };
  score_rows::score_range<NBITS, VEC16, CHUNKED, PROBE>(
      smem, v_s, v_tok, lo, hi, pb, dim, dc, true, false, row_of, zero_tails,
      [&](long long f, float score, bool first) {
        const int p = probe_of(f);
        const long long c = f - pre[p];
        const long long row = static_cast<long long>(st[p]) + c;
        float* slot = o + static_cast<size_t>(p) * cap + c;
        if (row >= 0 && row < n_tokens) {
          *slot = first ? score + ps[p] : *slot + score;
        } else if (first) {
          *slot = 0.f;
        }
      });
}

template <int NBITS, bool VEC16, int PROBE>
cudaError_t launch(const uint8_t* codes, const int* starts, const int* sizes,
                   const float* pscore, const float* v, float* out, int n_tokens, int q,
                   int p, int cap, int pb, int dim, cudaStream_t stream, int* plan) {
  const size_t probes = (3 * static_cast<size_t>(p) + 1) * sizeof(int);
  const int dc = score_rows::dims_per_chunk(dim, NBITS, probes);
  if (dc == 0) return cudaErrorInvalidValue;
  const size_t fixed = probes + score_rows::vtable_bytes(dc, NBITS);
  const int warps = score_rows::warps_that_fit(fixed, dc * NBITS / 8);
  const size_t smem = score_rows::ring_bytes(warps, dc * NBITS / 8) + fixed;
  auto kernel = fused_gather_score_kernel<NBITS, VEC16, false, PROBE>;
  if (dc < dim) kernel = fused_gather_score_kernel<NBITS, VEC16, true, PROBE>;
  cudaError_t err = score_rows::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = warps * 32;
  const int resident =
      score_rows::resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem);
  const int s = score_rows::blocks_per_token(q, resident);
  if (plan != nullptr) {  // the launch's shape, for reports; nothing runs
    plan[0] = threads;
    plan[1] = static_cast<int>(smem);
    plan[2] = resident;
    plan[3] = s;
    plan[4] = dc;
    return cudaSuccess;
  }
  kernel<<<dim3(s, q), threads, smem, stream>>>(codes, starts, sizes, pscore, v, out,
                                                n_tokens, p, cap, pb, dim, dc);
  return cudaGetLastError();
}

template <int PROBE>
int dispatch(const void* codes, const void* starts, const void* sizes, const void* pscore,
             const void* v, void* out, int n_tokens, int q, int p, int cap, int pb, int dim,
             int nbits, void* stream, int* plan) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* ps = static_cast<const float*>(pscore);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec16 = score_rows::aligned16(codes, pb);
#define WARP_FUSED_LAUNCH(B, V) \
  launch<B, V, PROBE>(c, st, sz, ps, vv, o, n_tokens, q, p, cap, pb, dim, s, plan)
  switch (nbits * 2 + (vec16 ? 1 : 0)) {
    case 4: return WARP_FUSED_LAUNCH(2, false);
    case 5: return WARP_FUSED_LAUNCH(2, true);
    case 8: return WARP_FUSED_LAUNCH(4, false);
    case 9: return WARP_FUSED_LAUNCH(4, true);
    case 16: return WARP_FUSED_LAUNCH(8, false);
    case 17: return WARP_FUSED_LAUNCH(8, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WARP_FUSED_LAUNCH
}

}  // namespace

extern "C" int warp_fused_gather_score(const void* codes, const void* starts,
                                       const void* sizes, const void* pscore, const void* v,
                                       void* out, int n_tokens, int q, int p, int cap, int pb,
                                       int dim, int nbits, void* stream) {
  return dispatch<score_rows::kProbeFull>(codes, starts, sizes, pscore, v, out, n_tokens, q, p,
                                          cap, pb, dim, nbits, stream, nullptr);
}

// The kernel at a measurement carve-out: probe 1 dma, 2 compute
// (score_rows::Probe); the full kernel is warp_fused_gather_score.
extern "C" int warp_fused_gather_score_probe(const void* codes, const void* starts,
                                             const void* sizes, const void* pscore,
                                             const void* v, void* out, int n_tokens, int q,
                                             int p, int cap, int pb, int dim, int nbits,
                                             int probe, void* stream) {
  switch (probe) {
    case score_rows::kProbeDma:
      return dispatch<score_rows::kProbeDma>(codes, starts, sizes, pscore, v, out, n_tokens, q,
                                             p, cap, pb, dim, nbits, stream, nullptr);
    case score_rows::kProbeCompute:
      return dispatch<score_rows::kProbeCompute>(codes, starts, sizes, pscore, v, out, n_tokens,
                                                 q, p, cap, pb, dim, nbits, stream, nullptr);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch warp_fused_gather_score would make for these arguments,
// without making it: plan = {threads per block, dynamic shared memory per
// block, blocks resident on the card, blocks per query token, v-table dims
// per chunk}.
extern "C" int warp_fused_gather_score_plan(const void* codes, int q, int p, int cap, int pb,
                                            int dim, int nbits, int* plan) {
  return dispatch<score_rows::kProbeFull>(codes, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                                          q, p, cap, pb, dim, nbits, nullptr, plan);
}
