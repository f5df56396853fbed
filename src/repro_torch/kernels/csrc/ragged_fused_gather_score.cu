// Fused gather + selective sum over a ragged tile worklist
// (gather="fused", layout="ragged" — the serving path; gather="materialize"
// passes the gathered copy of the worklist's rows with row0 = w * tile_c).
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
// Design. Rows are scored as in the other two kernels (score_rows.cuh: one
// thread per row, conflict-free lookups, a cp.async ring of 3 chunks of 32
// rows per warp; the v-table in chunks of dimensions where it is too wide
// for one block). The grid is S blocks, S from the blocks the card holds at
// once (ragged_blocks); block s takes the equal contiguous tile range
// [W*s/S, W*(s+1)/S) (at most kMaxTiles tiles). In one round trip it loads
// its tiles' nvalid, row0, qtok and pscore into shared memory, counts a
// tile's valid slots m = min(max(nvalid, 0), tile_c) (0 where qtok lies
// outside [0, Q)) and prefix-sums them: its valid rows are flat rows
// 0 .. T - 1, flat row f in the tile t with pre[t] <= f < pre[t + 1], slot
// f - pre[t]. A chunk of 32 rows may span tiles. Tiles are query-token-
// major, so a block's range almost always lies within one token: the block
// walks runs of tiles of one qtok (tiles without valid rows join any run)
// and loads each run's v-table once, by cp.async beside the run's first
// chunks of rows. The invalid slots and padding tiles are zeroed with
// 16-byte stores while the first rows load. Python twin of the split, the
// runs and the flat -> (tile, slot) map: ref.ragged_split. Rows outside
// [0, n_tokens), which a well-formed worklist never yields, are not loaded
// and their slots are 0.
//
// Segmented entry (warp_segmented_ragged_fused_gather_score): one launch
// over a worklist that spans a base index and its delta segments, each
// segment's codes in an allocation of its own. Replaces the JAX op
// repro/kernels/ops.py, segmented_ragged_fused_gather_selective_sum, which
// runs the Pallas kernel once per segment with every other segment's
// tiles masked to nvalid = 0 and adds the outputs. Tile w's rows are
// segment seg[w]'s: in the round trip that loads its tiles a block also
// reads each tile's segment code base and row count from a device table
// (int64[2 S]: S base addresses, then S row counts) into shared memory,
// and the per-row pointer lookup reads them there instead of one array
// and n_tokens; rows outside [0, rows of the segment) and tiles of a
// segment outside [0, S) are not loaded and their slots are 0. Everything
// else (the split, the runs, the v-table chunks: dims per chunk as the
// single-array kernel's) is the single-array kernel's, so every slot's
// sum runs in the same order as there and the output equals the S masked
// launches' sum bit for bit. Bound: bytes, as above (seg adds 4 bytes a
// tile).
//
// Measurement carve-outs (warp_ragged_fused_gather_score_probe; the TPU
// kernel's `probe`): the single-array kernel instantiated at PROBE =
// score_rows::kProbeDma (rows staged, not scored) or kProbeCompute (rows
// scored, not staged), on the same grid; both zero the invalid slots and
// padding tiles. The segmented entry has no carve-out.
#include "score_rows.cuh"

namespace {

using score_rows::last_at_most;

constexpr int kMaxTiles = 128;  // tiles per block at most: bounds its shared memory

// Bytes of a block's tile arrays: pre [kMaxTiles + 1], row0, qtok, pscore.
constexpr size_t kTileBytes = (4 * static_cast<size_t>(kMaxTiles) + 1) * sizeof(int);
// A segmented block's further tile arrays: code base and row count of each
// tile's segment (8 bytes to align the bases).
constexpr size_t kSegTileBytes = kMaxTiles * (sizeof(const uint8_t*) + sizeof(int)) + 8;

// Blocks of the launch: one per kTilesPerBlock tiles, but no fewer than the
// card holds at once (one wave) and no more than kOversubscribe times that;
// at least enough that no block takes more than kMaxTiles tiles, at most
// one per tile (Python twin: ref.ragged_blocks). Past one wave the card's
// block scheduler gives the slots that ranges of padding tiles free at once
// to further blocks: two waves measured faster where one would give a block
// ~83 tiles, slower where it gives ~21 (scripts/bench_ragged_split.py).
constexpr int kTilesPerBlock = 32;
constexpr int kOversubscribe = 2;

inline int ragged_blocks(int n_tiles, int resident) {
  const int most = kOversubscribe * resident;
  const int need = (n_tiles + kMaxTiles - 1) / kMaxTiles;
  int s = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  s = s < resident ? resident : (s > most ? most : s);
  s = s < need ? need : s;
  s = s > n_tiles ? n_tiles : s;
  return s > 0 ? s : 1;
}

// The segments of a segmented launch: seg i32[W] and the device table
// int64[2 S] (code base addresses, then row counts).
struct Segments {
  const int* seg;
  const long long* table;
  int n;
};

template <int NBITS, bool VEC16, bool CHUNKED, bool SEGMENTED, int PROBE>
__global__ void __launch_bounds__(score_rows::kMaxWarps * 32)
    ragged_fused_gather_score_kernel(const uint8_t* __restrict__ codes,
                                     const int* __restrict__ row0,
                                     const int* __restrict__ nvalid,
                                     const int* __restrict__ qtok,
                                     const float* __restrict__ pscore,
                                     const float* __restrict__ v, float* __restrict__ out,
                                     int n_tokens, int n_tiles, int tile_c, int n_q, int pb,
                                     int dim, int dc, Segments segs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nb = 1 << NBITS;
  const int warps = blockDim.x >> 5;
  const long long t0 = static_cast<long long>(n_tiles) * blockIdx.x / gridDim.x;
  const int nt =
      static_cast<int>(static_cast<long long>(n_tiles) * (blockIdx.x + 1) / gridDim.x - t0);
  float* v_s = score_rows::vtable_at(smem, score_rows::ring_bytes(warps, dc * NBITS / 8));
  int* pre = reinterpret_cast<int*>(v_s + dc * nb);  // [nt + 1]
  int* r0 = pre + kMaxTiles + 1;                        // [nt]
  int* qt = r0 + kMaxTiles;                             // [nt]
  float* ps = reinterpret_cast<float*>(qt + kMaxTiles); // [nt]
  const uint8_t** sg_base = nullptr;                    // [nt] (segmented)
  int* sg_rows = nullptr;                               // [nt] (segmented)
  if constexpr (SEGMENTED) {
    const uintptr_t at = (reinterpret_cast<uintptr_t>(ps + kMaxTiles) + 7) & ~uintptr_t{7};
    sg_base = reinterpret_cast<const uint8_t**>(at);
    sg_rows = reinterpret_cast<int*>(sg_base + kMaxTiles);
  }
  float* o = out + t0 * tile_c;

  // The block's tiles, in one round trip.
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const long long w = t0 + t;
    const int q = qtok[w];
    pre[t + 1] = q >= 0 && q < n_q ? min(max(nvalid[w], 0), tile_c) : 0;
    r0[t] = row0[w];
    qt[t] = q;
    ps[t] = pscore[w];
    if constexpr (SEGMENTED) {
      const int s = segs.seg[w];
      const bool known = s >= 0 && s < segs.n;
      sg_base[t] = known ? reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(segs.table[s]))
                         : nullptr;
      sg_rows[t] = known ? static_cast<int>(segs.table[segs.n + s]) : 0;
    }
  }
  if (threadIdx.x == 0) pre[0] = 0;
  __syncthreads();
  score_rows::warp0_prefix_sum(pre + 1, nt);
  __syncthreads();

  // Invalid slots, padding tiles merged with the tail before them.
  auto zero_invalid = [&] {
    for (int t = 0; t < nt;) {
      const int m = pre[t + 1] - pre[t];
      int e = t + 1;
      if (m < tile_c) {
        while (e < nt && pre[e + 1] == pre[e]) ++e;
        score_rows::zero_fill(o + static_cast<size_t>(t) * tile_c + m,
                              static_cast<long long>(e - t) * tile_c - m);
      }
      t = e;
    }
  };
  auto tile_of = [&](long long f) {
    return last_at_most(nt, f, [&](int t) { return static_cast<long long>(pre[t]); });
  };
  // Code row of slot c of tile t, or nullptr for a row not to load.
  auto code_row = [&](int t, long long c) -> const uint8_t* {
    const long long row = static_cast<long long>(r0[t]) + c;
    if constexpr (SEGMENTED) {
      return row >= 0 && row < sg_rows[t] ? sg_base[t] + static_cast<size_t>(row) * pb : nullptr;
    } else {
      return row >= 0 && row < n_tokens ? codes + static_cast<size_t>(row) * pb : nullptr;
    }
  };
  auto row_of = [&](long long f) -> const uint8_t* {
    const int t = tile_of(f);
    return code_row(t, f - pre[t]);
  };
  auto store = [&](long long f, float score, bool first) {
    const int t = tile_of(f);
    const long long c = f - pre[t];
    float* slot = o + static_cast<size_t>(t) * tile_c + c;
    if (code_row(t, c) != nullptr) {
      *slot = first ? score + ps[t] : *slot + score;
    } else if (first) {
      *slot = 0.f;
    }
  };

  // Runs of one query token over the tiles with valid rows; every thread
  // walks the same shared arrays, so the loop and its barriers are uniform.
  bool scored = false;
  for (int ta = 0;;) {
    while (ta < nt && pre[ta + 1] == pre[ta]) ++ta;
    if (ta == nt) break;
    const int q = qt[ta];
    int tb = ta + 1;
    while (tb < nt && (pre[tb + 1] == pre[tb] || qt[tb] == q)) ++tb;
    score_rows::score_range<NBITS, VEC16, CHUNKED, PROBE>(
        smem, v_s, v + static_cast<size_t>(q) * dim * nb, pre[ta], pre[tb], pb, dim, dc,
        false, scored, row_of,
        [&] {
          if (!scored) zero_invalid();
        },
        store);
    scored = true;
    ta = tb;
  }
  if (!scored) zero_invalid();
}

template <int NBITS, bool VEC16, bool SEGMENTED, int PROBE>
cudaError_t launch(const uint8_t* codes, const int* row0, const int* nvalid, const int* qtok,
                   const float* pscore, const float* v, float* out, int n_tokens, int n_tiles,
                   int tile_c, int n_q, int pb, int dim, Segments segs, cudaStream_t stream,
                   int* plan) {
  const int dc = score_rows::dims_per_chunk(dim, NBITS, kTileBytes);
  if (dc == 0) return cudaErrorInvalidValue;
  const size_t fixed =
      kTileBytes + (SEGMENTED ? kSegTileBytes : 0) + score_rows::vtable_bytes(dc, NBITS);
  const int warps = score_rows::warps_that_fit(fixed, dc * NBITS / 8);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = score_rows::ring_bytes(warps, dc * NBITS / 8) + fixed;
  auto kernel = ragged_fused_gather_score_kernel<NBITS, VEC16, false, SEGMENTED, PROBE>;
  if (dc < dim) kernel = ragged_fused_gather_score_kernel<NBITS, VEC16, true, SEGMENTED, PROBE>;
  cudaError_t err = score_rows::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = warps * 32;
  const int resident =
      score_rows::resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem);
  const int s = ragged_blocks(n_tiles, resident);
  if (plan != nullptr) {  // the launch's shape, for reports; nothing runs
    plan[0] = threads;
    plan[1] = static_cast<int>(smem);
    plan[2] = resident;
    plan[3] = s;
    plan[4] = (n_tiles + s - 1) / s;
    plan[5] = dc;
    return cudaSuccess;
  }
  kernel<<<s, threads, smem, stream>>>(codes, row0, nvalid, qtok, pscore, v, out, n_tokens,
                                       n_tiles, tile_c, n_q, pb, dim, dc, segs);
  return cudaGetLastError();
}

template <bool SEGMENTED, int PROBE>
int dispatch(const void* codes, const void* row0, const void* nvalid, const void* qtok,
             const void* pscore, const void* v, void* out, int n_tokens, int n_tiles,
             int tile_c, int n_q, int pb, int dim, int nbits, bool vec16, Segments segs,
             void* stream, int* plan) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* r = static_cast<const int*>(row0);
  const auto* nv = static_cast<const int*>(nvalid);
  const auto* qt = static_cast<const int*>(qtok);
  const auto* ps = static_cast<const float*>(pscore);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define WARP_RAGGED_LAUNCH(B, V)                                                                \
  launch<B, V, SEGMENTED, PROBE>(c, r, nv, qt, ps, vv, o, n_tokens, n_tiles, tile_c, n_q, pb,    \
                                 dim, segs, s, plan)
  switch (nbits * 2 + (vec16 ? 1 : 0)) {
    case 4:
      return WARP_RAGGED_LAUNCH(2, false);
    case 5:
      return WARP_RAGGED_LAUNCH(2, true);
    case 8:
      return WARP_RAGGED_LAUNCH(4, false);
    case 9:
      return WARP_RAGGED_LAUNCH(4, true);
    case 16:
      return WARP_RAGGED_LAUNCH(8, false);
    case 17:
      return WARP_RAGGED_LAUNCH(8, true);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WARP_RAGGED_LAUNCH
}

}  // namespace

extern "C" int warp_ragged_fused_gather_score(const void* codes, const void* row0,
                                              const void* nvalid, const void* qtok,
                                              const void* pscore, const void* v, void* out,
                                              int n_tokens, int n_tiles, int tile_c, int n_q,
                                              int pb, int dim, int nbits, void* stream) {
  return dispatch<false, score_rows::kProbeFull>(
      codes, row0, nvalid, qtok, pscore, v, out, n_tokens, n_tiles, tile_c, n_q, pb, dim, nbits,
      score_rows::aligned16(codes, pb), Segments{nullptr, nullptr, 0}, stream, nullptr);
}

// The single-array kernel at a measurement carve-out: probe 1 dma, 2
// compute (score_rows::Probe); the full kernel is
// warp_ragged_fused_gather_score.
extern "C" int warp_ragged_fused_gather_score_probe(const void* codes, const void* row0,
                                                    const void* nvalid, const void* qtok,
                                                    const void* pscore, const void* v, void* out,
                                                    int n_tokens, int n_tiles, int tile_c,
                                                    int n_q, int pb, int dim, int nbits,
                                                    int probe, void* stream) {
  const bool vec16 = score_rows::aligned16(codes, pb);
  const Segments none{nullptr, nullptr, 0};
  switch (probe) {
    case score_rows::kProbeDma:
      return dispatch<false, score_rows::kProbeDma>(codes, row0, nvalid, qtok, pscore, v, out,
                                                    n_tokens, n_tiles, tile_c, n_q, pb, dim,
                                                    nbits, vec16, none, stream, nullptr);
    case score_rows::kProbeCompute:
      return dispatch<false, score_rows::kProbeCompute>(codes, row0, nvalid, qtok, pscore, v,
                                                        out, n_tokens, n_tiles, tile_c, n_q, pb,
                                                        dim, nbits, vec16, none, stream, nullptr);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch over a worklist spanning segments: seg i32[W] names tile w's
// segment, seg_table int64[2 n_seg] on the device holds the segments' code
// base addresses, then their row counts; row0 is segment-local.
// all_aligned16: every segment's codes start on 16 bytes (the wrapper
// knows the addresses; the table is on the device).
extern "C" int warp_segmented_ragged_fused_gather_score(
    const void* row0, const void* nvalid, const void* seg, const void* qtok, const void* pscore,
    const void* v, void* out, const void* seg_table, int n_seg, int all_aligned16, int n_tiles,
    int tile_c, int n_q, int pb, int dim, int nbits, void* stream) {
  const Segments segs{static_cast<const int*>(seg), static_cast<const long long*>(seg_table),
                      n_seg};
  return dispatch<true, score_rows::kProbeFull>(nullptr, row0, nvalid, qtok, pscore, v, out, 0,
                                                n_tiles, tile_c, n_q, pb, dim, nbits,
                                                all_aligned16 != 0 && pb % 16 == 0, segs, stream,
                                                nullptr);
}

// The launch warp_ragged_fused_gather_score would make for these
// arguments, without making it: plan = {threads per block, dynamic shared
// memory per block, blocks resident on the card, blocks of the launch,
// tiles per block at most, v-table dims per chunk}.
extern "C" int warp_ragged_fused_gather_score_plan(const void* codes, int n_tiles, int pb,
                                                   int dim, int nbits, int* plan) {
  return dispatch<false, score_rows::kProbeFull>(
      codes, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, n_tiles, 8, 1, pb, dim, nbits,
      score_rows::aligned16(codes, pb), Segments{nullptr, nullptr, 0}, nullptr, plan);
}
