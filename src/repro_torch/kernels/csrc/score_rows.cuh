// Shared row-scoring machinery of the three WARP scoring kernels
// (selective sum, dense and ragged fused gather; sm_90a): one thread per
// packed code row, rows staged through a per-warp cp.async ring in shared
// memory, the v-table in shared memory whole or in chunks of dimensions.
//
// A token's packed code row holds D codes of b bits; dimension d lives in
// byte d / (8/b) at bit (d % (8/b)) * b. The row's score is
// sum_d v[d][code_d] with the query token's v-table (f32[D][2^b]) held in
// shared memory. v is a general table: nothing here assumes its rows are
// q_d * bucket_weights.
//
// Lookups without bank conflicts. Each lane scores its own row, and every
// lane of a warp walks the same dimensions in the same order (the trip
// counts depend on PB only), so at every unrolled step all 32 lanes are at
// one dimension d and read v_s[d * 2^b + code]: 2^b consecutive words. At
// b <= 4 those are at most 16 distinct words in 16 distinct banks
// ((d * 2^b + code) mod 32 differs for distinct codes) and lanes with equal
// codes read one word by broadcast: one wavefront per lookup instruction,
// the least there is. (A layout of 16 lanes per row, word w of the row on
// lane w, dims 8w + s, puts every lane at bank (16 s + code) mod 32: 32
// rows' codes in 16 banks, ~4.6 wavefronts per lookup at b = 4.) At b = 8 the 256 entries of a dimension cover every bank 8 times
// and 32 random codes need ~3.15 wavefronts per lookup (a count over random
// codes; chip_smoke.py prints it beside the nbits-8 timing): no layout of a
// 256-entry table serves 32 random lanes in one. At b <= 4 a lookup's
// address is one byte permute of pre-shifted codes (WordLookup): 3
// instructions a lookup. What is left is the lookups themselves, one LDS
// each, ~2 SM clocks per warp-wide LDS on the H100: at D 128 a lookup floor
// near the bytes bound.
//
// Rows in flight. A warp scores 32 rows per step (one "chunk"). Its lanes
// copy the chunk's rows into shared memory with 16-byte cp.async.cg, lane
// j taking 16-byte piece j % (PB / 16) of row j / (PB / 16), so the copies
// of one row are contiguous across lanes and coalesce whether the 32 rows
// are contiguous (selective sum) or scattered over clusters (fused gather).
// kStages chunks per warp are in flight while one is scored: at PB = 64,
// 8 warps a block and 3 blocks an SM, 48 chunks of 2 KiB, ~96 KiB in
// flight per SM. A row's shared-memory stride is PB rounded up to an odd
// number of 16-byte units, so the 16-byte reads of 8 lanes (one
// shared-memory wavefront of an LDS.128) land in 8 distinct 4-bank groups.
// Rows that are not 16-byte aligned (PB % 16 != 0 or an unaligned code
// pointer) take the same path with byte copies instead of cp.async.
//
// Wide v-tables. The whole table (D * 2^b floats: 128 KiB at D 128, b = 8)
// sits beside at least one warp's ring wherever it fits. Where it does not
// (b = 8 from D 208), score_range walks the dimensions in chunks of dc dims:
// each chunk's table slice is loaded in turn and the ring stages only the
// rows' bytes of those dims, so each code byte is still read once; the
// first chunk writes a row's partial sum and later ones add to it (the same
// thread owns a row in every chunk). dc is a multiple of 128 / b dims (16
// bytes of a row), so a 16-byte aligned row stays aligned slice by slice
// (dims_per_chunk; Python twin: _build.vtable_chunk).
//
// Measurement carve-outs (Probe, a template argument of score_range and
// of the fused kernels; the TPU kernels' `probe`). kProbeDma stages every
// row through the ring as the full loop does and reads each staged row
// into a sink (sink_staged: an XOR of its words) in place of the v-table
// lookups; kProbeCompute issues no copies (every row pointer handed to the
// ring is null) and scores whatever bytes the ring holds, which are valid
// codes whatever they are (the lookups mask them). kProbeFull is the
// product loop and compiles to the same code as before the probes existed.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace score_rows {

constexpr int kMaxWarps = 8;  // warps per block, fewer where shared memory is short
constexpr size_t kSmemMax = 232448;  // dynamic shared memory one block may use on sm_90
constexpr int kStages = 3;    // chunks of 32 rows per warp in the ring
constexpr int kChunk = 32;    // rows per chunk: one per lane
constexpr unsigned kFull = 0xffffffffu;

enum Probe : int { kProbeFull = 0, kProbeDma = 1, kProbeCompute = 2 };

// Shared-memory bytes per staged row: PB rounded up to an odd number of
// 16-byte units.
__host__ __device__ inline int row_stride(int pb) { return 16 * (((pb + 15) / 16) | 1); }

__host__ __device__ inline size_t ring_bytes(int warps, int pb) {
  return static_cast<size_t>(warps) * kStages * kChunk * row_stride(pb);
}

inline bool aligned16(const void* p, int pb) {
  return (pb % 16 == 0) && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Asynchronous copy of a query token's v-table (n floats) into shared
// memory, closed as one cp.async group on every thread: 16-byte pieces
// where the table sits on 16 bytes, else plain loads.
__device__ __forceinline__ void load_vtable(float* v_s, const float* __restrict__ v, int n) {
  if ((reinterpret_cast<uintptr_t>(v) & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) cp_async16(v_s + i, v + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) v_s[i] = __ldg(v + i);
  }
  cp_async_commit();
}

// Where the v-table starts: the first 256-byte boundary of the shared
// address space at or after `offset` bytes into the block's dynamic shared
// memory (the kernels reserve kVtableAlign bytes of slack for it).
constexpr int kVtableAlign = 256;
__device__ __forceinline__ float* vtable_at(uint8_t* smem, size_t offset) {
  const size_t s = __cvta_generic_to_shared(smem);
  const size_t a = (s + offset + kVtableAlign - 1) & ~static_cast<size_t>(kVtableAlign - 1);
  return reinterpret_cast<float*>(smem + (a - s));
}

// Sum over NDIMS consecutive dimensions whose codes are packed from bit 0
// of `bits` upward; vd points at the first one's 2^b table entries.
template <int NBITS, int NDIMS>
__device__ __forceinline__ float score_bits(uint32_t bits, const float* vd) {
  constexpr int NB = 1 << NBITS;
  constexpr uint32_t MASK = NB - 1;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NDIMS; ++s) acc += vd[s * NB + ((bits >> (s * NBITS)) & MASK)];
  return acc;
}

// One shared-memory load at a register address plus a constant offset.
template <int OFF>
__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(x) : "r"(addr), "n"(OFF));
  return x;
}

// One 32-bit word of codes at b <= 4, its table entries addressed by byte
// permutes. The table of the word's dims starts at `base`, a shared
// address whose low byte is 0, and entry (dim, code) lies at base +
// 4 * (2^b * dim + code). Spread once so that each byte j of c_t holds
// 4 * code of the word's dim (8/b) j + t, one PRMT then builds the full
// address (that byte below base's upper three) and the load adds the
// constant 4 * 2^b * dim: 3 instructions a lookup (PRMT, LDS, FADD)
// instead of 5 (shift, mask, add, LDS, FADD).
template <int NBITS>
struct WordLookup;

template <>
struct WordLookup<4> {
  static constexpr int kBytes = 512;  // table bytes of a word's 8 dims
  template <int J>
  __device__ __forceinline__ static float pair(uint32_t lo, uint32_t hi, uint32_t base) {
    return lds<128 * J>(__byte_perm(lo, base, 0x7650 | J)) +
           lds<128 * J + 64>(__byte_perm(hi, base, 0x7650 | J));
  }
  __device__ __forceinline__ static float word(uint32_t x, uint32_t base) {
    const uint32_t lo = (x << 2) & 0x3c3c3c3cu, hi = (x >> 2) & 0x3c3c3c3cu;
    return (pair<0>(lo, hi, base) + pair<1>(lo, hi, base)) +
           (pair<2>(lo, hi, base) + pair<3>(lo, hi, base));
  }
};

template <>
struct WordLookup<2> {
  static constexpr int kBytes = 256;  // table bytes of a word's 16 dims
  template <int J>
  __device__ __forceinline__ static float quad(const uint32_t* c, uint32_t base) {
    return (lds<64 * J>(__byte_perm(c[0], base, 0x7650 | J)) +
            lds<64 * J + 16>(__byte_perm(c[1], base, 0x7650 | J))) +
           (lds<64 * J + 32>(__byte_perm(c[2], base, 0x7650 | J)) +
            lds<64 * J + 48>(__byte_perm(c[3], base, 0x7650 | J)));
  }
  __device__ __forceinline__ static float word(uint32_t x, uint32_t base) {
    const uint32_t c[4] = {(x << 2) & 0x0c0c0c0cu, x & 0x0c0c0c0cu, (x >> 2) & 0x0c0c0c0cu,
                           (x >> 4) & 0x0c0c0c0cu};
    return (quad<0>(c, base) + quad<1>(c, base)) + (quad<2>(c, base) + quad<3>(c, base));
  }
};

// Score of the staged row at row_s (16-byte aligned, PB bytes) against
// the v-table at v_s (vtable_at: 256-byte aligned).
template <int NBITS>
__device__ __forceinline__ float score_staged(const uint8_t* row_s, int pb, const float* v_s) {
  constexpr int NB = 1 << NBITS;
  constexpr int PER_BYTE = 8 / NBITS;
  const uint4* r16 = reinterpret_cast<const uint4*>(row_s);
  const int full = pb >> 4;
  float acc0 = 0.f, acc1 = 0.f;
  if constexpr (NBITS <= 4) {
    constexpr int W = WordLookup<NBITS>::kBytes;
    uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(v_s));
    for (int k = 0; k < full; ++k, base += 4 * W) {
      const uint4 w = r16[k];
      acc0 += WordLookup<NBITS>::word(w.x, base);
      acc1 += WordLookup<NBITS>::word(w.y, base + W);
      acc0 += WordLookup<NBITS>::word(w.z, base + 2 * W);
      acc1 += WordLookup<NBITS>::word(w.w, base + 3 * W);
    }
  } else {
    constexpr int WORD = 4 * PER_BYTE * NB;  // table floats of one 32-bit word's dims
    const float* vk = v_s;
    for (int k = 0; k < full; ++k, vk += 4 * WORD) {
      const uint4 w = r16[k];
      acc0 += score_bits<NBITS, 4 * PER_BYTE>(w.x, vk);
      acc1 += score_bits<NBITS, 4 * PER_BYTE>(w.y, vk + WORD);
      acc0 += score_bits<NBITS, 4 * PER_BYTE>(w.z, vk + 2 * WORD);
      acc1 += score_bits<NBITS, 4 * PER_BYTE>(w.w, vk + 3 * WORD);
    }
  }
  for (int j = full << 4; j < pb; ++j) {
    acc0 += score_bits<NBITS, PER_BYTE>(row_s[j], v_s + j * PER_BYTE * NB);
  }
  return acc0 + acc1;
}

// The dma carve-out's stand-in for score_staged: every byte of the staged
// row read (16 bytes at a time where it can), folded into a float.
__device__ __forceinline__ float sink_staged(const uint8_t* row_s, int pb) {
  const uint4* r16 = reinterpret_cast<const uint4*>(row_s);
  const int full = pb >> 4;
  uint32_t x = 0;
  for (int k = 0; k < full; ++k) {
    const uint4 w = r16[k];
    x ^= w.x ^ w.y ^ w.z ^ w.w;
  }
  for (int j = full << 4; j < pb; ++j) x ^= row_s[j];
  return static_cast<float>((x ^ (x >> 16)) & 0xffffu);
}

// One warp's ring of kStages chunks. The block's rows are the flat range
// [lo, hi); warp w owns chunks w, w + nwarps, w + 2 nwarps, ... of 32
// rows each, lane l row l of each. Every lane calls issue/row/flat with
// the same chunk number (the loops around them are warp-uniform).
template <bool VEC16>
struct WarpRing {
  uint8_t* ring;  // this warp's kStages * 32 * stride bytes
  long long lo, hi;
  int n_mine;     // chunks this warp scores
  int warp, nwarps, lane, pb, stride;

  __device__ WarpRing(uint8_t* smem, long long lo_, long long hi_, int pb_)
      : lo(lo_), hi(hi_), pb(pb_), stride(row_stride(pb_)) {
    warp = threadIdx.x >> 5;
    nwarps = blockDim.x >> 5;
    lane = threadIdx.x & 31;
    ring = smem + static_cast<size_t>(warp) * kStages * kChunk * stride;
    const long long chunks = (hi - lo + kChunk - 1) / kChunk;
    n_mine = chunks > warp ? static_cast<int>((chunks - warp + nwarps - 1) / nwarps) : 0;
  }

  // Flat row of this lane in chunk i (>= hi: no row).
  __device__ long long flat(int i) const {
    return lo + (warp + static_cast<long long>(i) * nwarps) * kChunk + lane;
  }

  __device__ const uint8_t* row(int i) const {
    return ring + (i % kStages) * kChunk * stride + lane * stride;
  }

  // Start the copy of chunk i (nothing past the last) and close one
  // cp.async group either way, so that every lane counts groups alike.
  // row_of(f) gives flat row f's code row, or nullptr for an invalid row.
  template <class RowOf>
  __device__ void issue(int i, RowOf row_of) {
    if (i < n_mine) {
      const long long f = flat(i);
      const uint8_t* mine = f < hi ? row_of(f) : nullptr;
      uint8_t* dst = ring + (i % kStages) * kChunk * stride;
      // Piece j = lane + 32 t of the chunk is piece j % per of row j / per;
      // r and col are kept by increments (32 = q * per + rem).
      const int per = VEC16 ? pb >> 4 : pb;
      const int q = kChunk / per, rem = kChunk % per;
      int r = lane / per, col = lane % per;
      for (int j = lane; j < kChunk * per; j += kChunk) {  // same trip count on every lane
        const auto src = reinterpret_cast<const uint8_t*>(
            __shfl_sync(kFull, reinterpret_cast<unsigned long long>(mine), r));
        if (src != nullptr) {
          if (VEC16) {
            cp_async16(dst + r * stride + col * 16, src + col * 16);
          } else {
            dst[r * stride + col] = __ldg(src + col);
          }
        }
        r += q;
        col += rem;
        if (col >= per) {
          col -= per;
          ++r;
        }
      }
    }
    cp_async_commit();
  }

  // Score every chunk this warp owns. Call after issuing chunks 0 ..
  // kStages - 2 and after a barrier behind the v-table's arrival
  // (cp_async_wait<kStages - 1>, then __syncthreads).
  // store(f, score) is called for each flat row f < hi of the range.
  template <int NBITS, int PROBE, class RowOf, class Store>
  __device__ void run(const float* v_s, RowOf row_of, Store store) {
    for (int i = 0; i < n_mine; ++i) {
      issue(i + kStages - 1, row_of);
      cp_async_wait<kStages - 1>();  // chunk i has landed (this lane's copies)
      __syncwarp();                  // ... and every other lane's
      float s;
      if constexpr (PROBE == kProbeDma) {
        s = sink_staged(row(i), pb);
      } else {
        s = score_staged<NBITS>(row(i), pb, v_s);
      }
      const long long f = flat(i);
      if (f < hi) store(f, s);
      __syncwarp();  // chunk i's slot is refilled next iteration
    }
  }
};

// Largest p in [0, n) with key(p) <= x, for a non-decreasing key and
// key(0) <= x.
template <class Key>
__device__ __forceinline__ int last_at_most(int n, long long x, Key key) {
  int a = 0, b = n - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (key(m) <= x) {
      a = m;
    } else {
      b = m - 1;
    }
  }
  return a;
}

// Block-cooperative zero fill of a[0, n): 16-byte stores between a scalar
// head and tail.
__device__ __forceinline__ void zero_fill(float* a, long long n) {
  long long head = ((16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15) >> 2;
  if (head > n) head = n;
  for (long long t = threadIdx.x; t < head; t += blockDim.x) a[t] = 0.f;
  float4* b = reinterpret_cast<float4*>(a + head);
  const long long n4 = (n - head) >> 2;
  for (long long t = threadIdx.x; t < n4; t += blockDim.x) b[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long t = head + 4 * n4 + threadIdx.x; t < n; t += blockDim.x) a[t] = 0.f;
}

// In-place inclusive prefix sum of x[0, n) by warp 0 (a shuffle scan per 32
// entries); the caller puts barriers before and after.
__device__ __forceinline__ void warp0_prefix_sum(int* x, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    int y = i < n ? x[i] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(kFull, y, off);
      if (lane >= off) y += z;
    }
    if (i < n) x[i] = carry + y;
    carry += __shfl_sync(kFull, y, 31);
  }
}

// Score the block's flat rows [lo, hi) against one query token's v-table
// v_tok (f32[dim][2^b] in device memory), dc dims at a time (CHUNKED; else
// dc == dim and all of this folds to one pass). row_of(f) gives flat row
// f's code row (PB bytes) or nullptr for a row not to load. Each chunk:
// a barrier where shared memory was in use before (`after_other`, or a
// chunk before it), the table slice by cp.async (the first one skipped
// where the caller issued it already: `preloaded`), kStages - 1 chunks of
// rows issued, then `overlap()` on the first chunk only, then the ring.
// store(f, score, first) gets each row's partial sum over the chunk's dims,
// `first` on the first chunk. PROBE: a measurement carve-out (Probe); row_of
// and store see every row as in the full loop.
template <int NBITS, bool VEC16, bool CHUNKED, int PROBE, class RowOf, class Overlap, class Store>
__device__ __forceinline__ void score_range(uint8_t* smem, float* v_s, const float* v_tok,
                                            long long lo, long long hi, int pb, int dim,
                                            int dc, bool preloaded, bool after_other,
                                            RowOf row_of, Overlap overlap, Store store) {
  constexpr int NB = 1 << NBITS;
  const int n_chunks = CHUNKED ? (dim + dc - 1) / dc : 1;
  for (int k = 0; k < n_chunks; ++k) {
    const int d0 = CHUNKED ? k * dc : 0;
    const int nd = CHUNKED ? min(dc, dim - d0) : dim;
    const int b0 = d0 * NBITS / 8;
    if (k > 0 || after_other) __syncthreads();  // every warp is done with shared memory
    if (k > 0 || !preloaded) load_vtable(v_s, v_tok + static_cast<size_t>(d0) * NB, nd * NB);
    auto slice = [&](long long f) -> const uint8_t* {
      if constexpr (PROBE == kProbeCompute) {
        return nullptr;  // no copies
      } else {
        const uint8_t* r = row_of(f);
        return CHUNKED && r != nullptr ? r + b0 : r;
      }
    };
    WarpRing<VEC16> ring(smem, lo, hi, CHUNKED ? nd * NBITS / 8 : pb);
    for (int i = 0; i < kStages - 1; ++i) ring.issue(i, slice);
    if (k == 0) overlap();
    cp_async_wait<kStages - 1>();  // the table slice's group
    __syncthreads();
    ring.template run<NBITS, PROBE>(v_s, slice,
                                    [&](long long f, float s) { store(f, s, k == 0); });
  }
}

// The most warps per block (8, 4, 2, 1) whose ring fits beside `fixed`
// bytes of other shared memory; 0 if not even one warp's does.
inline int warps_that_fit(size_t fixed, int pb, size_t smem_max = kSmemMax) {
  for (int w = kMaxWarps; w >= 1; w >>= 1) {
    if (fixed + ring_bytes(w, pb) <= smem_max) return w;
  }
  return 0;
}

// Shared-memory bytes of a v-table slice of dc dims on its 256-byte
// boundary (the slack included).
inline size_t vtable_bytes(int dc, int nbits) {
  return kVtableAlign + static_cast<size_t>(dc) * (1 << nbits) * sizeof(float);
}

// Dimensions per v-table chunk (see "Wide v-tables" above): all D where
// the whole table, `other` bytes and one warp's ring of whole rows fit one
// block; else the fewest chunks of whole 128 / b-dim units that fit, each
// chunk but the last dc dims; 0 where not even one unit fits (`other` too
// large). Python twin: _build.vtable_chunk.
inline int dims_per_chunk(int dim, int nbits, size_t other) {
  auto fits = [&](int dc) {
    return other + vtable_bytes(dc, nbits) + ring_bytes(1, dc * nbits / 8) <= kSmemMax;
  };
  if (fits(dim)) return dim;
  const int unit = 128 / nbits;
  for (int n = 2;; ++n) {
    const int dc = ((dim + n - 1) / n + unit - 1) / unit * unit;
    if (fits(dc)) return dc;
    if (dc <= unit) return 0;
  }
}

// Blocks of `kernel` resident on the whole card at this block size and
// shared memory: the SM count times blocks per SM. Cached per kernel,
// device, block size and shared-memory size.
inline int resident_blocks(const void* kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static thread_local Entry cache[8] = {};
  static thread_local int next = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (const Entry& e : cache) {
    if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == smem) {
      return e.blocks;
    }
  }
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  cache[next] = Entry{kernel, dev, threads, smem, blocks};
  next = (next + 1) % 8;
  return blocks;
}

// Blocks per query token: as many as fill the card in one wave, at least 1
// (Python twin: ref.score_blocks_per_token).
inline int blocks_per_token(int n_q, int resident) {
  const int s = resident / (n_q > 0 ? n_q : 1);
  return s > 0 ? s : 1;
}

// Above 48 KiB a block's dynamic shared memory must be opted into.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace score_rows

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
