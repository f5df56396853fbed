// Flash-attention forward: causal and/or sliding-window, GQA by head index.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_kernel_call
// (Pallas body _flash_fwd_kernel). For q [B, H, Sq, Dh] and k, v
// [B, Hkv, Skv, Dh] (Hkv | H; query head h reads kv head h / (H / Hkv)):
//   s = (q . k) / sqrt(Dh) in float32, masked to -1e30 where
//   rel = q_pos - k_pos breaks rel >= 0 (causal) or rel < window,
//   out = softmax(s) . v in float32, written in the input dtype.
// Positions are the absolute row indices of the (padded) arrays.
//
// Bound on the H100: operations at the shapes of a prefill. At qwen2-0.5b
// width (B 4, H 14, Hkv 2, S 2048, Dh 64, bf16) the causal half costs
// 4*B*H*S*S*Dh/2 = 30.1 GFLOP (30 us at the 989 TFLOP/s bf16 tensor-core
// peak) against 33.6 MB of q, k, v and out (10 us at 3.35 TB/s). The
// softmax is a second bound of the same size: the causal half takes
// B*H*S*S/2 = 117M exponentials, and the SFU issues 16 ex2 per SM per
// clock (about 4.2e12/s on 132 SMs at ~1.98 GHz), about 28 us.
//
// Two paths, one per dtype. bf16 inputs run on Hopper's tensor cores
// (flash_fwd_wgmma_kernel, below); float32 inputs run the FMA kernel
// described next.
//
// Design. One block of 256 threads per (q-block of 64 rows, head, batch).
// It stages its q-block once in shared memory and streams k/v tiles of 64
// keys through it; each thread owns 4 rows x 4 keys of the score tile and
// 4 rows x Dh/16 columns of the output, keeping the running (max, sum,
// acc) of its rows in float32 registers: the TPU kernel's sequential KV
// grid axis becomes this loop. Every product and sum is float32 FMA.
//
// Masks. Masked scores are -1e30, as on the TPU: a row whose tiles are all
// masked gets the mean of v over all keys, never 0/0 or inf - inf. A row's
// weights on masked keys become exp(-1e30 - m) = 0 once it has seen a valid
// key, so when every real row sees its diagonal (Sq <= Skv, window >= 1)
// the block skips kv tiles the causal or window mask hides from all its
// rows: the result is the same. Keys past Skv do not exist (weight 0).
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16 threads: ty -> 4 rows, tx -> 4 keys
constexpr int kQP = kBQ + 4;    // padded pitch of the transposed q tile
constexpr int kKP = kBK + 4;    // padded pitch of the transposed k tile
constexpr int kPP = kBQ + 4;    // padded pitch of the transposed p tile
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;    // element strides of q (batch, head, row)
  int64_t kv_sb, kv_sh, kv_ss; // of k and v (identical)
  int64_t o_sb, o_sh, o_ss;    // of out
  int b, h, hkv, sq, skv;
  int causal, window;          // window < 0: none
  int skip;                    // 1: every real row sees its diagonal
  float scale;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (DH * kQP + DH * kKP + kBK * DH + kBK * kPP);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;               // [DH][kQP]  q tile, transposed
  float* k_t = q_t + DH * kQP;     // [DH][kKP]  k tile, transposed
  float* v_s = k_t + DH * kKP;     // [kBK][DH]  v tile
  float* p_t = v_s + kBK * DH;     // [kBK][kPP] probabilities, transposed
  constexpr int kCols = DH / 16;   // output columns per thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.hkv);
  const float* qg = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bb * p.kv_sb + hk * p.kv_sh;
  const float* vg = static_cast<const float*>(p.v) + bb * p.kv_sb + hk * p.kv_sh;
  float* og = static_cast<float*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_t[d * kQP + r] = q0 + r < p.sq ? qg[(q0 + r) * p.q_ss + d] : 0.f;
  }

  // kv tiles this block visits.
  int t_lo = 0, t_hi = (p.skv - 1) / kBK;
  if (p.skip) {
    const int q_last = min(q0 + kBQ, p.sq) - 1;
    if (p.window >= 0) t_lo = max(0, q0 - p.window + 1) / kBK;
    if (p.causal) t_hi = min(t_hi, q_last / kBK);
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k/v/p are consumed
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const bool in = k0 + c < p.skv;
      const int64_t off = static_cast<int64_t>(k0 + c) * p.kv_ss + d;
      k_t[d * kKP + c] = in ? kg[off] : 0.f;
      v_s[c * DH + d] = in ? vg[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kQP + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(k_t + d * kKP + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        const int rel = r - c;
        const bool masked = (p.causal && rel < 0) || (p.window >= 0 && rel >= p.window);
        s[i][j] = c >= p.skv ? -INFINITY : masked ? kMasked : s[i][j] * p.scale;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // Every tile holds a key below Skv, so tmax >= -1e30 and m_new is finite.
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rsum += e;
        p_t[(tx * 4 + j) * kPP + ty * 4 + i] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(p_t + c * kPP + ty * 4);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int jj = 0; jj < DH / 64; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + c * DH + jj * 64 + tx * 4);
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][jj * 4 + j] = fmaf(pv[i], vw[j], acc[i][jj * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = og + static_cast<int64_t>(r) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < DH / 64; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) orow[jj * 64 + tx * 4 + j] = acc[i][jj * 4 + j] * inv;
  }
}


// ---------------------------------------------------------------------------
// bf16 inputs: wgmma on both products, k/v through a TMA ring.
//
// A block owns 128 query rows of one (batch, head) and runs three
// warpgroups. Warpgroup 0 is the producer: one thread loads the block's q
// tile once, then streams the k and v tiles it visits through a ring of
// kStages stages in shared memory with TMA (cp.async.bulk.tensor; one 4-D
// tensor map per operand over (Dh, S, H, B), built on the host at each
// call from the caller's strides), each arrival signalled on an mbarrier;
// rows past Sq or Skv arrive as zeros. TMA is the only copy mechanism.
// Warpgroups 1 and 2 consume, 64 query rows each:
//   - S = q.k^T is a chain of wgmma with both operands in shared memory
//     (K-major, 128-byte swizzle, as TMA wrote them: a Dh-64 bf16 row is
//     one 128-byte atom, a Dh-128 row two);
//   - the online softmax runs on the float32 accumulator in registers;
//   - O += P.V is a chain of wgmma with P in registers (the score
//     accumulator's layout is the A-fragment layout, so P never goes
//     through shared memory) and V read MN-major from the ring.
// setmaxnreg hands the producer's registers (down to 24) to the consumers
// (up to 240).
//
// Precision: q.k in float32. P enters the p.v product as two bf16 terms
// p_hi + p_lo (p_lo the rounding error of p_hi), two wgmma into one
// accumulator, so p keeps about 16 bits and the output stays within ~1e-5
// of float32; that costs 1.5x the tensor work of a single bf16 p.
//
// Softmax in base 2: scores are scaled by log2(e)/sqrt(Dh) in one multiply
// and exponentiated with ex2.approx; masked scores are -1e30 as on the TPU
// (keys past Skv -inf). The mask is applied only on the kv tiles where a
// row of the block can meet a hidden key (tile_range): the window's edge,
// the diagonal, and the last tile when Skv is not a multiple of the tile.
// Interior tiles skip the test. Blocks start heaviest first: under the
// causal mask the last q-blocks, which visit the most tiles, take the
// lowest block indices. ref.flash_schedule is the Python twin of
// tile_range and of the block order.
constexpr int kWBQ = 128;              // query rows per block: two consumer warpgroups
constexpr int kWThreads = 3 * 128;     // producer warpgroup + two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH> struct WTile;       // keys per kv tile and ring stages by head size
template <> struct WTile<64> { static constexpr int kBK = 128, kStages = 2; };
template <> struct WTile<128> { static constexpr int kBK = 64, kStages = 2; };

template <int DH>
constexpr size_t wgmma_smem_bytes() {  // 1024 bytes of alignment slack, q, the ring, the barriers
  return 1024 + 2 * DH * (kWBQ + 2 * WTile<DH>::kStages * WTile<DH>::kBK) + 8 * (1 + 3 * WTile<DH>::kStages);
}

// The kv tiles [t_lo, t_hi] the q-block of rows [q0, q0 + bq) visits, and
// those that need the mask: t < m_lo (a key the window hides from some of
// its rows) and t >= m_hi (a key after some row under the causal mask, or
// at or past Skv). Python twin: ref.flash_schedule.
struct TileRange {
  int t_lo, t_hi, m_lo, m_hi;
};

__device__ __forceinline__ TileRange tile_range(const Params& p, int q0, int bq, int bk) {
  const int q_last = min(q0 + bq, p.sq) - 1, nt = (p.skv + bk - 1) / bk;
  TileRange r{0, nt - 1, 0, p.skv % bk ? p.skv / bk : nt};
  if (p.skip) {
    if (p.window >= 0) r.t_lo = max(0, q0 - p.window + 1) / bk;
    if (p.causal) r.t_hi = min(r.t_hi, q_last / bk);
  }
  if (p.window >= 0 && q_last >= p.window) r.m_lo = (q_last - p.window) / bk + 1;
  if (p.causal) r.m_hi = min(r.m_hi, (q0 + 1) / bk);
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity completes. A wait that
// cannot end (a fault in the ring's bookkeeping) traps after about ten
// seconds, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// Copies the box at coordinates (c0, c1, c2, c3) of a tensor map into
// shared memory at dst and signals the bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from reading an accumulator before the wait that
// completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a shared-memory tile written by TMA with the 128-byte
// swizzle: 1024-byte aligned atoms of 8 rows x 128 bytes. sbo: bytes
// between 8-row groups; lbo: between 64-column atoms of an MN-major
// operand (unused for K-major ones).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Accumulator layout of a warpgroup's [64 x N] float32 tile: warp w holds
// rows 16w + lane/4 and 16w + lane/4 + 8; d[4j + e] is column
// 8j + 2(lane % 4) + e % 2 of the first row (e < 2) or of the second.

// d[64 x 64] (+)= a . b, a [64 x 16] and b [16 x 64] both read from shared memory
// (K-major, descriptors da and db); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= a . b, as wgmma_ss_n64.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += a . b, a [64 x 16] bf16 in registers (four .b32 per thread,
// the accumulator layout of one 16-column step of a score tile), b [16 x 64]
// read MN-major from shared memory (descriptor db).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d[64 x 128] += a . b, as wgmma_rs_n64.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values as bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int DH>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, Params p) {
  constexpr int kBK = WTile<DH>::kBK, kStages = WTile<DH>::kStages;
  constexpr int kAtoms = DH / 64;  // 128-byte (64-column) atoms of a row
  constexpr uint32_t kQAtom = kWBQ * 128, kKVAtom = kBK * 128;  // bytes of one atom column of a tile
  constexpr uint32_t kQBytes = kAtoms * kQAtom, kKVBytes = kAtoms * kKVAtom;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // atoms on 1024 bytes
  const uint32_t k_s = q_s + kQBytes;                          // stage st at + st * kKVBytes
  const uint32_t v_s = k_s + kStages * kKVBytes;
  const uint32_t q_full = v_s + kStages * kKVBytes;            // then k_full, v_full, empty per stage
  const auto k_full = [=](int st) { return q_full + 8 * (1 + st); };
  const auto v_full = [=](int st) { return q_full + 8 * (1 + kStages + st); };
  const auto empty = [=](int st) { return q_full + 8 * (1 + 2 * kStages + st); };

  // q-block-major order, heaviest first: under the causal mask the last
  // q-blocks visit the most tiles; otherwise the first ones do.
  const int heads = p.h * p.b, n_qb = (p.sq + kWBQ - 1) / kWBQ;
  const int i = blockIdx.x / heads, hh = blockIdx.x % heads % p.h, bb = blockIdx.x % heads / p.h;
  const int q0 = (p.causal ? n_qb - 1 - i : i) * kWBQ, hk = hh / (p.h / p.hkv);
  const TileRange tr = tile_range(p, q0, kWBQ, kBK);
  const int n_tiles = tr.t_hi - tr.t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int a = 0; a < kAtoms; ++a) tma_load(q_s + a * kQAtom, tm_q, q_full, a * 64, q0, hh, bb);
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int k0 = (tr.t_lo + it) * kBK;
        mbar_wait(empty(st), phase ^ 1);  // the first round finds every stage free
        mbar_expect_tx(k_full(st), kKVBytes);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(k_s + st * kKVBytes + a * kKVAtom, tm_k, k_full(st), a * 64, k0, hk, bb);
        mbar_expect_tx(v_full(st), kKVBytes);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(v_s + st * kKVBytes + a * kKVAtom, tm_v, v_full(st), a * 64, k0, hk, bb);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col = 2 * (lane % 4);                       // and columns 8j + col, + 1
    const float c = p.scale * kLog2e;
    const uint32_t q_wg = q_s + cw * 64 * 128;            // this warpgroup's 64 rows of q

    float s[kBK / 2], o[DH / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) s[j] = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share of its rows

    mbar_wait(q_full, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int t = tr.t_lo + it, k0 = t * kBK;
      const uint32_t k_st = k_s + st * kKVBytes, v_st = v_s + st * kKVBytes;

      mbar_wait(k_full(st), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // 16 columns of Dh a step: 32 bytes into an atom
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBK>(s, sw128_desc(q_wg + (kk / 4) * kQAtom + off, 16, 1024),
                      sw128_desc(k_st + (kk / 4) * kKVAtom + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (t < tr.m_lo || t >= tr.m_hi) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + col + (e & 1), rel = row0 + 8 * (e >> 1) - key;
            const bool masked = (p.causal && rel < 0) || (p.window >= 0 && rel >= p.window);
            float& x = s[4 * j + e];
            x = key >= p.skv ? -INFINITY : masked ? kMasked : x * c;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) s[j] *= c;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = ex2(m[r] - mx);  // 0 on the first tile; mx >= -1e30: the tile holds a key < Skv
        m[r] = mx;
        l[r] *= alpha[r];
      }
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        s[j] = ex2(s[j] - m[(j >> 1) & 1]);
        l[(j >> 1) & 1] += s[j];
      }
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
        for (int f = 0; f < 4; ++f) split_bf16(s[8 * ks + 2 * f], s[8 * ks + 2 * f + 1], hi[ks][f], lo[ks][f]);
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

      mbar_wait(v_full(st), phase);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {  // 16 keys a step: two 8-row groups of V
        const uint64_t db = sw128_desc(v_st + ks * 16 * 128, kKVAtom, 1024);
        wgmma_rs<DH>(o, hi[ks], db);
        wgmma_rs<DH>(o, lo[ks], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }

    auto* og = static_cast<__nv_bfloat16*>(p.o) + bb * p.o_sb + hh * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= p.sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = og + static_cast<int64_t>(row) * p.o_ss + col;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, b);
  flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_dh(const Params& p, int b, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch<64>(p, b, stream);
    case 128: return launch<128>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library keeps its plain C interface and links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                       : nullptr;
  }();
  return fn;
}

// A 4-D tensor map over (Dh, S, H, B) of a bf16 tensor with element
// strides (sb, sh, ss) and a contiguous Dh, read in boxes of 64 columns x
// `rows` rows with the 128-byte swizzle; coordinates past S read as 0.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int dh, int s, int h, int b, int64_t sb, int64_t sh,
                       int64_t ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Once per head size: the kernel's shared memory, and a check that it was
// launched with the registers setmaxnreg redistributes (it would wait
// forever for registers the block does not hold).
template <int DH>
cudaError_t prepare_wgmma() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_kernel<DH>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kWThreads < 128 * kProducerRegs + 256 * kConsumerRegs) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(wgmma_smem_bytes<DH>()));
}

template <int DH>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  static const cudaError_t ready = prepare_wgmma<DH>();
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map(&mq, p.q, DH, p.sq, p.h, p.b, p.q_sb, p.q_sh, p.q_ss, kWBQ);
  if (err == cudaSuccess)
    err = tensor_map(&mk, p.k, DH, p.skv, p.hkv, p.b, p.kv_sb, p.kv_sh, p.kv_ss, WTile<DH>::kBK);
  if (err == cudaSuccess)
    err = tensor_map(&mv, p.v, DH, p.skv, p.hkv, p.b, p.kv_sb, p.kv_sh, p.kv_ss, WTile<DH>::kBK);
  if (err != cudaSuccess) return err;
  const int blocks = (p.sq + kWBQ - 1) / kWBQ * p.h * p.b;
  flash_fwd_wgmma_kernel<DH><<<blocks, kWThreads, wgmma_smem_bytes<DH>(), stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_wgmma<64>(p, stream);
    case 128: return launch_wgmma<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// TMA reads from 16-byte aligned bases at strides that are multiples of 16
// bytes, and the output is stored in 4-byte pairs: every row start must be
// 16-byte aligned (the wrapper copies bf16 input that is not).
bool rows_on_16_bytes(const Params& p) {
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int64_t strides[] = {p.q_sb, p.q_sh, p.q_ss, p.kv_sb, p.kv_sh, p.kv_ss, p.o_sb, p.o_sh, p.o_ss};
  for (const int64_t st : strides)
    if (st % 8) return false;
  return a16(p.q) && a16(p.k) && a16(p.v) && a16(p.o);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (rows on 16 bytes). Strides are in
// elements; the last axis (Dh) is contiguous. window < 0 means no window.
extern "C" int warp_flash_attention(
    const void* q, const void* k, const void* v, void* o, int b, int h, int hkv, int sq,
    int skv, int dh, long long q_sb, long long q_sh, long long q_ss, long long kv_sb,
    long long kv_sh, long long kv_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv || sq <= 0 || skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Skipping is exact when every real row has a valid key: its diagonal.
  const int skip = sq <= skv && window != 0;
  const Params p{q, k, v, o, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh, o_ss,
                 b, h, hkv, sq, skv, causal, window < 0 ? -1 : window, skip,
                 1.f / sqrtf(static_cast<float>(dh))};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_dh(p, b, dh, s));
    case 1:
      if (!rows_on_16_bytes(p)) return static_cast<int>(cudaErrorMisalignedAddress);
      return static_cast<int>(launch_wgmma_dh(p, dh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
