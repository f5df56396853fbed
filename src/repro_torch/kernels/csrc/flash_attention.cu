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
// peak) against 33.6 MB of q, k, v and out (10 us at 3.35 TB/s).
//
// Two paths, one per dtype. bf16 inputs run on the tensor cores
// (flash_fwd_mma_kernel, below); float32 inputs run the FMA kernel
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
  int h, hkv, sq, skv;
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
// bf16 inputs: tensor cores through mma.sync (m16n8k16, f32 accumulate).
//
// Four warps per block, 16 query rows each (64 per block), k/v tiles of 64
// keys. q.k products of bf16 values are exact in float32 and summed in
// float32, as the float32 path does. The probabilities, float32, enter the
// p.v product as two bf16 terms p_hi + p_lo (p_lo the rounding error of
// p_hi), so p keeps about 16 bits rather than bf16's 8: the product costs
// two mma per step instead of one and stays within ~1e-5 of float32.
// The running (max, sum, acc) of a lane's two rows stay in float32
// registers; masks and tile skipping are those of the float32 path.
constexpr int kWarps = 4;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a . b for a 16x16 (row) and b 16x8 (col) bf16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * kBQ * (DH + 8);
}

// Copies rows [r0, r0 + 64) of a [rows, DH] bf16 matrix with row stride ss
// into shared memory (pitch DH + 8) in 16-byte pieces; rows >= n are 0.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t ss, int r0, int n) {
  constexpr int kPitch = DH + 8, kPieces = DH / 8;
  for (int i = threadIdx.x; i < kBQ * kPieces; i += kWarps * 32) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_mma_kernel(Params p) {
  constexpr int kPitch = DH + 8;  // 4-byte words per row = 4 (mod 32): conflict-free
  constexpr int kNT = kBK / 8;    // 8-key column tiles of a score tile
  constexpr int kDT = DH / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBQ * kPitch;
  __nv_bfloat16* v_s = k_s + kBK * kPitch;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int q0 = blockIdx.x * kBQ, hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.hkv);
  const auto* qg = static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k) + bb * p.kv_sb + hk * p.kv_sh;
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v) + bb * p.kv_sb + hk * p.kv_sh;
  auto* og = static_cast<__nv_bfloat16*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  load_tile<DH>(q_s, qg, p.q_ss, q0, p.sq);
  __syncthreads();
  const int lr = warp * 16 + g;  // this lane's rows in the block: lr, lr + 8
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* base = q_s + kk * 16 + tig * 2;
    qa[kk][0] = ld32(base + lr * kPitch);
    qa[kk][1] = ld32(base + (lr + 8) * kPitch);
    qa[kk][2] = ld32(base + lr * kPitch + 8);
    qa[kk][3] = ld32(base + (lr + 8) * kPitch + 8);
  }

  int t_lo = 0, t_hi = (p.skv - 1) / kBK;
  if (p.skip) {
    const int q_last = min(q0 + kBQ, p.sq) - 1;
    if (p.window >= 0) t_lo = max(0, q0 - p.window + 1) / kBK;
    if (p.causal) t_hi = min(t_hi, q_last / kBK);
  }

  const int rows[2] = {q0 + lr, q0 + lr + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's share
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DH>(k_s, kg, p.kv_ss, k0, p.skv);
    load_tile<DH>(v_s, vg, p.kv_ss, k0, p.skv);
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat16* kb = k_s + (j * 8 + g) * kPitch + kk * 16 + tig * 2;
        mma_bf16(s[j], qa[kk], ld32(kb), ld32(kb + 8));
      }

    // Element (j, e) of a lane is row rows[e / 2], key k0 + j*8 + tig*2 + e%2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + j * 8 + tig * 2 + (e & 1);
        const int rel = rows[e >> 1] - c;
        const bool masked = (p.causal && rel < 0) || (p.window >= 0 && rel >= p.window);
        s[j][e] = c >= p.skv ? -INFINITY : masked ? kMasked : s[j][e] * p.scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: the tile holds a key < Skv
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a-fragment f: tile 2ks + f/2, elements 2(f%2), +1
        const float x0 = s[2 * ks + (f >> 1)][2 * (f & 1)];
        const float x1 = s[2 * ks + (f >> 1)][2 * (f & 1) + 1];
        const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
        hi[f] = pack_bf16(h0, h1);
        lo[f] = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                          __float2bfloat16(x1 - __bfloat162float(h1)));
      }
      const __nv_bfloat16* vr = v_s + (ks * 16 + tig * 2) * kPitch + g;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const __nv_bfloat16* vb = vr + j * 8;
        const uint32_t b0 = pack_bf16(vb[0], vb[kPitch]);
        const uint32_t b1 = pack_bf16(vb[8 * kPitch], vb[9 * kPitch]);
        mma_bf16(o[j], hi, b0, b1);
        mma_bf16(o[j], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = og + static_cast<int64_t>(rows[i]) * p.o_ss + tig * 2;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
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

template <int DH>
cudaError_t launch_mma(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, b);
  flash_fwd_mma_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_dh(const Params& p, int b, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch<64>(p, b, stream);
    case 128: return launch<128>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma_dh(const Params& p, int b, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_mma<64>(p, b, stream);
    case 128: return launch_mma<128>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core path loads 16-byte pieces of q/k/v rows and stores
// 4-byte pairs of out: it needs every row start 16-byte aligned (the
// wrapper copies bf16 input that is not).
bool mma_aligned(const Params& p) {
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
                 h, hkv, sq, skv, causal, window < 0 ? -1 : window, skip,
                 1.f / sqrtf(static_cast<float>(dh))};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_dh(p, b, dh, s));
    case 1:
      if (!mma_aligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
      return static_cast<int>(launch_mma_dh(p, b, dh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
