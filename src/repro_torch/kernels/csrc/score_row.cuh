// Shared scoring routine of the three WARP scoring kernels (sm_90a).
//
// A token's packed code row holds D codes of b bits; dimension d lives in
// byte d / (8/b) at bit (d % (8/b)) * b. Read as a little-endian 32-bit
// word, the s-th dimension of the word therefore sits at bit s * b for
// every b in {2, 4, 8}, so one shift/AND per dimension unpacks it. The
// row's score is sum_d v[d][code_d] with the query token's v-table
// (v[d][c] = q_d * bucket_weight[c], f32[D][2^b]) held in shared memory:
// a shared-memory gather per dimension, 8 KiB of table at D = 128, b = 4.
//
// Work split: kGroup = 16 lanes score one row together (each lane a
// strided share of the row's 32-bit words, so a half-warp's loads cover
// the row's bytes contiguously), then add across the 16 lanes with
// butterfly shuffles. A warp scores two rows per step.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace warp {

constexpr int kThreads = 256;               // threads per block
constexpr int kGroup = 16;                  // lanes per code row
constexpr int kRowsPerStep = kThreads / kGroup;  // rows a block scores per step

// Cooperative copy of one query token's v-table into shared memory.
__device__ __forceinline__ void load_vtable(float* v_s, const float* __restrict__ v,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) v_s[i] = __ldg(v + i);
}

// Sum over NDIMS consecutive dimensions starting at dim0, packed from bit 0
// of `bits` upward.
template <int NBITS, int NDIMS>
__device__ __forceinline__ float score_bits(uint32_t bits, int dim0, const float* v_s) {
  constexpr int NB = 1 << NBITS;
  constexpr uint32_t MASK = NB - 1;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NDIMS; ++s) {
    acc += v_s[(dim0 + s) * NB + ((bits >> (s * NBITS)) & MASK)];
  }
  return acc;
}

// Score of one packed code row, summed over the 16 lanes of this lane's
// group. Every lane of the warp must call it (it ends in full-warp
// shuffles); a lane whose slot holds no valid row passes row == nullptr
// and contributes 0 — the masked load that replaces the TPU kernel's
// clamp-and-roll. `vec4` selects 32-bit loads (row bytes a multiple of 4
// and the code array 4-byte aligned), else byte loads.
template <int NBITS>
__device__ __forceinline__ float score_row(const uint8_t* __restrict__ row, int pb,
                                           bool vec4, const float* v_s, int lane_g) {
  constexpr int PER_BYTE = 8 / NBITS;
  float acc = 0.f;
  if (row != nullptr) {
    if (vec4) {
      const uint32_t* r32 = reinterpret_cast<const uint32_t*>(row);
      const int nw = pb >> 2;
      for (int w = lane_g; w < nw; w += kGroup) {
        acc += score_bits<NBITS, 32 / NBITS>(__ldg(r32 + w), w * 4 * PER_BYTE, v_s);
      }
    } else {
      for (int j = lane_g; j < pb; j += kGroup) {
        acc += score_bits<NBITS, PER_BYTE>(__ldg(row + j), j * PER_BYTE, v_s);
      }
    }
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// Above 48 KiB a block's dynamic shared memory must be opted into.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline bool aligned4(const void* p, int pb) {
  return (pb % 4 == 0) && (reinterpret_cast<uintptr_t>(p) % 4 == 0);
}

}  // namespace warp

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
