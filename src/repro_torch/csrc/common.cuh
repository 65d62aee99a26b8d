// Shared device code of the integer kernels (qmatmul.cu, qconv.cu,
// qmatmul_segmented.cu): the cp.async copies, the bit-field decode, the
// exact eq. 3/4 epilogue and the instantiation list of the bit widths x
// pipeline stages. The mainloop they share, on the tensor cores, is
// mma_s8.cuh's.
//
// Exactness notes (the reference's integers, bit for bit):
//   * eq. 3 wraps in int32: computed in uint32 and reinterpreted, since
//     signed overflow is undefined in C++;
//   * eq. 4 keeps the reference's hi/lo split of (m * phi) >> d, with
//     every product in uint32 (its int32 wrap) and arithmetic shifts;
//   * 4/2-bit weights (and signed activations) sign-extend, unsigned
//     activations zero-extend; 8-bit containers are used as int8;
//   * dequant is float(acc) * scale in float32, as the reference's
//     acc.astype(f32) * scale: stored as it is for a float32 output, or
//     rounded to bfloat16 by __float2bfloat16_rn (round to nearest even,
//     as XLA's convert).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rq {

constexpr int CHUNK = 128;

enum Epilogue { EPI_INT = 0, EPI_DEQUANT = 1, EPI_RAW = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `valid` (0..16) bytes of a 16-byte vector, zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}

// Copy `valid` (0..4) bytes of a 4-byte word, zero-filling the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bit-field `plane` of a packed byte, as the int8 value it encodes.
template <int BITS>
__device__ __forceinline__ int8_t field(uint8_t byte, int plane,
                                        bool is_signed) {
  if (BITS == 8) return static_cast<int8_t>(byte);
  int v = (byte >> (BITS * plane)) & ((1 << BITS) - 1);
  if (is_signed && v >= (1 << (BITS - 1))) v -= (1 << BITS);
  return static_cast<int8_t>(v);
}

// Eq. 4's floor((m * phi) / 2^d), d in [16, 31], as the reference's
// int32 hi/lo split (core/quantize.py::requantize_shift).
__device__ __forceinline__ int requantize_shift(int phi, int m, int d) {
  const int hi = phi >> 16;
  const int lo = phi & 0xFFFF;
  const int mlo = static_cast<int>(static_cast<uint32_t>(m) *
                                   static_cast<uint32_t>(lo));
  const int a = static_cast<int>(
      static_cast<uint32_t>(m) * static_cast<uint32_t>(hi) +
      static_cast<uint32_t>(mlo >> 16));
  return a >> (d - 16);
}

struct EpilogueArgs {
  const int* kappa;
  const int* lam;
  const int* mmul;
  const float* scale_vec;  // per-channel dequant scale, or nullptr
  float scale;             // scalar dequant scale
  int d;
  int hi;                  // top of the unsigned out_bits grid
  int epilogue;
  int out_f32;             // 'dequant' writes float32, else bfloat16
};

// Eq. 3 (int32 wrap) then eq. 4 and the clip to [0, hi]: the 'int'
// epilogue of one accumulator, given its column's kappa, lambda and m.
__device__ __forceinline__ int8_t requant_value(int acc, int kappa, int lam,
                                                int mmul,
                                                const EpilogueArgs& e) {
  const uint32_t phi_u = static_cast<uint32_t>(acc) *
                             static_cast<uint32_t>(kappa) +
                         static_cast<uint32_t>(lam);
  const int y = requantize_shift(static_cast<int>(phi_u), mmul, e.d);
  return static_cast<int8_t>(min(max(y, 0), e.hi));
}

// The 'dequant' epilogue in float32: float(acc) * scale, unrounded.
__device__ __forceinline__ float dequant_f32(int acc, float scale) {
  return __int2float_rn(acc) * scale;
}

// The 'dequant' epilogue to bfloat16: the float32 value rounded to
// nearest even.
__device__ __forceinline__ __nv_bfloat16 dequant_value(int acc, float scale) {
  return __float2bfloat16_rn(dequant_f32(acc, scale));
}

// The epilogue of one accumulator, given its column's kappa, lambda, m
// and dequant scale (only those its epilogue reads need be valid).
__device__ __forceinline__ void store_value(void* out, long long idx, int acc,
                                            int kappa, int lam, int mmul,
                                            float scale,
                                            const EpilogueArgs& e) {
  if (e.epilogue == EPI_INT)
    static_cast<int8_t*>(out)[idx] = requant_value(acc, kappa, lam, mmul, e);
  else if (e.epilogue == EPI_DEQUANT && e.out_f32)
    static_cast<float*>(out)[idx] = dequant_f32(acc, scale);
  else if (e.epilogue == EPI_DEQUANT)
    static_cast<__nv_bfloat16*>(out)[idx] = dequant_value(acc, scale);
  else
    static_cast<int*>(out)[idx] = acc;
}

}  // namespace rq

// Instantiate `MACRO(A, W, S)` for every (a_bits, w_bits, stages).
#define RQ_FOR_EACH_CONFIG(MACRO) \
  MACRO(8, 8, 1) MACRO(8, 4, 1) MACRO(8, 2, 1) \
  MACRO(4, 8, 1) MACRO(4, 4, 1) MACRO(4, 2, 1) \
  MACRO(2, 8, 1) MACRO(2, 4, 1) MACRO(2, 2, 1) \
  MACRO(8, 8, 2) MACRO(8, 4, 2) MACRO(8, 2, 2) \
  MACRO(4, 8, 2) MACRO(4, 4, 2) MACRO(4, 2, 2) \
  MACRO(2, 8, 2) MACRO(2, 4, 2) MACRO(2, 2, 2)
