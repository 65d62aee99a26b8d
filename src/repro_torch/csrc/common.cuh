// Shared device code of the integer kernels: the cp.async copies, the
// bit-field decode and the exact eq. 3/4 epilogue (qmatmul.cu, qconv.cu,
// qmatmul_segmented.cu), and the dp4a mainloop of the packed GEMM
// (qmatmul.cu; the other two contract on the tensor cores, mma_s8.cuh).
//
// One block computes a TILE_M x TILE_N tile of int32 accumulators. K
// advances one CHUNK (128 logical elements) per step: the packed x and w
// K tiles are copied global -> shared with cp.async into a STAGES-slot
// ring, unpacked to int8 in *logical* K order (plane p of a chunk holds
// logical elements p*CHUNK/pf + j), and contracted with __dp4a. Because
// both operands are unpacked into the same logical order, x and w of
// different widths pair up directly.
//
// STAGES == 1 copies tile k, waits, contracts it (the 'off' pipeline).
// STAGES == 2 issues the copy of tile k+1 before contracting tile k
// (the 'double_buffer' pipeline: the paper's Mac&Load).
//
// Exactness notes (the reference's integers, bit for bit):
//   * eq. 3 wraps in int32: computed in uint32 and reinterpreted, since
//     signed overflow is undefined in C++;
//   * eq. 4 keeps the reference's hi/lo split of (m * phi) >> d, with
//     every product in uint32 (its int32 wrap) and arithmetic shifts;
//   * 4/2-bit weights (and signed activations) sign-extend, unsigned
//     activations zero-extend; 8-bit containers are used as int8;
//   * dequant is __float2bfloat16_rn(float(acc) * scale): round to
//     nearest even, as XLA's convert.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rq {

constexpr int CHUNK = 128;
constexpr int TILE_M = 64;
constexpr int TILE_N = 64;
constexpr int PITCH = CHUNK + 4;  // unpacked row pitch: conflict-free dp4a
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each

enum Epilogue { EPI_INT = 0, EPI_DEQUANT = 1, EPI_RAW = 2 };

template <int STAGES, int A_BITS, int W_BITS>
struct Layout {
  static constexpr int XB = CHUNK / (8 / A_BITS);  // packed x bytes per row
  static constexpr int WR = CHUNK / (8 / W_BITS);  // packed w rows per tile
  static constexpr int X_SLOT = TILE_M * XB;
  static constexpr int W_SLOT = WR * TILE_N;
  static constexpr int UNPACKED = TILE_M * PITCH;
  static constexpr int BYTES = STAGES * (X_SLOT + W_SLOT) + 2 * UNPACKED;
  static_assert(BYTES <= 227 * 1024,
                "tile ring exceeds the shared memory of one sm_90 block");
};

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

// The 'dequant' epilogue: float(acc) * scale, rounded to nearest even.
__device__ __forceinline__ __nv_bfloat16 dequant_value(int acc, float scale) {
  return __float2bfloat16_rn(__int2float_rn(acc) * scale);
}

// The epilogue of one accumulator, given its column's kappa, lambda, m
// and dequant scale (only those its epilogue reads need be valid).
__device__ __forceinline__ void store_value(void* out, long long idx, int acc,
                                            int kappa, int lam, int mmul,
                                            float scale,
                                            const EpilogueArgs& e) {
  if (e.epilogue == EPI_INT)
    static_cast<int8_t*>(out)[idx] = requant_value(acc, kappa, lam, mmul, e);
  else if (e.epilogue == EPI_DEQUANT)
    static_cast<__nv_bfloat16*>(out)[idx] = dequant_value(acc, scale);
  else
    static_cast<int*>(out)[idx] = acc;
}

__device__ __forceinline__ void store_out(void* out, long long idx, int acc,
                                          int n, const EpilogueArgs& e) {
  const bool q = e.epilogue == EPI_INT;
  store_value(out, idx, acc, q ? e.kappa[n] : 0, q ? e.lam[n] : 0,
              q ? e.mmul[n] : 0,
              e.epilogue == EPI_DEQUANT && e.scale_vec != nullptr
                  ? e.scale_vec[n]
                  : e.scale,
              e);
}

// The weight columns one block contracts: packed row j of K tile kt
// starts at base + (kt * WR + j) * ld, and the first `ncols` of the
// block's TILE_N columns are real (the rest load as zeros). A row-major
// (K/pf_w, N) panel is {w + n0, N, N - n0}.
struct WTile {
  const int8_t* base;
  long long ld;
  int ncols;
};

// Issue the copies of K tile `kt` into ring slot `slot`. `xsrc.row(r, kt)`
// gives the global address of row r's packed CHUNK (nullptr: zero row).
// w rows of tile kt start at packed row kt * WR.
template <int STAGES, int A_BITS, int W_BITS, class XSrc>
__device__ __forceinline__ void load_tile(const XSrc& xsrc, const WTile& w,
                                          int kt, int slot, int8_t* smem) {
  using L = Layout<STAGES, A_BITS, W_BITS>;
  constexpr int XV = L::XB / 16;
  int8_t* xslot = smem + slot * L::X_SLOT;
  int8_t* wslot = smem + STAGES * L::X_SLOT + slot * L::W_SLOT;
  for (int v = threadIdx.x; v < TILE_M * XV; v += THREADS) {
    const int r = v / XV, c = v % XV;
    const int8_t* src = xsrc.row(r, kt);
    cp_async16(xslot + r * L::XB + c * 16,
               src != nullptr ? src + c * 16 : xsrc.base, src ? 16 : 0);
  }
  const int8_t* wtile = w.base + static_cast<long long>(kt) * L::WR * w.ld;
  if (w.ld % 16 == 0) {
    for (int v = threadIdx.x; v < L::WR * (TILE_N / 16); v += THREADS) {
      const int j = v / (TILE_N / 16), col = (v % (TILE_N / 16)) * 16;
      const int valid = min(max(w.ncols - col, 0), 16);
      cp_async16(wslot + j * TILE_N + col,
                 valid ? wtile + j * w.ld + col : w.base, valid);
    }
  } else if (w.ld % 4 == 0) {
    for (int v = threadIdx.x; v < L::WR * (TILE_N / 4); v += THREADS) {
      const int j = v / (TILE_N / 4), col = (v % (TILE_N / 4)) * 4;
      const int valid = min(max(w.ncols - col, 0), 4);
      cp_async4(wslot + j * TILE_N + col,
                valid ? wtile + j * w.ld + col : w.base, valid);
    }
  } else {
    // rows of a ragged N are not 4-byte aligned: plain loads
    for (int v = threadIdx.x; v < L::WR * TILE_N; v += THREADS) {
      const int j = v / TILE_N, col = v % TILE_N;
      wslot[j * TILE_N + col] = col < w.ncols ? wtile[j * w.ld + col] : 0;
    }
  }
}

// Unpack ring slot `slot` into the logical-order int8 tiles
// xs[r][k] (TILE_M rows) and ws[n][k] (TILE_N rows, K contiguous).
template <int STAGES, int A_BITS, int W_BITS>
__device__ __forceinline__ void unpack_tile(int slot, bool a_signed,
                                            int8_t* smem) {
  using L = Layout<STAGES, A_BITS, W_BITS>;
  constexpr int PFA = 8 / A_BITS, PFW = 8 / W_BITS;
  const uint8_t* xslot =
      reinterpret_cast<const uint8_t*>(smem + slot * L::X_SLOT);
  const uint8_t* wslot = reinterpret_cast<const uint8_t*>(
      smem + STAGES * L::X_SLOT + slot * L::W_SLOT);
  int8_t* xs = smem + STAGES * (L::X_SLOT + L::W_SLOT);
  int8_t* ws = xs + L::UNPACKED;
  for (int v = threadIdx.x; v < TILE_M * L::XB; v += THREADS) {
    const int r = v / L::XB, j = v % L::XB;
    const uint8_t byte = xslot[v];
#pragma unroll
    for (int p = 0; p < PFA; ++p)
      xs[r * PITCH + p * L::XB + j] = field<A_BITS>(byte, p, a_signed);
  }
  for (int v = threadIdx.x; v < L::WR * TILE_N; v += THREADS) {
    const int j = v / TILE_N, n = v % TILE_N;
    const uint8_t byte = wslot[v];
#pragma unroll
    for (int p = 0; p < PFW; ++p)
      ws[n * PITCH + p * L::WR + j] = field<W_BITS>(byte, p, true);
  }
}

// acc[i][j] += sum_k xs[ty + 16 i][k] * ws[tx + 16 j][k] over one CHUNK.
template <int STAGES, int A_BITS, int W_BITS>
__device__ __forceinline__ void contract_tile(const int8_t* smem,
                                              int acc[4][4]) {
  using L = Layout<STAGES, A_BITS, W_BITS>;
  const int8_t* xs = smem + STAGES * (L::X_SLOT + L::W_SLOT);
  const int8_t* ws = xs + L::UNPACKED;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < CHUNK; k += 4) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const int*>(xs + (ty + 16 * i) * PITCH + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const int*>(ws + (tx + 16 * j) * PITCH + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// The whole K loop of one block: nk CHUNK tiles through the STAGES ring.
template <int STAGES, int A_BITS, int W_BITS, class XSrc>
__device__ __forceinline__ void mainloop(const XSrc& xsrc, const WTile& w,
                                         int nk, bool a_signed, int8_t* smem,
                                         int acc[4][4]) {
  if (STAGES == 2) {
    load_tile<STAGES, A_BITS, W_BITS>(xsrc, w, 0, 0, smem);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    int slot = 0;
    if (STAGES == 2) {
      slot = kt & 1;
      if (kt + 1 < nk)  // tile kt+1's copy rides behind tile kt's math
        load_tile<STAGES, A_BITS, W_BITS>(xsrc, w, kt + 1, slot ^ 1, smem);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile<STAGES, A_BITS, W_BITS>(xsrc, w, kt, 0, smem);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    unpack_tile<STAGES, A_BITS, W_BITS>(slot, a_signed, smem);
    __syncthreads();
    contract_tile<STAGES, A_BITS, W_BITS>(smem, acc);
    __syncthreads();
  }
}

// Rows of a row-major packed activation matrix (M, K/pf_a), for a block
// whose first output row is m0: row r of K tile kt, or nullptr past M.
struct GemmRows {
  const int8_t* base;
  long long ld;  // packed bytes per row (K / pf_a)
  int M, m0, xb;
  __device__ const int8_t* row(int r, int kt) const {
    const int m = m0 + r;
    return m < M ? base + m * ld + static_cast<long long>(kt) * xb : nullptr;
  }
};

// Epilogue and store of a block's 64 x 64 accumulators into the row-major
// (M, N) output; thread (tx, ty) holds rows ty + 16 i, columns tx + 16 j.
__device__ __forceinline__ void store_gemm_tile(void* out, const int acc[4][4],
                                                int M, int N, int m0, int n0,
                                                const EpilogueArgs& epi) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store_out(out, static_cast<long long>(m) * N + n, acc[i][j], n, epi);
    }
  }
}

template <int STAGES, int A_BITS, int W_BITS, class Kernel>
cudaError_t set_smem(Kernel kernel) {
  constexpr int bytes = Layout<STAGES, A_BITS, W_BITS>::BYTES;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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
