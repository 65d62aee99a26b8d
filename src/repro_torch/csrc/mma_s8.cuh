// Tensor-core mainloop of the integer kernels (qmatmul.cu, qconv.cu,
// qmatmul_segmented.cu): int8 x int8 -> int32 on Hopper's wgmma.
//
// One block of 256 threads (two warpgroups) owns TILE_M = 128 output rows
// x NT output columns (NT in {16, 32, 64, 128, 256}); warpgroup g issues
// `wgmma.mma_async.m64nNTk32.s32.s8.s8` for rows [64 g, 64 g + 64) and
// keeps its m64 x NT int32 accumulators in registers across the K loop.
//
// K advances one *stage* at a time, at most KS logical values (the
// conv's 192, or 128 at NT = 256; the GEMMs' 128). What a stage holds is
// the caller's (`Src`): the conv gathers taps x real channels through the
// wrapper's stage plan, both GEMMs (`GemmSrc`) one CHUNK of their real K.
// Per stage:
//   1. `Src::issue` copies the packed bytes the stage needs, global ->
//      shared, with cp.async into one slot of a STAGES-slot ring
//      (STAGES == 2: stage s+1's copy is in flight while stage s is
//      unpacked and contracted). Each slot has its own A tile: 8-bit
//      activations whose bytes are already in K order are copied straight
//      into it, the rest into the slot's activation ring;
//   2. `Src::unpack` writes the stage's int8 values (activations from the
//      ring where needed, always the weights, which are stored K x N and
//      so transposed) into wgmma's canonical K-major layout without
//      swizzle: core matrices of 8 rows x 16 bytes, 128 contiguous bytes
//      each, the core of K group kg and row group rg at
//      (kg * rows / 8 + rg) * 128. A descriptor then has LBO (next core
//      along K) = rows / 8 * 128 and SBO (next 8-row group) = 128;
//   3. a proxy fence makes those stores visible to wgmma; each warpgroup
//      issues kstage / 32 wgmmas, commits and waits.
//
// Exactness: s8 x s8 products summed in s32 without .satfinite wrap as
// the reference's int32 accumulator does (unsigned activations are capped
// at 127, so their codes are s8 too); 4/2-bit fields sign-extend (weights,
// signed activations) or zero-extend, as in common.cuh. K past a stage's
// real K meets zero weights (zeroed here, or the artifact's padding).
#pragma once

#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace rq {
namespace tc {

constexpr int TILE_M = 128;
constexpr int THREADS = 256;
constexpr int MMA_K = 32;  // wgmma's k for 8-bit operands

// Row pitch of the gathered activation bytes of a stage of KS logical K:
// at most KS bytes, plus a 16-byte stagger across banks.
template <int KS>
__host__ __device__ constexpr int ring_row() {
  return KS + 16;
}

// The block's NT columns of the epilogue vectors, staged in shared memory
// once before the K loop, so the store loop reads no global memory
// between its stores (they would otherwise be serialised, one load
// latency per accumulator).
template <int NT>
struct ColumnParams {
  int kappa[NT], lam[NT], mmul[NT];
  float scale[NT];

  // Issues the copies with cp.async (zero past `ncols`); they land with
  // the caller's next cp_async_wait.
  __device__ void load_async(const EpilogueArgs& e, int n0, int ncols) {
    for (int c = threadIdx.x; c < NT; c += THREADS) {
      const int v = c < ncols ? 4 : 0;
      if (e.epilogue == EPI_INT) {
        cp_async4(&kappa[c], v ? e.kappa + n0 + c : e.kappa, v);
        cp_async4(&lam[c], v ? e.lam + n0 + c : e.lam, v);
        cp_async4(&mmul[c], v ? e.mmul + n0 + c : e.mmul, v);
      } else if (e.epilogue == EPI_DEQUANT && e.scale_vec != nullptr) {
        cp_async4(&scale[c], v ? e.scale_vec + n0 + c : e.scale_vec, v);
      } else {
        scale[c] = e.scale;
      }
    }
  }

  __device__ void store(void* out, long long idx, int acc, int c,
                        const EpilogueArgs& e) const {
    store_value(out, idx, acc, kappa[c], lam[c], mmul[c], scale[c], e);
  }

  // Columns c and c + 1 (c even) of one row at out[idx], out[idx + 1]:
  // one store of both when idx is even and both columns are real.
  __device__ void store2(void* out, long long idx, int v0, int v1, int c,
                         int ncols, const EpilogueArgs& e) const {
    if ((idx & 1) != 0 || c + 1 >= ncols) {
      if (c < ncols) store(out, idx, v0, c, e);
      if (c + 1 < ncols) store(out, idx + 1, v1, c + 1, e);
    } else if (e.epilogue == EPI_INT) {
      *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + idx) =
          make_char2(requant_value(v0, kappa[c], lam[c], mmul[c], e),
                     requant_value(v1, kappa[c + 1], lam[c + 1],
                                   mmul[c + 1], e));
    } else if (e.epilogue == EPI_DEQUANT && e.out_f32) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
          make_float2(dequant_f32(v0, scale[c]),
                      dequant_f32(v1, scale[c + 1]));
    } else if (e.epilogue == EPI_DEQUANT) {
      __nv_bfloat162 y;
      y.x = dequant_value(v0, scale[c]);
      y.y = dequant_value(v1, scale[c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         idx) = y;
    } else {
      *reinterpret_cast<int2*>(static_cast<int*>(out) + idx) =
          make_int2(v0, v1);
    }
  }
};

// One slot of the copy ring: the stage's A tile (written straight by
// cp.async where no unpack is needed), the packed weight rows and, only
// when some stage's activations need unpacking, their gathered bytes.
struct Slot {
  int8_t* a_tile;
  int8_t* w_ring;
  int8_t* a_ring;
};

// Shared memory of a block whose stages hold at most KS logical K (and so
// at most KS packed weight rows).
template <int NT, int STAGES, int KS>
struct Smem {
  // [B tile][per-row table][caller's tables][slot 0][slot 1]
  static_assert(NT % 16 == 0 && NT <= 256, "wgmma n of this kernel");
  static_assert(STAGES == 1 || STAGES == 2, "pipeline stages");
  static_assert(KS % MMA_K == 0, "whole wgmma k-steps per stage");
  static constexpr int A_TILE = TILE_M * KS;
  static constexpr int B_TILE = NT * KS;
  static constexpr int FIXED = B_TILE + TILE_M * 8;
  static constexpr int A_RING = TILE_M * ring_row<KS>();
  static constexpr int W_RING = KS * NT;
  __host__ __device__ static constexpr int slot_bytes(bool a_ring) {
    return A_TILE + W_RING + (a_ring ? A_RING : 0);
  }
  // the most a launch may ask for: both slots, 16 KB of tables
  static constexpr int BYTES = FIXED + 16 * 1024 + STAGES * slot_bytes(true);
  static_assert(BYTES <= 227 * 1024,
                "stage ring exceeds the shared memory of one sm_90 block");
  // what one launch needs: a block with one stage fills one slot only
  static constexpr int bytes(int tables, int stages_per_block, bool a_ring) {
    return FIXED + tables +
           (stages_per_block > 1 ? STAGES : 1) * slot_bytes(a_ring);
  }
  __device__ static Slot slot(int8_t* ring, int i, bool a_ring) {
    int8_t* p = ring + i * slot_bytes(a_ring);
    return Slot{p, p + A_TILE, p + A_TILE + W_RING};
  }
};

// Byte offset of element (row, k) in a K-major tile of `rows` rows laid
// out as wgmma's no-swizzle core matrices.
__device__ __forceinline__ int core_offset(int row, int k, int rows) {
  return ((((k >> 4) * (rows >> 3)) + (row >> 3)) << 7) + ((row & 7) << 4) +
         (k & 15);
}

// Shared-memory matrix descriptor, no swizzle (layout type 0).
__device__ __forceinline__ uint64_t descriptor(const void* p, int lbo,
                                               int sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Generic-proxy shared stores -> visible to wgmma's async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads across the wait.
template <int R>
__device__ __forceinline__ void fence_registers(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] += a[64 x 32] * b[N x 32]^T from two shared-memory descriptors;
// PTX lists every accumulator register, so there is one function per N.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The K loop of one block over stages [s_begin, s_end): copy, unpack,
// contract. `ring` is slot 0 of the copy ring (Smem's layout; `a_ring`:
// whether slots hold gathered activation bytes), `b_tile` the unpacked
// weights. `acc` is warpgroup (threadIdx.x / 128)'s m64 x NT fragment.
template <int NT, int STAGES, int KS, class Src>
__device__ __forceinline__ void mainloop(const Src& src, int s_begin,
                                         int s_end, int8_t* b_tile,
                                         int8_t* ring, bool a_ring,
                                         int (&acc)[NT / 2]) {
  using S = Smem<NT, STAGES, KS>;
  constexpr int LBO_A = TILE_M / 8 * 128, LBO_B = NT / 8 * 128;
  // warpgroup g's 64 rows start at row group 8 g
  const int rows = (threadIdx.x >> 7) * 8 * 128;
  if (STAGES == 2 && s_begin < s_end) {
    src.issue(s_begin, S::slot(ring, 0, a_ring));
    cp_async_commit();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const Slot slot =
        S::slot(ring, STAGES == 2 ? (s - s_begin) & 1 : 0, a_ring);
    if (STAGES == 2) {
      if (s + 1 < s_end)  // stage s+1's copy rides behind stage s
        src.issue(s + 1, S::slot(ring, ((s - s_begin) & 1) ^ 1, a_ring));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      src.issue(s, slot);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kstage = src.unpack(s, slot, b_tile);
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    for (int j = 0; j < kstage / MMA_K; ++j)
      wgmma_s8<NT>(acc,
                   descriptor(slot.a_tile + rows + j * 2 * LBO_A, LBO_A, 128),
                   descriptor(b_tile + j * 2 * LBO_B, LBO_B, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
    __syncthreads();  // this slot and the B tile are free again
  }
}

// Calls st(row, col, acc[i]) for each accumulator the thread holds: in
// warpgroup g, warp w, lane l, register 4 j + 2 h + e is row
// 64 g + 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
template <int NT, class Store>
__device__ __forceinline__ void for_each_accumulator(int (&acc)[NT / 2],
                                                     Store st) {
  const int t = threadIdx.x & 127;
  const int row0 = 64 * (threadIdx.x >> 7) + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st(row0 + 8 * h, 8 * j + col0 + e, acc[4 * j + 2 * h + e]);
}

// Calls st(row, col, acc[i], acc[i + 1]) for each pair of accumulators of
// adjacent columns col, col + 1 (col even) that the thread holds.
template <int NT, class Store>
__device__ __forceinline__ void for_each_pair(int (&acc)[NT / 2], Store st) {
  const int t = threadIdx.x & 127;
  const int row0 = 64 * (threadIdx.x >> 7) + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st(row0 + 8 * h, 8 * j + col0, acc[4 * j + 2 * h],
         acc[4 * j + 2 * h + 1]);
}

// Four consecutive int8 values as one little-endian word.
__device__ __forceinline__ uint32_t word4(int8_t v0, int8_t v1, int8_t v2,
                                          int8_t v3) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v0)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v1)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v2)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v3)) << 24);
}

// Field `plane` of four packed bytes as four int8 values, in one word:
// sign-extended with a per-byte (x ^ h) - h, or zero-extended.
template <int BITS>
__device__ __forceinline__ uint32_t plane4(uint32_t w, int plane,
                                           bool is_signed) {
  if (BITS == 8) return w;
  constexpr uint32_t LOW = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  constexpr uint32_t HALF = BITS == 4 ? 0x08080808u : 0x02020202u;
  const uint32_t v = (w >> (BITS * plane)) & LOW;
  return is_signed ? __vsub4(v ^ HALF, HALF) : v;
}

// Activation rows of a stage whose `nseg` segments hold `nch` channels
// each, nch a multiple of 16: channel ch of segment i sits in ring byte
// i * stride + ch % SUB, field ch / SUB (chunk-planar), and lands at
// logical k = i * nch + ch. Sixteen channels at a time: one 16-byte ring
// load, one field extraction per word, one 16-byte store that is a whole
// core-matrix row. Consecutive threads take consecutive rows.
template <int BITS, int ROWS, int KS>
__device__ __forceinline__ void unpack_rows16(const int8_t* ring, int nseg,
                                              int nch, int stride,
                                              bool is_signed, int8_t* tile) {
  constexpr int SUB = CHUNK / (8 / BITS);
  const int groups = nch / 16;
  for (int v = threadIdx.x; v < ROWS * nseg * groups; v += THREADS) {
    const int r = v % ROWS, u = v / ROWS;
    const int i = u / groups, ch0 = (u - i * groups) * 16;
    const int plane = ch0 / SUB;
    uint4 w = *reinterpret_cast<const uint4*>(ring + r * ring_row<KS>() +
                                              i * stride + ch0 % SUB);
    w.x = plane4<BITS>(w.x, plane, is_signed);
    w.y = plane4<BITS>(w.y, plane, is_signed);
    w.z = plane4<BITS>(w.z, plane, is_signed);
    w.w = plane4<BITS>(w.w, plane, is_signed);
    *reinterpret_cast<uint4*>(tile + core_offset(r, i * nch + ch0, ROWS)) =
        w;
  }
}

// Weight columns of the same stage: the ring holds packed rows
// (segment i's rows i * w_rows + j, w_rows = min(nch, SUB), a multiple of
// 16) x NT columns; channel ch of segment i is row i * w_rows + ch % SUB,
// field ch / SUB, sign-extended. A thread takes 16 rows x 4 columns:
// sixteen word loads, a 4x4 byte transpose per row quad, then per column
// and field one 16-byte store of 16 consecutive k.
template <int BITS, int NT>
__device__ __forceinline__ void unpack_cols16(const int8_t* ring, int nseg,
                                              int nch, int w_rows,
                                              int8_t* tile) {
  constexpr int SUB = CHUNK / (8 / BITS), PF = 8 / BITS;
  const int per_seg = (w_rows / 16) * (NT / 4);
  for (int v = threadIdx.x; v < nseg * per_seg; v += THREADS) {
    const int i = v / per_seg, u = v - i * per_seg;
    const int jb = u / (NT / 4), n = (u % (NT / 4)) * 4;
    const int8_t* src = ring + (i * w_rows + 16 * jb) * NT + n;
    uint32_t col[4][4];  // [column][row quad]: 4 rows of one column
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + NT);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * NT);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * NT);
      src += 4 * NT;
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      col[0][q] = __byte_perm(t0, t2, 0x5410);
      col[1][q] = __byte_perm(t0, t2, 0x7632);
      col[2][q] = __byte_perm(t1, t3, 0x5410);
      col[3][q] = __byte_perm(t1, t3, 0x7632);
    }
#pragma unroll
    for (int plane = 0; plane < PF; ++plane) {
      const int ch0 = plane * SUB + 16 * jb;
      if (ch0 >= nch) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 w{plane4<BITS>(col[c][0], plane, true),
                      plane4<BITS>(col[c][1], plane, true),
                      plane4<BITS>(col[c][2], plane, true),
                      plane4<BITS>(col[c][3], plane, true)};
        *reinterpret_cast<uint4*>(
            tile + core_offset(n + c, i * nch + ch0, NT)) = w;
      }
    }
  }
}

// The K stages of a packed GEMM over chunk-planar operands, one CHUNK of
// logical K per stage, for a block whose first output row is m0: x is
// (M, K_pad/pf_a) row-major with ldx bytes a row; w points at the block's
// first weight column of a row-major (K_pad/pf_w, ldw) packed matrix, of
// which the block takes `ncols` <= NT real columns (the rest load as
// zeros). The uniform artifact is {w + n0, N, min(NT, N - n0)}, a
// segmented panel {panel, 128, 128}. The weight rows past k_logical are
// the artifact's zero padding (K_pad is a CHUNK multiple).
template <int A_BITS, int W_BITS, int NT>
struct GemmSrc {
  static constexpr int SUB_A = CHUNK / (8 / A_BITS);
  static constexpr int SUB_W = CHUNK / (8 / W_BITS);
  static constexpr int RING_ROW = ring_row<CHUNK>();
  const int8_t* x;
  const int8_t* w;
  long long ldx;  // packed bytes per x row
  int ldw;        // packed bytes per weight row
  int ncols;      // real columns of the block
  int M, m0, k_logical;
  bool a_signed;

  // the stage's K: its real K rounded up to the MMA's 32
  __device__ int kstage(int s) const {
    const int kr = min(CHUNK, k_logical - s * CHUNK);
    return (kr + MMA_K - 1) / MMA_K * MMA_K;
  }

  // In a chunk-planar chunk logical k sits in byte k % SUB, field k / SUB,
  // so a stage of ks values needs min(ks, SUB) bytes of each x row and as
  // many weight rows. 8-bit activations are their own int8 values in K
  // order: their 16-byte vectors go straight into the slot's A tile;
  // narrower ones through the activation ring and unpack_rows16.
  __device__ void issue(int s, const Slot& slot) const {
    const int ks = kstage(s);
    const int per_row = min(ks, SUB_A) / 16;  // 16-byte vectors
    for (int v = threadIdx.x; v < TILE_M * per_row; v += THREADS) {
      const int r = v % TILE_M, u = v / TILE_M;
      const int m = m0 + r;
      const int8_t* src = m < M ? x + m * ldx + s * SUB_A + u * 16 : x;
      cp_async16(A_BITS == 8 ? slot.a_tile + core_offset(r, u * 16, TILE_M)
                             : slot.a_ring + r * RING_ROW + u * 16,
                 src, m < M ? 16 : 0);
    }
    // weight rows -> ring rows of NT bytes
    const int rows = min(ks, SUB_W);
    const int8_t* w0 = w + static_cast<long long>(s) * SUB_W * ldw;
    if (ldw % 16 == 0) {
      copy_rows<16>(w0, rows, slot.w_ring);
    } else if (ldw % 4 == 0) {
      copy_rows<4>(w0, rows, slot.w_ring);
    } else {
      // rows of a ragged N (the heads' 10) are not 4-byte aligned: plain
      // loads
      for (int v = threadIdx.x; v < rows * NT; v += THREADS) {
        const int j = v / NT, col = v % NT;
        slot.w_ring[j * NT + col] =
            col < ncols ? w0[static_cast<long long>(j) * ldw + col] : 0;
      }
    }
  }

  // `rows` weight rows from w0 into ring rows of NT bytes, in cp.async
  // copies of BYTES (16, or 4 where the row stride allows no more),
  // zero-filling the columns past ncols. THREADS is a multiple of the
  // copies per row, so a thread keeps one column for the whole stage and
  // walks down the rows.
  template <int BYTES>
  __device__ void copy_rows(const int8_t* w0, int rows, int8_t* ring) const {
    constexpr int PER_ROW = NT / BYTES, STEP = THREADS / PER_ROW;
    static_assert(THREADS % PER_ROW == 0, "a thread keeps one column");
    const int col = (threadIdx.x % PER_ROW) * BYTES;
    const int valid = min(max(ncols - col, 0), BYTES);
    int j = threadIdx.x / PER_ROW;
    const int8_t* src = w0 + static_cast<long long>(j) * ldw + col;
    const long long step = static_cast<long long>(STEP) * ldw;
    for (; j < rows; j += STEP, src += step) {
      if constexpr (BYTES == 16)
        cp_async16(ring + j * NT + col, valid ? src : w, valid);
      else
        cp_async4(ring + j * NT + col, valid ? src : w, valid);
    }
  }

  __device__ int unpack(int s, const Slot& slot, int8_t* b_tile) const {
    const int ks = kstage(s);
    if (A_BITS != 8)
      unpack_rows16<A_BITS, TILE_M, CHUNK>(slot.a_ring, 1, ks, 0, a_signed,
                                           slot.a_tile);
    unpack_cols16<W_BITS, NT>(slot.w_ring, 1, ks, min(ks, SUB_W), b_tile);
    return ks;
  }
};

// At most this many blocks share one output tile's K: a portable thread
// block cluster.
constexpr int MAX_SPLITS = 8;

// K split across the gridDim.z blocks of one output tile, launched as one
// thread block cluster along z (`launch_split`): each block stores its
// partial sums into its own shared memory (`buf`, TILE_M x NT int32; the
// mainloop's tiles are free by now), the cluster syncs, and block r adds
// up its share of the tile's rows from every block's buffer through
// distributed shared memory, handing each pair of adjacent columns to
// st(row, col, v0, v1) (col even). The sums wrap in int32 as the
// accumulators do; integer sums are exact in any order.
template <int NT, class Store>
__device__ __forceinline__ void cluster_split_reduce(int (&acc)[NT / 2],
                                                     int* buf, Store st) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  for_each_pair<NT>(acc, [&](int row, int col, int v0, int v1) {
    *reinterpret_cast<int2*>(buf + row * NT + col) = make_int2(v0, v1);
  });
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int* peer[MAX_SPLITS];
#pragma unroll
  for (int b = 0; b < MAX_SPLITS; ++b)
    peer[b] = b < splits ? cluster.map_shared_rank(buf, b) : buf;
  const int rows = (TILE_M + splits - 1) / splits;
  const int r0 = static_cast<int>(cluster.block_rank()) * rows;
  const int r1 = min(TILE_M, r0 + rows);
  for (int v = threadIdx.x; v < (r1 - r0) * (NT / 2); v += THREADS) {
    const int row = r0 + v / (NT / 2), col = (v % (NT / 2)) * 2;
    uint32_t s0 = 0, s1 = 0;
#pragma unroll
    for (int b = 0; b < MAX_SPLITS; ++b) {
      if (b < splits) {
        const int2 p = *reinterpret_cast<const int2*>(peer[b] + row * NT +
                                                      col);
        s0 += static_cast<uint32_t>(p.x);
        s1 += static_cast<uint32_t>(p.y);
      }
    }
    st(row, col, static_cast<int>(s0), static_cast<int>(s1));
  }
  cluster.sync();  // no block leaves while another reads its buffer
}

// Launches `kernel` on `grid` with THREADS threads and `bytes` of dynamic
// shared memory; grid.z > 1 (a K split) makes the grid.z blocks of each
// output tile one thread block cluster, for `cluster_split_reduce`.
template <class... Params, class... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int bytes,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cfg.attrs = cluster;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Dynamic shared memory of a launch whose stages per block are
// `stages_per_block`: the mainloop's, or a K split's partial-sum buffer
// where that is larger.
template <int NT, int STAGES, int KS>
__host__ int split_bytes(int stages_per_block, bool a_ring, int splits) {
  const int bytes = Smem<NT, STAGES, KS>::bytes(0, stages_per_block, a_ring);
  const int partial = TILE_M * NT * 4;
  return splits > 1 && partial > bytes ? partial : bytes;
}

template <int NT, int STAGES, int KS, class Kernel>
cudaError_t set_smem(Kernel kernel) {
  constexpr int bytes = Smem<NT, STAGES, KS>::BYTES;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A kernel's shared-memory attribute belongs to the device it was set on,
// so each launch function keeps one of these (a function-local static:
// one per kernel instantiation) and sets the attribute once for each
// device it launches on, the current device of the launch.
class OncePerDevice {
 public:
  template <class Set>
  cudaError_t operator()(Set set) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return set();
    const unsigned long long bit = 1ull << dev;
    if (done_.load(std::memory_order_acquire) & bit) return cudaSuccess;
    const cudaError_t r = set();
    if (r == cudaSuccess) done_.fetch_or(bit, std::memory_order_acq_rel);
    return r;
  }

 private:
  std::atomic<unsigned long long> done_{0};
};

}  // namespace tc
}  // namespace rq
