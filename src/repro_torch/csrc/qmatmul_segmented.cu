// Mixed-operand packed GEMM over a segmented (per-output-channel-run
// width) weight buffer, with the fused eq. 3/4 epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel `_qmatmul_segmented_kernel`
// (src/repro/kernels/qmatmul/kernel.py:234), both of its pipeline modes:
// 'off' as STAGES=1, 'double_buffer' as STAGES=2.
//
//   out[m, n] = epilogue( sum_k x[m, k] * w[k, n] )
//   x: (M, K/pf_a) chunk-planar packed activations, K a CHUNK multiple;
//   w_flat: a panel-major `pack_segmented` buffer whose N is a CHUNK
//   multiple (`pad_segmented`): panel p (output channels
//   [128 p, 128 p + 128)) is (K/pf_p, 128) packed at its run's width,
//   row stride 128, starting at byte offsets[p]; codes[p] indexes the
//   width table. kappa/lam/m: (N,) int32, one shift d for every run.
//
// What bounds it on the H100: the same as qmatmul.cu. At the shapes the
// port serves or checks (M = 256-12544 rows, K = 288-2048, N = 256-1024)
// the bound is the bytes, a few microseconds at most, and the kernel is
// bound by the dp4a instruction rate and the unpack in shared memory;
// tensor cores (wgmma) and TMA are later work.
// What the design does about the mixed widths: each block owns a 64-row
// x 64-column half of one 128-wide panel, so it never straddles a panel
// or a run. It reads its panel's (code, offset) descriptor once and
// branches once into the whole K loop instantiated for that width, so
// the unpack is specialised per width and no element branches. The
// ring, unpack, dp4a contraction and epilogue are the uniform kernel's
// (common.cuh); only the weight addressing differs: K tile kt of panel p
// is the contiguous byte range offsets[p] + kt * (CHUNK/pf) * 128.
#include "common.cuh"

namespace {

struct WidthTable {
  int bits[3];  // width of code c, widest first (SegmentMap.widths())
};

template <int STAGES, int A_BITS, int W_BITS>
__device__ __forceinline__ void panel_mainloop(const rq::GemmRows& rows,
                                               const int8_t* panel_half,
                                               int nk, bool a_signed,
                                               int8_t* smem, int acc[4][4]) {
  rq::mainloop<STAGES, A_BITS, W_BITS>(
      rows, rq::WTile{panel_half, rq::CHUNK, rq::TILE_N}, nk, a_signed, smem,
      acc);
}

template <int A_BITS, int STAGES>
__global__ void __launch_bounds__(rq::THREADS)
    qmatmul_segmented_kernel(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ w_flat,
                             const int* __restrict__ codes,
                             const int* __restrict__ offsets,
                             WidthTable widths, void* __restrict__ out,
                             int M, int N, int K, int a_signed,
                             rq::EpilogueArgs epi) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int HALVES = rq::CHUNK / rq::TILE_N;
  const int panel = blockIdx.y / HALVES;
  const int half = blockIdx.y % HALVES;
  const int m0 = blockIdx.x * rq::TILE_M;
  const int n0 = panel * rq::CHUNK + half * rq::TILE_N;
  const int w_bits = widths.bits[codes[panel]];
  const int8_t* panel_half = w_flat + offsets[panel] + half * rq::TILE_N;
  const rq::GemmRows rows{x, K / (8 / A_BITS), M, m0,
                          rq::CHUNK / (8 / A_BITS)};
  const int nk = K / rq::CHUNK;
  int acc[4][4] = {};
  // one branch per block: the width is uniform over the panel
  if (w_bits == 8)
    panel_mainloop<STAGES, A_BITS, 8>(rows, panel_half, nk, a_signed != 0,
                                      smem, acc);
  else if (w_bits == 4)
    panel_mainloop<STAGES, A_BITS, 4>(rows, panel_half, nk, a_signed != 0,
                                      smem, acc);
  else
    panel_mainloop<STAGES, A_BITS, 2>(rows, panel_half, nk, a_signed != 0,
                                      smem, acc);
  rq::store_gemm_tile(out, acc, M, N, m0, n0, epi);
}

template <int A_BITS, int STAGES>
cudaError_t launch(const int8_t* x, const int8_t* w, const int* codes,
                   const int* offsets, const WidthTable& widths, void* out,
                   int M, int N, int K, int a_signed,
                   const rq::EpilogueArgs& epi, cudaStream_t stream) {
  auto kernel = qmatmul_segmented_kernel<A_BITS, STAGES>;
  // the 8-bit weight ring is the largest of the three widths
  using L = rq::Layout<STAGES, A_BITS, 8>;
  cudaError_t err = rq::set_smem<STAGES, A_BITS, 8>(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + rq::TILE_M - 1) / rq::TILE_M,
                  (N / rq::CHUNK) * (rq::CHUNK / rq::TILE_N));
  kernel<<<grid, rq::THREADS, L::BYTES, stream>>>(
      x, w, codes, offsets, widths, out, M, N, K, a_signed, epi);
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported a_bits, stages, width or shape returns cudaErrorInvalidValue.
extern "C" int qmatmul_segmented_launch(
    const void* x, const void* w_flat, const void* codes,
    const void* offsets, int w0, int w1, int w2, const void* kappa,
    const void* lam, const void* mmul, const void* scale_vec, float scale,
    void* out, int M, int N, int K, int a_bits, int a_signed, int d, int hi,
    int epilogue, int stages, void* stream) {
  const WidthTable widths{{w0, w1, w2}};
  for (int c = 0; c < 3; ++c)
    if (widths.bits[c] != 8 && widths.bits[c] != 4 && widths.bits[c] != 2)
      return static_cast<int>(cudaErrorInvalidValue);
  if (N % rq::CHUNK != 0 || K % rq::CHUNK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue};
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w_flat);
  const auto* cp = static_cast<const int*>(codes);
  const auto* op = static_cast<const int*>(offsets);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, S)                                                 \
  if (a_bits == A && stages == S)                                         \
    err = launch<A, S>(xp, wp, cp, op, widths, out, M, N, K, a_signed, epi, \
                       s);
  RQ_DISPATCH(8, 1) RQ_DISPATCH(4, 1) RQ_DISPATCH(2, 1)
  RQ_DISPATCH(8, 2) RQ_DISPATCH(4, 2) RQ_DISPATCH(2, 2)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
