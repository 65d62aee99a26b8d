// Mixed-operand packed GEMM over a segmented (per-output-channel-run
// width) weight buffer, with the fused eq. 3/4 epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel `_qmatmul_segmented_kernel`
// (src/repro/kernels/qmatmul/kernel.py:234), both of its pipeline modes:
// 'off' as STAGES=1, 'double_buffer' as STAGES=2.
//
//   out[m, n] = epilogue( sum_{k < k_logical} x[m, k] * w[k, n] )
//   x: (M, K_pad/pf_a) chunk-planar packed activations; w_flat: a
//   panel-major `pack_segmented` buffer whose N is a CHUNK multiple
//   (`pad_segmented`): panel p (output channels [128 p, 128 p + 128)) is
//   (K_pad/pf_p, 128) packed at its run's width, row stride 128, starting
//   at byte offsets[p]; codes[p] indexes the width table. kappa/lam/m:
//   (N,) int32, one shift d for every run.
//
// What bounded it on the H100: the int8 math on dp4a (the library's
// tensor-core GEMM was 1.8x faster at qat-cnn's c3), K padded to a CHUNK
// multiple (288 -> 384 at c3), and each block re-reading its x rows for
// each 64-column half of a panel. What the design does about it:
//   * one block owns 128 rows x one whole 128-wide panel and contracts on
//     the tensor cores (mma_s8.cuh: int8 wgmma m64n128k32, int32
//     accumulators in registers), so each x row is read once per panel;
//     8-bit activations are copied straight into the A tile;
//   * K stops at the real K rounded up to 32: the last stage copies only
//     the bytes of the chunk that hold that K (min(K, CHUNK/pf) of them)
//     and the weight rows that do, and contracts ceil(rem / 32) * 32;
//   * where rows x panels give fewer blocks than the card has SMs (fig8:
//     256 rows), the wrapper splits K across up to 8 blocks, one thread
//     block cluster per tile, which add up their int32 partial sums
//     through distributed shared memory (integer sums are exact in any
//     order), each applying the epilogue to a share of the tile's rows;
//   * the width is uniform over a panel, so a block reads its panel's
//     (code, offset) descriptor once and branches once into the whole K
//     loop instantiated for that width.
// What bounds it now: the latency of each stage's copy, weight unpack and
// wgmma within a block; wide grids run two blocks per SM to overlap them.
#include "mma_s8.cuh"

namespace {

using rq::tc::THREADS;
using rq::tc::TILE_M;
constexpr int NT = rq::CHUNK;       // one whole panel per block
constexpr int STAGE_K = rq::CHUNK;  // one chunk of K per stage

struct WidthTable {
  int bits[3];  // width of code c, widest first (SegmentMap.widths())
};

// The K stages of panel `pw` (rows of 128 bytes) at width W_BITS.
template <int A_BITS, int W_BITS>
using PanelSrc = rq::tc::GemmSrc<A_BITS, W_BITS, NT>;

// MIN_BLOCKS: resident blocks per SM the registers are budgeted for (see
// `launch`).
template <int A_BITS, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    qmatmul_segmented_kernel(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ w_flat,
                             const int* __restrict__ codes,
                             const int* __restrict__ offsets,
                             WidthTable widths, void* __restrict__ out,
                             int M, int N, int k_pad, int k_logical,
                             int a_signed, rq::EpilogueArgs epi) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ rq::tc::ColumnParams<NT> cols;
  const int panel = blockIdx.y;
  const int m0 = blockIdx.x * TILE_M, n0 = panel * NT;
  cols.load_async(epi, n0, NT);
  rq::cp_async_commit();
  const int nstages = (k_logical + STAGE_K - 1) / STAGE_K;
  const int per = (nstages + gridDim.z - 1) / gridDim.z;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(nstages, s_begin + per);
  const int w_bits = widths.bits[codes[panel]];
  const int8_t* pw = w_flat + offsets[panel];
  const long long ldx = k_pad / (8 / A_BITS);
  // the B tile first, then the ring
  int8_t* ring = smem + rq::tc::Smem<NT, STAGES, STAGE_K>::FIXED;
  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  // one branch per block: the width is uniform over the panel
  if (w_bits == 8)
    rq::tc::mainloop<NT, STAGES, STAGE_K>(
        PanelSrc<A_BITS, 8>{x, pw, ldx, NT, NT, M, m0, k_logical,
                            a_signed != 0},
        s_begin, s_end, smem, ring, A_BITS != 8, acc);
  else if (w_bits == 4)
    rq::tc::mainloop<NT, STAGES, STAGE_K>(
        PanelSrc<A_BITS, 4>{x, pw, ldx, NT, NT, M, m0, k_logical,
                            a_signed != 0},
        s_begin, s_end, smem, ring, A_BITS != 8, acc);
  else
    rq::tc::mainloop<NT, STAGES, STAGE_K>(
        PanelSrc<A_BITS, 2>{x, pw, ldx, NT, NT, M, m0, k_logical,
                            a_signed != 0},
        s_begin, s_end, smem, ring, A_BITS != 8, acc);
  rq::cp_async_wait<0>();  // the epilogue's columns, with no stage run
  __syncthreads();
  const auto store = [&](int row, int col, int v0, int v1) {
    if (m0 + row < M)
      cols.store2(out, static_cast<long long>(m0 + row) * N + n0 + col, v0,
                  v1, col, NT, epi);
  };
  if (gridDim.z > 1)
    rq::tc::cluster_split_reduce<NT>(acc, reinterpret_cast<int*>(smem),
                                     store);
  else
    rq::tc::for_each_pair<NT>(acc, store);
}

template <int A_BITS, int STAGES, int MIN_BLOCKS>
cudaError_t launch_blocks(const int8_t* x, const int8_t* w, const int* codes,
                          const int* offsets, const WidthTable& widths,
                          void* out, int splits, int M, int N, int k_pad,
                          int k_logical, int a_signed,
                          const rq::EpilogueArgs& epi, cudaStream_t stream) {
  auto kernel = qmatmul_segmented_kernel<A_BITS, STAGES, MIN_BLOCKS>;
  static rq::tc::OncePerDevice smem_set;
  const cudaError_t attr = smem_set(
      [&] { return rq::tc::set_smem<NT, STAGES, STAGE_K>(kernel); });
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + TILE_M - 1) / TILE_M, N / NT, splits);
  const int nstages = (k_logical + STAGE_K - 1) / STAGE_K;
  const int bytes = rq::tc::split_bytes<NT, STAGES, STAGE_K>(
      (nstages + splits - 1) / splits, A_BITS != 8, splits);
  return rq::tc::launch_split(kernel, grid, bytes, stream, x, w, codes,
                              offsets, widths, out, M, N, k_pad, k_logical,
                              a_signed, epi);
}

// Registers for two resident blocks per SM (128 a thread) pay off where
// the grid is wider than the card and a second block hides the first's
// stage latency (qat-cnn's c3: 196 blocks; H100 measurements in
// PERF.md); a split-K grid is narrow and latency-bound, and keeps every
// register (one block per SM). Sub-byte activations need the activation
// ring, whose shared memory leaves room for one block only.
template <int A_BITS, int STAGES>
cudaError_t launch(const int8_t* x, const int8_t* w, const int* codes,
                   const int* offsets, const WidthTable& widths, void* out,
                   int splits, int M, int N, int k_pad, int k_logical,
                   int a_signed, const rq::EpilogueArgs& epi,
                   cudaStream_t stream) {
  if constexpr (A_BITS == 8) {
    if (splits == 1)
      return launch_blocks<A_BITS, STAGES, 2>(x, w, codes, offsets, widths,
                                              out, splits, M, N, k_pad,
                                              k_logical, a_signed, epi,
                                              stream);
  }
  return launch_blocks<A_BITS, STAGES, 1>(x, w, codes, offsets, widths, out,
                                          splits, M, N, k_pad, k_logical,
                                          a_signed, epi, stream);
}

}  // namespace

// Returns the launch's error, else cudaGetLastError() after it (0 on
// success); an unsupported a_bits, stages, width or shape returns
// cudaErrorInvalidValue. splits in [1, 8] blocks share each tile's K
// stages. out_f32: the 'dequant' epilogue writes float32 (else bfloat16).
extern "C" int qmatmul_segmented_launch(
    const void* x, const void* w_flat, const void* codes,
    const void* offsets, int w0, int w1, int w2, const void* kappa,
    const void* lam, const void* mmul, const void* scale_vec, float scale,
    void* out, int splits, int M, int N, int k_pad, int k_logical,
    int a_bits, int a_signed, int d, int hi, int epilogue, int out_f32,
    int stages, void* stream) {
  const WidthTable widths{{w0, w1, w2}};
  for (int c = 0; c < 3; ++c)
    if (widths.bits[c] != 8 && widths.bits[c] != 4 && widths.bits[c] != 2)
      return static_cast<int>(cudaErrorInvalidValue);
  if (N % NT != 0 || k_pad % rq::CHUNK != 0 || k_logical <= 0 ||
      k_logical > k_pad || splits < 1 || splits > rq::tc::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue, out_f32};
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w_flat);
  const auto* cp = static_cast<const int*>(codes);
  const auto* op = static_cast<const int*>(offsets);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, S)                                                  \
  if (a_bits == A && stages == S)                                          \
    err = launch<A, S>(xp, wp, cp, op, widths, out, splits, M, N, k_pad, \
                       k_logical, a_signed, epi, s);
  RQ_DISPATCH(8, 1) RQ_DISPATCH(4, 1) RQ_DISPATCH(2, 1)
  RQ_DISPATCH(8, 2) RQ_DISPATCH(4, 2) RQ_DISPATCH(2, 2)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
