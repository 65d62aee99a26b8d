// Packed sub-byte integer GEMM with the fused eq. 3/4 epilogue, on
// Hopper's tensor cores.
//
// Replaces the Pallas TPU kernels `_qmatmul_kernel` (pipeline 'off',
// src/repro/kernels/qmatmul/kernel.py:61) as STAGES=1 and
// `_qmatmul_kernel_db` (pipeline 'double_buffer', :81) as STAGES=2.
//
//   out[m, n] = epilogue( sum_{k < k_logical} x[m, k] * w[k, n] )
//   x: (M, K_pad/pf_a) int8 containers, w: (K_pad/pf_w, N), both
//   chunk-planar along K (K_pad a CHUNK multiple, zero past k_logical);
//   kappa/lam/m: (N,) int32.
//
// What bounded the first port on the H100: the int8 math on dp4a (CUDA
// cores), one block per 64 x 64 output tile and K padded to a CHUNK
// multiple, so the ResNet-8 head (64 x 64 x 10) contracted 128 K x 64
// columns, 12.8x its real MACs, and 4096 x 2048 x 1024 took 2.2x the
// device time of the library's tensor-core GEMM. What the design does
// about it:
//   * one block of two warpgroups owns 128 rows x NT columns and
//     contracts on the tensor cores through the mainloop it shares with
//     the conv and the mixed-operand GEMM (mma_s8.cuh: int8 wgmma
//     m64nNTk32, int32 accumulators in registers, a STAGES-slot cp.async
//     ring); its K stages are `rq::tc::GemmSrc`, the same source as the
//     mixed-operand GEMM's panels, with the artifact's row stride N;
//   * N is fitted to the output: NT = N rounded up to 16, 32, 64 or 128
//     (the heads' N = 10 runs at 16), wider N takes several column tiles;
//     weight rows of a ragged N are copied 16 or 4 bytes at a time where
//     their alignment allows, else by plain loads;
//   * K stops at k_logical rounded up to 32: the last stage copies only
//     the packed bytes that hold it;
//   * where the tiles do not fill the card (4096 x 1152 x 64: 32 tiles),
//     the wrapper splits K across up to 8 blocks, launched as one thread
//     block cluster per tile: they add up their int32 partial sums through
//     distributed shared memory, each for a share of the tile's rows, and
//     apply the epilogue to it (no workspace, no global atomics);
//   * the wrapper picks the register budget per grid: two blocks per SM
//     on A8 grids at NT = 128 wider than the card, one otherwise.
// What bounds it now: each stage's copy, unpack and wgmma run one after
// the other within a block, so a block is a chain of latencies, not bytes
// or math; the heads are one such chain (a launch, one stage, one store).
#include "mma_s8.cuh"

namespace {

using rq::tc::THREADS;
using rq::tc::TILE_M;
constexpr int STAGE_K = rq::CHUNK;  // one chunk of K per stage

struct GemmArgs {
  const int8_t* x;
  const int8_t* w;
  void* out;
  int M, N, k_pad, k_logical, a_signed;
};

// MIN_BLOCKS: resident blocks per SM the registers are budgeted for.
template <int A_BITS, int W_BITS, int STAGES, int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    qmatmul_kernel(const GemmArgs a, const rq::EpilogueArgs epi) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ rq::tc::ColumnParams<NT> cols;
  const int m0 = blockIdx.x * TILE_M, n0 = blockIdx.y * NT;
  const int ncols = min(NT, a.N - n0);
  cols.load_async(epi, n0, ncols);
  rq::cp_async_commit();
  const int nstages = (a.k_logical + STAGE_K - 1) / STAGE_K;
  const int per = (nstages + gridDim.z - 1) / gridDim.z;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(nstages, s_begin + per);
  // the B tile first, then the ring
  int8_t* ring = smem + rq::tc::Smem<NT, STAGES, STAGE_K>::FIXED;
  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  rq::tc::mainloop<NT, STAGES, STAGE_K>(
      rq::tc::GemmSrc<A_BITS, W_BITS, NT>{
          a.x, a.w + n0, a.k_pad / (8 / A_BITS), a.N, ncols, a.M, m0,
          a.k_logical, a.a_signed != 0},
      s_begin, s_end, smem, ring, A_BITS != 8, acc);
  rq::cp_async_wait<0>();  // the epilogue's columns, with no stage run
  __syncthreads();
  const auto store = [&](int row, int col, int v0, int v1) {
    if (m0 + row < a.M)
      cols.store2(a.out, static_cast<long long>(m0 + row) * a.N + n0 + col,
                  v0, v1, col, ncols, epi);
  };
  if (gridDim.z > 1)
    rq::tc::cluster_split_reduce<NT>(acc, reinterpret_cast<int*>(smem),
                                     store);
  else
    rq::tc::for_each_pair<NT>(acc, store);
}

template <int A_BITS, int W_BITS, int STAGES, int NT, int MIN_BLOCKS>
cudaError_t launch(const GemmArgs& a, int splits,
                   const rq::EpilogueArgs& epi, cudaStream_t stream) {
  auto kernel = qmatmul_kernel<A_BITS, W_BITS, STAGES, NT, MIN_BLOCKS>;
  static rq::tc::OncePerDevice smem_set;
  const cudaError_t attr = smem_set(
      [&] { return rq::tc::set_smem<NT, STAGES, STAGE_K>(kernel); });
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + TILE_M - 1) / TILE_M, (a.N + NT - 1) / NT, splits);
  const int nstages = (a.k_logical + STAGE_K - 1) / STAGE_K;
  const int bytes = rq::tc::split_bytes<NT, STAGES, STAGE_K>(
      (nstages + splits - 1) / splits, A_BITS != 8, splits);
  return rq::tc::launch_split(kernel, grid, bytes, stream, a, epi);
}

// The column tile nt and the register budget min_blocks as the wrapper
// planned them (`gemm_launch_plan`): two blocks per SM only at A8 and
// nt = 128, where the accumulators would otherwise hold one block alone.
template <int A_BITS, int W_BITS, int STAGES>
cudaError_t launch_n(int nt, int min_blocks, const GemmArgs& a, int splits,
                     const rq::EpilogueArgs& epi, cudaStream_t stream) {
  if (min_blocks == 2) {
    if constexpr (A_BITS == 8)
      if (nt == 128)
        return launch<A_BITS, W_BITS, STAGES, 128, 2>(a, splits, epi,
                                                      stream);
    return cudaErrorInvalidValue;
  }
  if (min_blocks != 1) return cudaErrorInvalidValue;
#define RQ_N(NT) \
  if (nt == NT)  \
    return launch<A_BITS, W_BITS, STAGES, NT, 1>(a, splits, epi, stream);
  RQ_N(16) RQ_N(32) RQ_N(64) RQ_N(128)
#undef RQ_N
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's error, else cudaGetLastError() after it (0 on
// success); an unsupported (a_bits, w_bits, stages, nt, min_blocks) or
// shape returns cudaErrorInvalidValue. nt: the column tile (16, 32, 64 or
// 128); splits in [1, 8] blocks share each tile's K stages. out_f32: the
// 'dequant' epilogue writes float32 (else bfloat16).
extern "C" int qmatmul_launch(const void* x, const void* w, const void* kappa,
                              const void* lam, const void* mmul,
                              const void* scale_vec, float scale, void* out,
                              int splits, int nt, int min_blocks, int M,
                              int N, int k_pad, int k_logical, int a_bits,
                              int w_bits, int a_signed, int d, int hi,
                              int epilogue, int out_f32, int stages,
                              void* stream) {
  if (M < 1 || N < 1 || k_pad % rq::CHUNK != 0 || k_logical <= 0 ||
      k_logical > k_pad || splits < 1 || splits > rq::tc::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue, out_f32};
  const GemmArgs a{static_cast<const int8_t*>(x),
                   static_cast<const int8_t*>(w),
                   out,
                   M, N, k_pad, k_logical, a_signed};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, W, S)                                 \
  if (a_bits == A && w_bits == W && stages == S)             \
    err = launch_n<A, W, S>(nt, min_blocks, a, splits, epi, s);
  RQ_FOR_EACH_CONFIG(RQ_DISPATCH)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
