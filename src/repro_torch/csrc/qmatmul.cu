// Packed sub-byte integer GEMM with the fused eq. 3/4 epilogue, for Hopper.
//
// Replaces the Pallas TPU kernels `_qmatmul_kernel` (pipeline 'off',
// src/repro/kernels/qmatmul/kernel.py:61) as STAGES=1 and
// `_qmatmul_kernel_db` (pipeline 'double_buffer', :81) as STAGES=2.
//
//   out[m, n] = epilogue( sum_k x[m, k] * w[k, n] )
//   x: (M, K/pf_a) int8 containers, w: (K/pf_w, N), both chunk-planar
//   along K (a CHUNK multiple); kappa/lam/m: (N,) int32.
//
// What bounds it on the H100: at the shapes this repo serves (the
// ResNet-8 head, M = wave, K = 128, N = 10) the work is a few hundred
// kilobytes and a few MFLOP, so the call is bound by its launch and one
// pass of K; large GEMMs would be bound by the int8 math, which here runs
// on __dp4a (CUDA cores), not the tensor cores. What the design does about
// it: one block per 64x64 output tile keeps the int32 accumulators in
// registers across the whole K loop (no second pass, no atomics), copies
// packed bytes only (sub-byte operands move 2-4x fewer bytes), and at
// STAGES=2 overlaps the copy of K tile k+1 with the unpack and dot of
// tile k. wgmma/TMA are later work.
#include "common.cuh"

namespace {

template <int A_BITS, int W_BITS, int STAGES>
__global__ void __launch_bounds__(rq::THREADS)
    qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   void* __restrict__ out, int M, int N, int K, int a_signed,
                   rq::EpilogueArgs epi) {
  extern __shared__ __align__(16) int8_t smem[];
  using L = rq::Layout<STAGES, A_BITS, W_BITS>;
  const int m0 = blockIdx.x * rq::TILE_M;
  const int n0 = blockIdx.y * rq::TILE_N;
  const rq::GemmRows rows{x, K / (8 / A_BITS), M, m0, L::XB};
  int acc[4][4] = {};
  rq::mainloop<STAGES, A_BITS, W_BITS>(rows, rq::WTile{w + n0, N, N - n0},
                                       K / rq::CHUNK, a_signed != 0, smem,
                                       acc);
  rq::store_gemm_tile(out, acc, M, N, m0, n0, epi);
}

template <int A_BITS, int W_BITS, int STAGES>
cudaError_t launch(const int8_t* x, const int8_t* w, void* out, int M, int N,
                   int K, int a_signed, const rq::EpilogueArgs& epi,
                   cudaStream_t stream) {
  auto kernel = qmatmul_kernel<A_BITS, W_BITS, STAGES>;
  cudaError_t err = rq::set_smem<STAGES, A_BITS, W_BITS>(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + rq::TILE_M - 1) / rq::TILE_M,
                  (N + rq::TILE_N - 1) / rq::TILE_N);
  kernel<<<grid, rq::THREADS, rq::Layout<STAGES, A_BITS, W_BITS>::BYTES,
           stream>>>(x, w, out, M, N, K, a_signed, epi);
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported (a_bits, w_bits, stages) returns cudaErrorInvalidValue.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* kappa,
                              const void* lam, const void* mmul,
                              const void* scale_vec, float scale, void* out,
                              int M, int N, int K, int a_bits, int w_bits,
                              int a_signed, int d, int hi, int epilogue,
                              int stages, void* stream) {
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue};
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, W, S)                                            \
  if (a_bits == A && w_bits == W && stages == S)                        \
    err = launch<A, W, S>(xp, wp, out, M, N, K, a_signed, epi, s);
  RQ_FOR_EACH_CONFIG(RQ_DISPATCH)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
