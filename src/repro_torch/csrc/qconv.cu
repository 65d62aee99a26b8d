// Fused implicit-GEMM quantized HWC convolution for Hopper, with the
// fused eq. 3/4 epilogue (the PULP-NN execution model in one kernel).
//
// Replaces the Pallas TPU kernels `_qconv_kernel` (pipeline 'off',
// src/repro/kernels/qconv/kernel.py:64) as STAGES=1 and `_qconv_kernel_db`
// (pipeline 'double_buffer', :108) as STAGES=2.
//
//   out[b, oy, ox, n] = epilogue( sum_{dy,dx,c} x[b, oy*s+dy, ox*s+dx, c]
//                                             * w[(dy*fw+dx)*cin_pad + c, n] )
//   x: (N, hp, wp, cin_pad/pf_a) packed, spatially padded image; w: the
//   tap-major `w_packed_fused` panel (fh*fw*cin_pad/pf_w, Cout).
//
// The TPU kernel holds the whole packed image in VMEM; a block's shared
// memory cannot, so each block owns TILE_M consecutive output pixels of
// one image (TILE_M / Wo whole rows when Wo divides it) x TILE_N output
// channels and gathers, per K tile = (tap t, channel chunk c), the strided
// receptive-field row of each of its pixels straight from global memory
// into a STAGES-slot cp.async ring; tile k+1's gather rides behind tile
// k's unpack and dot at STAGES=2. No im2col tensor exists in memory.
//
// What bounds it on the H100: at ResNet-8 widths the image is read with
// every tap's channel run padded to CHUNK = 128 (the artifact's layout),
// so the padded image bytes, re-read once per tap through L2, and the
// ~7x padded MACs dominate the real work; the math runs on __dp4a.
// Skipping the zero channels, wgmma and TMA are later work.
#include "common.cuh"

namespace {

struct ConvRows {
  const int8_t* base;
  int hp, wp, cp;     // padded image height/width, packed bytes per pixel
  int wo, howo, fw, stride, cchunks, xb;
  int b, q0;
  __device__ const int8_t* row(int r, int kt) const {
    const int q = q0 + r;
    if (q >= howo) return nullptr;
    const int oy = q / wo, ox = q % wo;
    const int t = kt / cchunks, c = kt % cchunks;
    const int iy = oy * stride + t / fw, ix = ox * stride + t % fw;
    return base + ((static_cast<long long>(b) * hp + iy) * wp + ix) * cp +
           c * xb;
  }
};

template <int A_BITS, int W_BITS, int STAGES>
__global__ void __launch_bounds__(rq::THREADS)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 void* __restrict__ out, int hp, int wp, int cin_pad, int ho,
                 int wo, int fh, int fw, int stride, int cout, int a_signed,
                 rq::EpilogueArgs epi) {
  extern __shared__ __align__(16) int8_t smem[];
  using L = rq::Layout<STAGES, A_BITS, W_BITS>;
  const int howo = ho * wo;
  const int tiles = (howo + rq::TILE_M - 1) / rq::TILE_M;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * rq::TILE_M;
  const int n0 = blockIdx.y * rq::TILE_N;
  const int cchunks = cin_pad / rq::CHUNK;
  const ConvRows rows{x,  hp,     wp, cin_pad / (8 / A_BITS),
                      wo, howo,   fw, stride,
                      cchunks, L::XB, b, q0};
  int acc[4][4] = {};
  rq::mainloop<STAGES, A_BITS, W_BITS>(rows, rq::WTile{w + n0, cout,
                                                  cout - n0},
                                       fh * fw * cchunks, a_signed != 0,
                                       smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= howo) continue;
    const long long pix = static_cast<long long>(b) * howo + q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < cout) rq::store_out(out, pix * cout + n, acc[i][j], n, epi);
    }
  }
}

template <int A_BITS, int W_BITS, int STAGES>
cudaError_t launch(const int8_t* x, const int8_t* w, void* out, int n_img,
                   int hp, int wp, int cin_pad, int ho, int wo, int fh,
                   int fw, int stride, int cout, int a_signed,
                   const rq::EpilogueArgs& epi, cudaStream_t stream) {
  auto kernel = qconv_kernel<A_BITS, W_BITS, STAGES>;
  cudaError_t err = rq::set_smem<STAGES, A_BITS, W_BITS>(kernel);
  if (err != cudaSuccess) return err;
  const int tiles = (ho * wo + rq::TILE_M - 1) / rq::TILE_M;
  const dim3 grid(n_img * tiles, (cout + rq::TILE_N - 1) / rq::TILE_N);
  kernel<<<grid, rq::THREADS, rq::Layout<STAGES, A_BITS, W_BITS>::BYTES,
           stream>>>(x, w, out, hp, wp, cin_pad, ho, wo, fh, fw, stride,
                     cout, a_signed, epi);
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported (a_bits, w_bits, stages) returns cudaErrorInvalidValue.
extern "C" int qconv_launch(const void* x, const void* w, const void* kappa,
                            const void* lam, const void* mmul,
                            const void* scale_vec, float scale, void* out,
                            int n_img, int hp, int wp, int cin_pad, int ho,
                            int wo, int fh, int fw, int stride, int cout,
                            int a_bits, int w_bits, int a_signed, int d,
                            int hi, int epilogue, int stages, void* stream) {
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue};
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp_ = static_cast<const int8_t*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, W, S)                                                \
  if (a_bits == A && w_bits == W && stages == S)                            \
    err = launch<A, W, S>(xp, wp_, out, n_img, hp, wp, cin_pad, ho, wo, fh, \
                          fw, stride, cout, a_signed, epi, s);
  RQ_FOR_EACH_CONFIG(RQ_DISPATCH)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
