// Fused implicit-GEMM quantized HWC convolution for Hopper, with the
// fused eq. 3/4 epilogue (the PULP-NN execution model in one kernel).
//
// Replaces the Pallas TPU kernels `_qconv_kernel` (pipeline 'off',
// src/repro/kernels/qconv/kernel.py:64) as STAGES=1 and `_qconv_kernel_db`
// (pipeline 'double_buffer', :108) as STAGES=2.
//
//   out[p, n] = epilogue( sum_{t, c < cin} x[pixel(p, t), c] * w[t, c, n] )
//   x: (N, H, W, cp) the caller's image, unpadded: cp bytes a pixel (8-bit
//   activations: the real channels, or the wrapper's copy of them widened
//   to 4, 8 or a multiple of 16; sub-byte ones: cin_pad/pf_a chunk-planar
//   bytes); w: the tap-major `w_packed_fused` panel (fh*fw*cin_pad/pf_w,
//   Cout), each tap's channels padded to cin_pad as the artifact keeps it.
//   The conv's zero border is the gather's: a tap whose input pixel falls
//   outside [0, H) x [0, W) is copied with source size 0, cp.async's zero
//   fill, as rows past the last output pixel are.
//
// What bounded it on the H100: contracting every tap's channels padded
// to CHUNK = 128 (22x the real MACs at ResNet-8 widths) on dp4a, and
// re-gathering each pixel once per 64-wide Cout panel; then, with the
// real-channel K, the wrapper's copy of every image into a zero-filled
// 128-channel, spatially padded tensor before each launch (a third of a
// ResNet-8 wave's device time in fill and strided-copy kernels). What the
// design does about it:
//   * K covers the real channels only. The logical K of the conv is the
//     taps x real channels, cut into stages of at most 192 values
//     (several taps per stage when Cin is small: a 3x3 conv over 16
//     channels is one stage; one chunk of one tap when Cin > CHUNK) and
//     rounded up to wgmma's k = 32 once per stage. In a chunk-planar chunk
//     channel c sits in byte c % (CHUNK/pf), field c / (CHUNK/pf), so only
//     the first min(Cin, CHUNK/pf) bytes of a pixel's chunk and as many
//     weight rows per tap are copied. 8-bit activations of fewer than 16
//     channels take 4 per tap (the stem: 3 real + 1 zero of the wrapper's
//     copy), so their bytes lie back to back in K order. The stage plan,
//     the per-K map (ring byte, field, weight row) and the pixel strides
//     the gather may read at come from the Python wrapper
//     (`kernels/qconv/kernel.py::conv_k_plan`), where the CPU tests check
//     the same index math against the reference; each block copies the
//     plan into shared memory first.
//   * A block owns 128 consecutive output pixels (across images) x all of
//     Cout up to 256 (NT = Cout rounded up to 16, 32, 64, 128 or 256), so
//     each pixel row is gathered once, and contracts on the tensor cores
//     (mma_s8.cuh: int8 wgmma, int32 accumulators in registers). 8-bit
//     activations in K order are copied straight into the A tile; only
//     the weights (and sub-byte activations) are unpacked.
//   * The strided receptive-field gather is not a rectangular box, so it
//     stays a cp.async gather into the STAGES-slot ring. Its row table
//     holds each output pixel's first input pixel and top-left input
//     coordinate; each copy tests its tap against the image's bounds, so
//     the image is read where it lies, at its own pixel stride.
// What bounds it now: at ResNet-8 widths every conv is a chain of a few
// dependent latencies per block (copy the plan and epilogue columns,
// gather a stage, unpack, wgmma, store), not bytes or tensor-core math:
// the early layers fill the card with 512 blocks of one stage, the late
// ones run 32-128 blocks through two or three stages each.
#include "mma_s8.cuh"

namespace {

using rq::tc::THREADS;
using rq::tc::TILE_M;

// Logical K per stage: 192 (a 3x3 conv over 16 channels in one stage)
// where the shared memory allows it, 128 for the widest column tile.
// `conv_stage_k` in kernels/qconv/kernel.py states the same rule.
template <int NT>
__host__ __device__ constexpr int stage_k() {
  return NT <= 128 ? 192 : 128;
}

// Blocks per SM the conv kernel's register budget is set for
// (__launch_bounds__): the int32 accumulators take NT / 2 registers a
// thread, so narrow tiles leave room for more resident blocks to hide each
// other's stage latency; wide ones keep every register they need.
template <int NT>
__host__ __device__ constexpr int min_blocks() {
  return NT <= 32 ? 4 : NT <= 64 ? 2 : 1;
}

// One stage of the plan: (first segment, segments, real K, K rounded to
// 32, x bytes copied per segment, copy granule 4 or 16, ring bytes per
// segment, weight rows per segment). A segment is (tap, chunk).
constexpr int STAGE_FIELDS = 8;

// Shared memory of a block's copy of the plan (stages and segments),
// rounded to the ring's 16-byte alignment.
__host__ __device__ inline int plan_bytes(int nstages, int nsegs) {
  return ((nstages * STAGE_FIELDS + 2 * nsegs) * 4 + 15) / 16 * 16;
}

template <int A_BITS, int W_BITS, int NT>
struct ConvSrc {
  static constexpr int SUB_A = rq::CHUNK / (8 / A_BITS);
  static constexpr int SUB_W = rq::CHUNK / (8 / W_BITS);
  static constexpr int KS = stage_k<NT>();
  static constexpr int RING_ROW = rq::tc::ring_row<KS>();
  const int8_t* x;
  const int8_t* w;
  const int* stages;
  const int* segs;
  const int* kmap;
  // per block row: (input pixel index of the receptive field's top-left
  // corner, its (y, x) as two int16 halves; y = -32768 past the last
  // output pixel, so every tap of such a row is out of bounds)
  const int2* row_table;
  int h, w_img, cp, fw, w_tap_rows, cout, n0;
  bool a_signed;

  // A stage whose segments hold a multiple of 16 channels unpacks 16 at
  // a time. A stage of 8-bit activations whose segments lie back to back
  // in the ring (ring bytes per segment == channels) holds the int8
  // values in K order already: they go straight into the slot's A tile.
  static __device__ bool fast(const int* st) {
    return st[2] / st[1] % 16 == 0;
  }
  static __device__ bool direct(const int* st) {
    return A_BITS == 8 && st[6] == st[2] / st[1];
  }

  __device__ void issue(int s, const rq::tc::Slot& slot) const {
    const int* st = stages + s * STAGE_FIELDS;
    const int seg0 = st[0], nseg = st[1], a_bytes = st[4], a_vec = st[5];
    const int a_stride = st[6], w_rows = st[7];
    const bool to_tile = direct(st);
    const int nch = st[2] / nseg;
    const int per_seg = a_bytes / a_vec, per_row = nseg * per_seg;
    for (int v = threadIdx.x; v < TILE_M * per_row; v += THREADS) {
      const int r = v % TILE_M, rem = v / TILE_M;
      const int i = rem / per_seg, u = rem - i * per_seg;
      const int tap = segs[2 * (seg0 + i)], chunk = segs[2 * (seg0 + i) + 1];
      const int2 row = row_table[r];
      const int dy = tap / fw, dx = tap - dy * fw;
      // the tap's input pixel; outside the image it reads as zeros
      const bool in = static_cast<unsigned>((row.y >> 16) + dy) <
                          static_cast<unsigned>(h) &&
                      static_cast<unsigned>(
                          static_cast<int16_t>(row.y & 0xFFFF) + dx) <
                          static_cast<unsigned>(w_img);
      const int8_t* src =
          in ? x + static_cast<long long>(row.x + dy * w_img + dx) * cp +
                   chunk * SUB_A + u * a_vec
             : x;
      if (to_tile && a_vec == 16)
        rq::cp_async16(
            slot.a_tile + rq::tc::core_offset(r, i * nch + u * 16, TILE_M),
            src, in ? 16 : 0);
      else if (to_tile)
        rq::cp_async4(
            slot.a_tile + rq::tc::core_offset(r, i * nch + u * 4, TILE_M),
            src, in ? 4 : 0);
      else if (a_vec == 16)
        rq::cp_async16(slot.a_ring + r * RING_ROW + i * a_stride + u * 16,
                       src, in ? 16 : 0);
      else
        rq::cp_async4(slot.a_ring + r * RING_ROW + i * a_stride + u * 4, src,
                      in ? 4 : 0);
    }
    int8_t* rw = slot.w_ring;
    // weight rows: segment i's rows j < w_rows -> ring rows i * w_rows + j
    const int rows = nseg * w_rows;
    const int ncols = min(NT, cout - n0);
    if (cout % 16 == 0) {
      for (int v = threadIdx.x; v < rows * (NT / 16); v += THREADS) {
        const int j = v / (NT / 16), col = (v % (NT / 16)) * 16;
        const int i = j / w_rows;
        const int8_t* src =
            w + static_cast<long long>(segs[2 * (seg0 + i)] * w_tap_rows +
                                       segs[2 * (seg0 + i) + 1] * SUB_W +
                                       j % w_rows) * cout + n0 + col;
        const int valid = min(max(ncols - col, 0), 16);
        rq::cp_async16(rw + j * NT + col, valid ? src : w, valid);
      }
    } else if (cout % 4 == 0) {
      for (int v = threadIdx.x; v < rows * (NT / 4); v += THREADS) {
        const int j = v / (NT / 4), col = (v % (NT / 4)) * 4;
        const int i = j / w_rows;
        const int8_t* src =
            w + static_cast<long long>(segs[2 * (seg0 + i)] * w_tap_rows +
                                       segs[2 * (seg0 + i) + 1] * SUB_W +
                                       j % w_rows) * cout + n0 + col;
        const int valid = min(max(ncols - col, 0), 4);
        rq::cp_async4(rw + j * NT + col, valid ? src : w, valid);
      }
    } else {
      // rows of a ragged Cout are not 4-byte aligned: plain loads
      for (int v = threadIdx.x; v < rows * NT; v += THREADS) {
        const int j = v / NT, col = v % NT;
        const int i = j / w_rows;
        rw[j * NT + col] =
            col < ncols
                ? w[static_cast<long long>(segs[2 * (seg0 + i)] * w_tap_rows +
                                           segs[2 * (seg0 + i) + 1] * SUB_W +
                                           j % w_rows) * cout + n0 + col]
                : 0;
      }
    }
  }

  // A stage whose segments hold a multiple of 16 channels unpacks 16 at a
  // time (mma_s8.cuh); the weights past its real K are zeroed. Any other
  // stage (Cin = 1, 3, 5, a ragged last chunk) goes element by element
  // through its kmap entries: x ring byte (bits 0-7), x field (8-9),
  // weight ring row (10-17), weight field (18-19); -1 past the real K.
  __device__ int unpack(int s, const rq::tc::Slot& slot,
                        int8_t* b_tile) const {
    const int* st = stages + s * STAGE_FIELDS;
    const int nseg = st[1], kreal = st[2], kstage = st[3];
    const int nch = kreal / nseg;
    const int8_t* ra = slot.a_ring;
    const int8_t* rw = slot.w_ring;
    int8_t* a_tile = slot.a_tile;
    if (fast(st)) {
      if (!direct(st))
        rq::tc::unpack_rows16<A_BITS, TILE_M, KS>(ra, nseg, nch, st[6],
                                                   a_signed, a_tile);
      rq::tc::unpack_cols16<W_BITS, NT>(rw, nseg, nch, st[7], b_tile);
      for (int v = threadIdx.x; v < NT * ((kstage - kreal) / 16);
           v += THREADS)
        *reinterpret_cast<uint4*>(
            b_tile + rq::tc::core_offset(v % NT, kreal + (v / NT) * 16,
                                         NT)) = make_uint4(0, 0, 0, 0);
      return kstage;
    }
    const int* km = kmap + s * KS;
    const int kq = kstage / 4;
    const uint8_t* rau = reinterpret_cast<const uint8_t*>(ra);
    const uint8_t* rwu = reinterpret_cast<const uint8_t*>(rw);
    for (int v = threadIdx.x; v < (direct(st) ? 0 : TILE_M * kq);
         v += THREADS) {
      const int r = v % TILE_M, k = (v / TILE_M) * 4;
      const int4 e = *reinterpret_cast<const int4*>(km + k);
      const int ent[4] = {e.x, e.y, e.z, e.w};
      int8_t val[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        val[q] = ent[q] < 0 ? 0
                            : rq::field<A_BITS>(
                                  rau[r * RING_ROW + (ent[q] & 0xFF)],
                                  (ent[q] >> 8) & 3, a_signed);
      *reinterpret_cast<uint32_t*>(a_tile +
                                   rq::tc::core_offset(r, k, TILE_M)) =
          rq::tc::word4(val[0], val[1], val[2], val[3]);
    }
    for (int v = threadIdx.x; v < NT * kq; v += THREADS) {
      const int n = v % NT, k = (v / NT) * 4;
      const int4 e = *reinterpret_cast<const int4*>(km + k);
      const int ent[4] = {e.x, e.y, e.z, e.w};
      int8_t val[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        val[q] = ent[q] < 0 ? 0
                            : rq::field<W_BITS>(
                                  rwu[((ent[q] >> 10) & 0xFF) * NT + n],
                                  (ent[q] >> 18) & 3, true);
      *reinterpret_cast<uint32_t*>(b_tile + rq::tc::core_offset(n, k, NT)) =
          rq::tc::word4(val[0], val[1], val[2], val[3]);
    }
    return kstage;
  }
};

// One conv launch: operands, the stage plan and the geometry.
struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const int* stages;
  const int* segs;
  const int* kmap;
  void* out;
  int nstages, nsegs, img_h, img_w, cp, ho, wo, fw, stride, padding, npix,
      w_tap_rows, cout;
  int a_signed;
  int a_ring;  // 1 when some stage's activations are unpacked from a ring
};

template <int A_BITS, int W_BITS, int STAGES, int NT>
__global__ void __launch_bounds__(THREADS, min_blocks<NT>())
    qconv_kernel(const ConvArgs a, const rq::EpilogueArgs epi) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ rq::tc::ColumnParams<NT> cols;
  using S = rq::tc::Smem<NT, STAGES, stage_k<NT>()>;
  int8_t* b_tile = smem;
  int2* row_table = reinterpret_cast<int2*>(smem + S::B_TILE);
  // the stage plan and its segments, read from shared memory from here
  // on, and the epilogue's columns: copied asynchronously, all in flight
  // together while the row table is computed
  int* plan = reinterpret_cast<int*>(smem + S::FIXED);
  const int plan_ints = a.nstages * STAGE_FIELDS + 2 * a.nsegs;
  for (int i = threadIdx.x; i < plan_ints; i += THREADS)
    rq::cp_async4(plan + i,
                  i < a.nstages * STAGE_FIELDS
                      ? a.stages + i
                      : a.segs + (i - a.nstages * STAGE_FIELDS),
                  4);
  int8_t* ring = smem + S::FIXED + plan_bytes(a.nstages, a.nsegs);
  const int p0 = blockIdx.x * TILE_M, n0 = blockIdx.y * NT;
  cols.load_async(epi, n0, a.cout - n0);
  rq::cp_async_commit();
  const int howo = a.ho * a.wo;
  for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
    const int p = p0 + r;
    int2 row = make_int2(0, INT32_MIN);
    if (p < a.npix) {
      const int b = p / howo, q = p - b * howo;
      const int oy = q / a.wo, ox = q - oy * a.wo;
      const int iy = oy * a.stride - a.padding;
      const int ix = ox * a.stride - a.padding;
      row = make_int2((b * a.img_h + iy) * a.img_w + ix,
                      iy * 65536 | (ix & 0xFFFF));
    }
    row_table[r] = row;
  }
  rq::cp_async_wait<0>();
  __syncthreads();
  const ConvSrc<A_BITS, W_BITS, NT> src{
      a.x,
      a.w,
      plan,
      plan + a.nstages * STAGE_FIELDS,
      a.kmap,
      row_table,
      a.img_h,
      a.img_w,
      a.cp,
      a.fw,
      a.w_tap_rows,
      a.cout,
      n0,
      a.a_signed != 0};
  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  rq::tc::mainloop<NT, STAGES, stage_k<NT>()>(src, 0, a.nstages, b_tile,
                                               ring, a.a_ring != 0, acc);
  rq::tc::for_each_pair<NT>(acc, [&](int row, int col, int v0, int v1) {
    const int p = p0 + row;
    if (p < a.npix)
      cols.store2(a.out, static_cast<long long>(p) * a.cout + n0 + col, v0,
                  v1, col, a.cout - n0, epi);
  });
}

template <int A_BITS, int W_BITS, int STAGES, int NT>
cudaError_t launch(const ConvArgs& a, const rq::EpilogueArgs& epi,
                   cudaStream_t stream) {
  auto kernel = qconv_kernel<A_BITS, W_BITS, STAGES, NT>;
  static rq::tc::OncePerDevice smem_set;
  const cudaError_t attr = smem_set(
      [&] { return rq::tc::set_smem<NT, STAGES, stage_k<NT>()>(kernel); });
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.npix + TILE_M - 1) / TILE_M, (a.cout + NT - 1) / NT);
  const int bytes = rq::tc::Smem<NT, STAGES, stage_k<NT>()>::bytes(
      plan_bytes(a.nstages, a.nsegs), a.nstages, a.a_ring != 0);
  kernel<<<grid, THREADS, bytes, stream>>>(a, epi);
  return cudaSuccess;
}

template <int A_BITS, int W_BITS, int STAGES>
cudaError_t launch_n(int nt, const ConvArgs& a, const rq::EpilogueArgs& epi,
                     cudaStream_t stream) {
#define RQ_N(NT) \
  if (nt == NT) return launch<A_BITS, W_BITS, STAGES, NT>(a, epi, stream);
  RQ_N(16) RQ_N(32) RQ_N(64) RQ_N(128) RQ_N(256)
#undef RQ_N
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported (a_bits, w_bits, stages, nt) returns cudaErrorInvalidValue.
// stages/segs/kmap: the wrapper's stage plan on the device (int32);
// a_ring: whether some stage unpacks its activations (sub-byte widths, or
// a stage whose channels are not a multiple of 16); nt: the column tile
// (`conv_tile_n`). x is (n_img, img_h, img_w, cp), unpadded, 16-byte
// aligned, cp a stride the plan's copies fit (`ConvKPlan.takes_stride`);
// img_h, img_w and padding below 2^15 and n_img * img_h * img_w below
// 2^31 (the wrapper checks).
extern "C" int qconv_launch(const void* x, const void* w, const void* stages,
                            const void* segs, const void* kmap, int nstages,
                            int nsegs, int a_ring,
                            const void* kappa, const void* lam,
                            const void* mmul, const void* scale_vec,
                            float scale, void* out, int n_img, int img_h,
                            int img_w, int cp, int ho, int wo, int fw,
                            int stride, int padding, int w_tap_rows,
                            int cout, int a_bits,
                            int w_bits, int a_signed, int d, int hi,
                            int epilogue, int pipeline_stages, int nt,
                            void* stream) {
  const rq::EpilogueArgs epi{static_cast<const int*>(kappa),
                             static_cast<const int*>(lam),
                             static_cast<const int*>(mmul),
                             static_cast<const float*>(scale_vec),
                             scale, d, hi, epilogue, /*out_f32=*/0};
  const ConvArgs a{static_cast<const int8_t*>(x),
                   static_cast<const int8_t*>(w),
                   static_cast<const int*>(stages),
                   static_cast<const int*>(segs),
                   static_cast<const int*>(kmap),
                   out,
                   nstages,
                   nsegs, img_h, img_w, cp, ho, wo, fw, stride, padding,
                   n_img * ho * wo, w_tap_rows, cout, a_signed, a_ring};
  if (plan_bytes(nstages, nsegs) > 16 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_DISPATCH(A, W, S)                                 \
  if (a_bits == A && w_bits == W && pipeline_stages == S) \
    err = launch_n<A, W, S>(nt, a, epi, s);
  RQ_FOR_EACH_CONFIG(RQ_DISPATCH)
#undef RQ_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
