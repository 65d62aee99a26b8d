// Fused causal / windowed / bidirectional attention, bf16 in and out, on
// Hopper's tensor cores.
//
// Replaces no Pallas kernel: the JAX reference leaves attention to XLA
// outside any kernel, and the port's plain path (nn/attention.py::_sdpa)
// builds the whole float32 S x T score square in device memory, masked
// half included, then passes over it for the scale, the mask, the
// softmax and a cast, on CUDA cores. This kernel does the same work at
// the same precision with the scores kept on chip:
//
//   out[b, s, (hk G + g) Dv + e] =
//       sum_t bf16(p[s, t]) v[b, t, hk, e] / sum_t p[s, t],
//   p[s, t] = exp(scale (q[b, s, hk, g, :] . k[b, t, hk, :]) - max), over
//   the keys t the mask allows;
//
// the dot products are bf16 x bf16 summed in float32 (a bf16 product is
// exact in float32, as the reference's float32 einsum takes it), the
// softmax runs online in float32 with exp2 and log2(e) folded into the
// scale, the probabilities are rounded to bf16 before the value product
// as _sdpa rounds them (here before, there after, the division by the
// sum), and the values accumulate in float32.
//
// What bounds it on this card: the two products are 4 S T' (Dh + Dv)
// operations over the allowed pairs T', against q, k, v and out read or
// written once; at S = T = 2048 that is ~1,000 operations a byte, far
// above the card's 295, so the tensor cores are the bound, and after
// them the exp2 of every score (the multi-function unit runs 16 a cycle
// an SM against 1,024 bf16 products). What the design does about it:
//   * one block of two warpgroups owns 128 query rows of one kv head:
//     rows are (position, group head) pairs, so the G query heads of a
//     kv head share every key and value tile read;
//   * scores S = Q K^T by wgmma m64nBCk16 with Q and K in shared memory,
//     rows of 64 values in 128-byte swizzle atoms (without the swizzle,
//     as mma_s8.cuh lays out its int8 tiles, Kimi's layer ran 1.5x
//     slower on this card);
//     the float32 accumulators are the softmax's registers, and their
//     layout is wgmma's register A fragment, so P goes to bf16 in place
//     and feeds P V (wgmma m64nDVPk16, A from registers, V MN-major in
//     shared memory): the scores never leave the SM;
//   * key / value tiles of BC rows are double-buffered with cp.async:
//     tile n + 1 is in flight while tile n is contracted;
//   * key tiles wholly masked are never loaded (causal: past the block's
//     last position; window: before its first position's window), and
//     only tiles on the diagonal, the window's edge or past T are masked;
//   * the blocks of one kv head run next to one another, so its keys and
//     values are read from device memory about once and from L2 by the
//     rest (block by block over all heads, the resident blocks' keys and
//     values outgrew the 50 MB L2 and were read again for each query
//     block); within a head, causal blocks run heaviest first;
//   * Dh runs at its own width rounded up to 16 (zero-filled in shared
//     memory; zeros add nothing to a dot product); Dv at the smallest of
//     the instantiated widths that holds it (DVP; the columns past Dv are
//     zero and not stored); shared memory holds whole 64-value atoms.
// What bounds it now: within a warpgroup the score product, the softmax
// and the value product run one after the other; the two warpgroups of a
// block overlap only as the scheduler interleaves them.
#include "mma_s8.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;       // query rows a block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_DH = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct AttnArgs {
  const bf16* q;  // (B, S, Hk, G, Dh), strides below, the last one 1
  const bf16* k;  // (B, T, Hk, Dh)
  const bf16* v;  // (B, T, Hk, Dv)
  bf16* out;      // (B, S, Hk G Dv), contiguous
  long long q_sb, q_ss, q_sh, q_sg;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, S, T, Hk, G, Dh, Dv;
  int causal;        // keys after the query's position are masked
  int window;        // > 0: keys `window` or more positions back masked
  float scale_log2;  // the score scale times log2(e)
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ bool allowed(const AttnArgs& a, int s, int t) {
  return t < a.T && (!a.causal || t <= s) &&
         (a.window <= 0 || s - t < a.window);
}

// Shared memory of a block: Q (BM x DHP), two K slots (BC x DHP), two V
// slots (BC x DVP), bf16.
__host__ __device__ constexpr int round64(int x) { return (x + 63) & ~63; }

__host__ __device__ constexpr int smem_bytes(int dh, int dvp, int bc) {
  return 2 * (BM * round64(dh) + 2 * bc * round64(dh) +
              2 * bc * round64(dvp));
}

// 128-byte-swizzle descriptor: rows of 128 bytes, the 16-byte chunk
// index XORed with the row's index within its 8-row (1,024-byte) atom.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, int lbo,
                                               int sbo) {
  return rq::tc::descriptor(p, lbo, sbo) | (1ull << 62);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of `rows`
// rows: 64-value columns of atoms (rows x 128 bytes each) side by side.
__device__ __forceinline__ int sw_offset(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <int DVP, int BC>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_kernel(const AttnArgs a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int DV64 = round64(DVP);
  const int dhp = (a.Dh + 15) & ~15;
  const int dh64 = round64(a.Dh);
  uint8_t* const sq = smem;
  uint8_t* const sk = sq + BM * dh64 * 2;
  uint8_t* const sv = sk + 2 * BC * dh64 * 2;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // one kv head's query blocks run next to one another, so its keys and
  // values stay in L2 between them; within a head, heaviest first
  const int blocks = (static_cast<long long>(a.S) * a.G + BM - 1) / BM;
  const int bh = blockIdx.x / blocks;
  const int b = bh / a.Hk, hk = bh % a.Hk;
  const int mb = blocks - 1 - static_cast<int>(blockIdx.x % blocks);
  const long long f0 = static_cast<long long>(mb) * BM;
  const int s_lo = static_cast<int>(f0 / a.G);
  const int s_hi = static_cast<int>(
      min(static_cast<long long>(a.S - 1), (f0 + BM - 1) / a.G));
  const int k_end = a.causal ? min(a.T, s_hi + 1) : a.T;
  const int k_begin = a.window > 0 ? max(0, s_lo - a.window + 1) : 0;
  const int n_begin = k_begin / BC, n_end = (k_end + BC - 1) / BC;

  // Thread tid copies 16-byte chunk tid % 8 of each 64-value column of
  // rows tid / 8, + 32, ...: 8 neighbouring threads fill one 128-byte
  // row (its chunks permuted by the swizzle) from 128 contiguous bytes.
  const int cc = tid & 7;
  // Q: row r is position (f0 + r) / G, group head (f0 + r) % G
  for (int r = tid >> 3; r < BM; r += THREADS / 8) {
    const long long f = f0 + r;
    const int s = static_cast<int>(f / a.G), g = static_cast<int>(f % a.G);
    const bool ok = s < a.S;
    const bf16* src = ok ? a.q + b * a.q_sb + s * a.q_ss + hk * a.q_sh +
                               g * a.q_sg
                         : a.q;
    for (int c = cc; c < dh64 / 8; c += 8)
      rq::cp_async16(sq + sw_offset(r, c, BM), src + c * 8,
                     ok && c < a.Dh / 8 ? 16 : 0);
  }
  // K and V tile n into a slot, both as rows of keys: K-major for the
  // scores, MN-major (values contiguous) for the value product.
  auto load_kv = [&](int n, int slot) {
    uint8_t* kt = sk + slot * BC * dh64 * 2;
    uint8_t* vt = sv + slot * BC * DV64 * 2;
    for (int r = tid >> 3; r < BC; r += THREADS / 8) {
      const int t = n * BC + r;
      const bool ok = t < a.T;
      const bf16* ks =
          ok ? a.k + b * a.k_sb + t * a.k_st + hk * a.k_sh : a.k;
      const bf16* vs =
          ok ? a.v + b * a.v_sb + t * a.v_st + hk * a.v_sh : a.v;
      for (int c = cc; c < dh64 / 8; c += 8)
        rq::cp_async16(kt + sw_offset(r, c, BC), ks + c * 8,
                       ok && c < a.Dh / 8 ? 16 : 0);
      for (int c = cc; c < DV64 / 8; c += 8)
        rq::cp_async16(vt + sw_offset(r, c, BC), vs + c * 8,
                       ok && c < a.Dv / 8 ? 16 : 0);
    }
  };
  if (n_begin < n_end) load_kv(n_begin, 0);
  rq::cp_async_commit();

  // this thread's two rows of its warpgroup's 64
  const int row0 = wg * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int s0 = static_cast<int>((f0 + row0) / a.G);
  const int s1 = static_cast<int>((f0 + row1) / a.G);
  const int cq = 2 * (lane % 4);  // this thread's first column of 8

  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale_log2;

  for (int n = n_begin; n < n_end; ++n) {
    const int slot = (n - n_begin) & 1;
    rq::cp_async_wait<0>();
    rq::tc::fence_proxy_async();
    __syncthreads();
    if (n + 1 < n_end) load_kv(n + 1, slot ^ 1);
    rq::cp_async_commit();
    const uint8_t* kt = sk + slot * BC * dh64 * 2;
    const uint8_t* vt = sv + slot * BC * DV64 * 2;

    float s[BC / 2];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = 0.f;
    // pin the accumulators' definitions before the fence: a register
    // write moved inside the wgmma pipeline serialises the wgmmas
    fence_registers(s);
    rq::tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_DH / 16; ++kk)
      if (kk < dhp / 16)
        rq::attn::wgmma_bf16_ss<BC>(
            s,
            desc_sw128(sq + (kk >> 2) * BM * 128 + wg * 64 * 128 +
                           (kk & 3) * 32,
                       16, 1024),
            desc_sw128(kt + (kk >> 2) * BC * 128 + (kk & 3) * 32, 16, 1024),
            kk > 0);
    rq::tc::wgmma_commit();
    rq::tc::wgmma_wait_all();
    fence_registers(s);

    const int c0 = n * BC;
    if (c0 + BC > a.T || (a.causal && c0 + BC - 1 > s_lo) ||
        (a.window > 0 && c0 <= s_hi - a.window)) {
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = c0 + 8 * j + cq + e;
          if (!allowed(a, s0, t)) s[4 * j + e] = -INFINITY;
          if (!allowed(a, s1, t)) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    // online softmax: the running max (scaled, log2 domain) and this
    // thread's part of the running sum of both rows
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    // a row that has seen no allowed key yet keeps max -inf: base 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2_approx(m0 - base0);
    const float alpha1 = exp2_approx(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      s[4 * j] = exp2_approx(fmaf(s[4 * j], sl2, -base0));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], sl2, -base0));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], sl2, -base1));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], sl2, -base1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P in bf16: the score accumulators of columns 16 kk.. are the
    // m64k16 A fragment of step kk
    uint32_t p[BC / 4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_registers(o);
    rq::tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      rq::attn::wgmma_bf16_rs<DVP>(
          o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
          desc_sw128(vt + kk * 16 * 128, BC * 128, 1024),
          1);
    rq::tc::wgmma_commit();
    rq::tc::wgmma_wait_all();
    fence_registers(o);
  }
  rq::cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l0 += __shfl_xor_sync(0xffffffff, l0, w);
    l1 += __shfl_xor_sync(0xffffffff, l1, w);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long long heads = static_cast<long long>(a.Hk) * a.G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long f = f0 + (h ? row1 : row0);
    const int s = static_cast<int>(f / a.G), g = static_cast<int>(f % a.G);
    if (s >= a.S) continue;
    const float inv = h ? inv1 : inv0;
    bf16* dst = a.out +
                ((static_cast<long long>(b) * a.S + s) * heads + hk * a.G +
                 g) * a.Dv;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < a.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int DVP, int BC>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  static rq::tc::OncePerDevice once;
  const auto kernel = attn_fwd_kernel<DVP, BC>;
  const int bytes = smem_bytes(a.Dh, DVP, BC);
  if (bytes > SMEM_MAX || a.Dv > DVP) return cudaErrorInvalidValue;
  const cudaError_t attr = once([&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  });
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      (static_cast<long long>(a.S) * a.G + BM - 1) / BM * a.B * a.Hk;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

// The (DVP, BC) instantiations; the wrapper's `ATTN_TILES` lists the same.
#define RQ_FOR_EACH_TILE(X) \
  X(32, 128) X(64, 128) X(96, 128) X(128, 128) X(128, 64) X(192, 64) X(256, 64)

// Returns the launch's error, else cudaGetLastError() after it (0 on
// success); an unsupported (dvp, bc) or shape returns
// cudaErrorInvalidValue. Strides are in elements; causal 1 masks keys
// after the query's position, window > 0 keys `window` or more positions
// back; scale multiplies the scores.
extern "C" int attn_launch(const void* q, const void* k, const void* v,
                           void* out, long long q_sb, long long q_ss,
                           long long q_sh, long long q_sg, long long k_sb,
                           long long k_st, long long k_sh, long long v_sb,
                           long long v_st, long long v_sh, int B, int S,
                           int T, int Hk, int G, int Dh, int Dv, int causal,
                           int window, float scale, int dvp, int bc,
                           void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hk < 1 || G < 1 || Dh < 8 || Dh > 256 ||
      Dh % 8 != 0 || Dv < 8 || Dv % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<bf16*>(out),
                   q_sb, q_ss, q_sh, q_sg, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                   B, S, T, Hk, G, Dh, Dv, causal, window, scale * LOG2E};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RQ_TILE(DVP, BC) \
  if (dvp == DVP && bc == BC) err = launch<DVP, BC>(a, s);
  RQ_FOR_EACH_TILE(RQ_TILE)
#undef RQ_TILE
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
