// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the
// streaming body, bf16, any number of tokens, head dims 8 to 128 in steps
// of 8, 16-byte aligned rows.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)) above 256 tokens: DeiT at
// 384 pixels (N = 577) and its exported subnets finetuned there. The
// resident body (attention_fwd_resident.cu) keeps N <= 256, the general body
// (attention_fwd.cu) unaligned views and fp32. Same function: q arrives
// already scaled; scores, row max and row sums are fp32; the probabilities
// are rounded to bf16 before p v; o is bf16; the row log-sum-exp goes out as
// fp32 (B, H, N) for the backward.
//
// Bound. 4 B H N² d flops against 4 B N H d * 2 bytes: at N = 577, d = 64
// about 290 flops a byte, the H100's own balance (~295 bf16 flops a byte),
// so bytes and tensor work bound it alike (B = 256, H = 6: 0.1355 ms of
// bytes at 3.35 TB/s, 0.1324 ms of dense bf16 at 989 TFLOP/s). A head's K
// and V (2 x 577 x 64 x 2 bytes) no longer fit a block beside its queries,
// so they stream.
//
// Design: the online softmax (flash attention) on `wgmma`.
//   * A block is two consumer warpgroups, 64 query rows each, 128 rows of
//     one (batch, head); grid (ceil(N / 128), H, B). The query tile stays in
//     shared memory for the whole walk.
//   * K and V arrive 64 keys at a time through a ring of four stages of
//     16-byte `cp.async` into the swizzled tiles of sm90.cuh; rows past N
//     arrive as zeros (stale shared memory may hold NaN bits, and p = 0
//     times NaN is NaN). Both warpgroups read every stage, which halves the
//     trips of K and V through L2 against one warpgroup a block.
//   * Per key tile: s = q kᵀ by `wgmma` (both K-major) into fp32 registers;
//     keys past N are left out of the row max and give e = 0 on the last
//     tile; the row max and the row's new sum by quad shuffles; o rescaled
//     by exp(m - m'); e = exp(s - m') rounded to bf16 is the A operand of
//     o += e v,
//     v read MN-major from its stage. e is never normalised before the
//     product (the twin rounds the normalised p): o /= l at the end. Both
//     round to bf16 once a term, a relative error up to 2^-9 either way.
//   * Tile t's q kᵀ is issued before tile t - 1's e v is waited for, so the
//     two products, the block barrier and the copy of tile t + 1 overlap;
//     the exponentials overlap the other block's products (two blocks an
//     SM at d16 <= 64: 108 registers a thread). Holding e v in flight
//     through the softmax as well would need e beside s, 32 registers more,
//     and one block an SM; rewriting s while e v is in flight makes ptxas
//     serialise every `wgmma` of the stage. A stage is refilled only after
//     the e v that reads its V has retired: a stage holds tile t - 1 (V
//     still in flight), t (being read) or t + 1, t + 2 (being copied), and
//     every refill sits behind the block barrier that follows the wait of
//     the last product on it.
//   * Head dims 8 * odd run as the next multiple of 16, as on the resident
//     body (the copies write zeros into the 8 columns past d).
//   * Shared memory at d16 <= 64: 16 KB of queries and 4 x 16 KB of K and V,
//     82 KB a block (two blocks an SM, as the registers allow); at
//     d16 <= 128 twice that.
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// K/V tiles copied ahead of the one in use; the ring also holds the tile
// in use and the one before it, whose V the last e v still reads. Two
// ahead measured 2% faster than one (probe_kernels), three no faster.
constexpr int AHEAD = 2;
constexpr int STAGES = AHEAD + 2;
constexpr int WGS = 2;                       // warpgroups a block
constexpr int QROWS = WGS * ROWS;            // query rows a block

// Shared memory of the forward, alignment slack included.
inline size_t fwd_streaming_smem(int DP) {
  return size_t(QROWS) * DP * 2 + STAGES * 2 * size_t(ROWS) * DP * 2 + 1024;
}

// One key tile of the online softmax of rows r0 and r0 + 8: the scores s
// become e = exp(s - m') in place (keys at or past `valid` give 0 when
// MASK); m becomes the new running max m', l this thread's partial row
// sums, a the factors exp(m - m') that rescale o.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[32], int valid,
                                               int col0, float (&m)[2],
                                               float (&l)[2],
                                               float (&a)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (!MASK || 8 * j + col0 + (c & 1) < valid)
        mx[c >> 1] = fmaxf(mx[c >> 1], s[4 * j + c]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    // a row whose keys were all -inf so far keeps exp(-inf - 0) = 0
    const float mb = (mx[r] == -INFINITY ? 0.f : mx[r]) * LOG2E;
    a[r] = ex2(fmaf(m[r], LOG2E, -mb));      // m = -inf: 0
    m[r] = mx[r];
    mx[r] = mb;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = ex2(fmaf(s[4 * j + c], LOG2E, -mx[c >> 1]));
      s[4 * j + c] = !MASK || 8 * j + col0 + (c & 1) < valid ? x : 0.f;
      rs[c >> 1] += s[4 * j + c];
    }
  l[0] = l[0] * a[0] + rs[0];
  l[1] = l[1] * a[1] + rs[1];
}

// e of one key tile, bf16, as the register A operands of its 4 k-steps.
__device__ __forceinline__ void pack_tile(const float (&e)[32],
                                          uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g);
      p[kk][2 * g] = pack_bf16(e[j], e[j + 1]);
      p[kk][2 * g + 1] = pack_bf16(e[j + 2], e[j + 3]);
    }
}

// DP: head dim padded to 64 or 128.
template <int DP>
__global__ void __launch_bounds__(WGS * WG)
attention_fwd_streaming_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, float* __restrict__ lse,
                               int N, int H, int d, Strides sq, Strides sk,
                               Strides sv) {
  constexpr int T_BYTES = ROWS * DP * 2;     // one 64-row tile
  constexpr int STAGE_BYTES = 2 * T_BYTES;   // K, then V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Qs = smem_u32(smem), Ring = Qs + QROWS * DP * 2;

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = QROWS * blockIdx.x + ROWS * wg;   // this warpgroup's
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS, ksteps = (d + 15) >> 4;

  auto stage = [&](int t) { return Ring + (t % STAGES) * STAGE_BYTES; };
  auto load_kv = [&](int t) {
    load_rows_async<DP>(stage(t), ROWS, 0, kbh, sk.n, ROWS * t, ROWS, N, d);
    load_rows_async<DP>(stage(t) + T_BYTES, ROWS, 0, vbh, sv.n, ROWS * t,
                        ROWS, N, d);
  };
  // tile t is here for every thread, and tile t - 2's stage is free, once
  // all have passed the wait of the e v that read it; then copy t + AHEAD
  // into it. One group of copies a tile, empty past the last.
  auto next_tile = [&](int t) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (t + AHEAD < ntiles) load_kv(t + AHEAD);
    cp_async_commit();
  };
  auto softmax = [&](int t, float (&s)[32], float (&m)[2], float (&l)[2],
                     float (&a)[2]) {
    if (t == ntiles - 1 && N % ROWS)         // keys past N
      online_softmax<true>(s, N - ROWS * t, col0, m, l, a);
    else
      online_softmax<false>(s, ROWS, col0, m, l, a);
  };
  load_rows_async<DP>(Qs, QROWS, 0, q + b * sq.b + h * sq.h, sq.n,
                      QROWS * blockIdx.x, QROWS, N, d);
  for (int t = 0; t < AHEAD; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  float s[32];                               // 64 x 64 scores, then e
  float acc[DP / 2];                         // 64 x DP output sums
  uint32_t p[4][4];                          // e, bf16, the A operand
  float m[2] = {-INFINITY, -INFINITY};       // running max, rows r0, r0 + 8
  float l[2] = {0.f, 0.f};                   // this thread's partial sums
  float a[2];                                // o's rescale factors

  // tile t: s = q kᵀ; its wait also retires o += e v of tile t - 1, which
  // ran under the barrier and the issue of s
  for (int t = 0; t < ntiles; ++t) {
    next_tile(t);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss(s, desc_kmajor(Qs, QROWS, ROWS * wg, kk),
               desc_kmajor(stage(t), ROWS, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(acc);
    softmax(t, s, m, l, a);
    if (t > 0) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= a[0];
        acc[4 * j + 1] *= a[0];
        acc[4 * j + 2] *= a[1];
        acc[4 * j + 3] *= a[1];
      }
    }
    pack_tile(s, p);
    // o += e v; k-steps whose 16 keys all lie past N skip
    const uint32_t Vt = stage(t) + T_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (ROWS * t + 16 * kk < N)
        wgmma_rs(acc, p[kk], desc_mnmajor(Vt, ROWS, 16 * kk), t > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if ((lane & 3) == 0) {
    const int n0 = row0 + r0;
    if (n0 < N) lse[bh * N + n0] = m[0] + logf(l[0]);
    if (n0 + 8 < N) lse[bh * N + n0 + 8] = m[1] + logf(l[1]);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    acc[4 * j] *= inv0;
    acc[4 * j + 1] *= inv0;
    acc[4 * j + 2] *= inv1;
    acc[4 * j + 3] *= inv1;
  }

  __syncthreads();                           // every product has retired
  // each warpgroup stages its tile through one tile of the ring's stage 0
  bf16* dst = o + ((static_cast<long long>(b) * N + row0) * H + h) * d;
  const long long stride = static_cast<long long>(H) * d;
  if (wg == 0)
    store_acc_tile<DP, 1>(acc, smem + (Ring - Qs), dst, stride, N - row0, d);
  else
    store_acc_tile<DP, 2>(acc, smem + (Ring - Qs) + T_BYTES, dst, stride,
                          N - row0, d);
}

template <int DP>
int launch_fwd_streaming(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int H, int d,
                         const long long* st, cudaStream_t stream) {
  static bool ready[64] = {};
  auto kernel = attention_fwd_streaming_kernel<DP>;
  cudaError_t err = allow_full_smem(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + QROWS - 1) / QROWS, H, B), WGS * WG,
           fwd_streaming_smem(DP), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 9 element strides, (batch, token, head) for q, k, v.
// o is contiguous (B, N, H, d), lse contiguous (B, H, N) fp32. Takes any
// N >= 1, d a multiple of 8 up to 128, 16-byte aligned rows, and B, H
// within the grid's limits; returns -1 for anything else, else
// cudaGetLastError() after the launch.
extern "C" int ofb_attention_fwd_streaming(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int N, int H, int d,
                                           const long long* strides,
                                           void* stream) {
  using namespace ofb::sm90;
  const void* ptrs[3] = {q, k, v};
  if (N < 1 || d < 8 || d > 128 || d % 8 != 0 || B < 1 || B > 65535 ||
      H < 1 || H > 65535 || !aligned_16(ptrs, strides, 3))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_fwd_streaming<64>(q, k, v, o, lse, B, N, H, d, strides, s);
  return launch_fwd_streaming<128>(q, k, v, o, lse, B, N, H, d, strides, s);
}
