// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the
// resident body, bf16, up to 256 keys, 16-byte aligned rows.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)) at the shapes the search
// step runs (DeiT: N = 197, d = 64); attention_fwd.cu keeps the general
// body for everything else. Same function: q arrives already scaled;
// scores, row max and row sums are fp32; p = e / sum is rounded to v's type
// before p v; o keeps the input type; the row log-sum-exp goes out as fp32
// (B, H, N) for the backward.
//
// Bound. 4 B H N² d flops against 4 B N H d * 2 bytes of q, k, v, o: about
// 100 flops a byte at N = 197, under the H100's ~295 bf16 flops a byte, so
// device memory bounds it (B = 256: 155 MB, ~46 us at 3.35 TB/s; the
// tensor cores would need ~15 us). Wasted tensor-core work is affordable,
// trips of intermediates through shared memory are not.
//
// Design: the TPU kernel's own algorithm, a whole row of scores at once and
// one exact softmax, with the scores in registers where the TPU kept them in
// VMEM.
//   * A block is one warpgroup and serves one (batch, head). K and V of the
//     head are copied into shared memory once, whole, by 16-byte `cp.async`
//     into the swizzled tiles of sm90.cuh; rows past N arrive as zeros.
//     Query tiles of 64 rows stream through two buffers, so a tile's copy
//     runs under the tile before it. (`cp.async` and not TMA: the tensor
//     maps of three strided views would be encoded on the host at every
//     call, and the step is host-bound at small batch.)
//   * s = q_tile kᵀ is NCH `wgmma` products of 64 x CH (A and B K-major from
//     shared memory) into fp32 registers: CH * NCH / 2 a thread. Keys past N
//     become -inf there. Row max and row sum by two shuffles in the quad
//     that shares a row; no running max, no rescale of o.
//   * p is normalised, rounded to bf16 in registers and is the register A
//     operand of o = p v, with v read MN-major from its tile. p never
//     touches shared memory. k-steps whose 16 keys all lie past N are
//     skipped.
//   * o (64 x d fp32 in registers) is rounded to bf16, staged through the
//     query buffer it came from and written with 16-byte stores.
//   * The ragged edge: 197 = 3 x 64 + 5, and the fourth query tile is a
//     full `wgmma` tile with 59 dead rows (zeros in, nothing out). The whole
//     head then costs 256 x 208 score positions for 197², 1.37x the tensor
//     work, still under the byte bound; an `mma.sync` tail would save
//     arithmetic that is not the limit and add a second code path. Keys are
//     padded to CH * NCH: 64, 128, 192 or 256, and 208 = 2 x 104 for
//     192 < N <= 208 (DeiT's 197), which keeps s at 104 registers.
//   * One warpgroup a block and two blocks an SM (at N = 197, d = 64:
//     214 registers a thread, 69 KB of shared memory) instead of two
//     alternating consumer warpgroups: while one block waits for its copies
//     or sits in its softmax, the other block's `wgmma` runs. Forcing three
//     blocks an SM (168 registers) spills and is slower.
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// DP: head dim padded to 64 or 128. CH x NCH: padded key count.
template <int DP, int CH, int NCH>
__global__ void __launch_bounds__(WG)
attention_fwd_resident_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int N, int H, int d, Strides sq, Strides sk,
                              Strides sv) {
  constexpr int NKP = CH * NCH;              // padded keys
  constexpr int BPC = CH / 8;                // 8-column blocks a chunk
  constexpr int KV_BYTES = NKP * DP * 2;
  constexpr int Q_BYTES = ROWS * DP * 2;
  static_assert(NKP % 16 == 0 && NKP <= 256 && CH % 8 == 0, "key padding");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Ks = smem_u32(smem), Vs = Ks + KV_BYTES,
                 Qs = Vs + KV_BYTES;         // two query buffers

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bf16* qbh = q + b * sq.b + h * sq.h;
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS, ksteps = d >> 4;

  // copies, in the order they are waited for: k and the first query tile,
  // v, the second query tile
  load_rows_async<DP>(Ks, NKP, 0, kbh, sk.n, 0, NKP, N, d);
  load_rows_async<DP>(Qs, ROWS, 0, qbh, sq.n, 0, ROWS, N, d);
  cp_async_commit();
  load_rows_async<DP>(Vs, NKP, 0, vbh, sv.n, 0, NKP, N, d);
  cp_async_commit();
  if (ntiles > 1)
    load_rows_async<DP>(Qs + Q_BYTES, ROWS, 0, qbh, sq.n, ROWS, ROWS, N, d);
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    const uint32_t Qt = Qs + (t & 1) * Q_BYTES;
    if (t == 0) cp_async_wait<2>(); else cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    // s = q_tile kᵀ, 64 x NKP
    float s[NCH][CH / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      for (int kk = 0; kk < ksteps; ++kk)
        wgmma_ss(s[c], desc_kmajor(Qt, ROWS, 0, kk),
                 desc_kmajor(Ks, NKP, CH * c, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // exact softmax of rows r0 and r0 + 8
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < BPC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c == NCH - 1 && CH * c + 8 * j + col0 + e >= N) {
            s[c][4 * j + e] = -INFINITY;
            s[c][4 * j + 2 + e] = -INFINITY;
          }
          m0 = fmaxf(m0, s[c][4 * j + e]);
          m1 = fmaxf(m1, s[c][4 * j + 2 + e]);
        }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    const float mb0 = m0 * LOG2E, mb1 = m1 * LOG2E;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < BPC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[c][4 * j + e] = ex2(fmaf(s[c][4 * j + e], LOG2E, -mb0));
          s[c][4 * j + 2 + e] = ex2(fmaf(s[c][4 * j + 2 + e], LOG2E, -mb1));
          l0 += s[c][4 * j + e];
          l1 += s[c][4 * j + 2 + e];
        }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if ((lane & 3) == 0) {
      const int n0 = ROWS * t + r0;
      if (n0 < N) lse[bh * N + n0] = m0 + logf(l0);
      if (n0 + 8 < N) lse[bh * N + n0 + 8] = m1 + logf(l1);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;

    // p, bf16, as the A operands of the NKP / 16 k-steps of p v
    uint32_t p[NKP / 16][4];
#pragma unroll
    for (int kk = 0; kk < NKP / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c = (2 * kk + g) / BPC, j = (2 * kk + g) % BPC;
        p[kk][2 * g] = pack_bf16(s[c][4 * j] * inv0, s[c][4 * j + 1] * inv0);
        p[kk][2 * g + 1] =
            pack_bf16(s[c][4 * j + 2] * inv1, s[c][4 * j + 3] * inv1);
      }

    if (t == 0) {                        // v has to be there now
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
    }
    float acc[DP / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKP / 16; ++kk)
      if (16 * kk < N)
        wgmma_rs(acc, p[kk], desc_mnmajor(Vs, NKP, 16 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    store_acc_tile<DP>(acc, smem + (Qt - Ks),
                       o + ((static_cast<long long>(b) * N + ROWS * t) * H + h)
                           * d,
                       static_cast<long long>(H) * d, N - ROWS * t, d);
    __syncthreads();                     // the buffer is free again
    if (t + 2 < ntiles)
      load_rows_async<DP>(Qt, ROWS, 0, qbh, sq.n, ROWS * (t + 2), ROWS, N, d);
    cp_async_commit();
  }
}

template <int DP, int CH, int NCH>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int N, int H, int d, const long long* st,
               cudaStream_t stream) {
  static bool ready[64] = {};
  auto kernel = attention_fwd_resident_kernel<DP, CH, NCH>;
  cudaError_t err = allow_full_smem(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * CH * NCH * DP * 2 + 2 * ROWS * DP * 2 + 1024;
  kernel<<<dim3(H, B), WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]});
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fwd_keys(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int N, int H, int d,
                    const long long* st, cudaStream_t stream) {
#define OFB_FWD(ch, nch)                                                     \
  return launch_fwd<DP, ch, nch>(q, k, v, o, lse, B, N, H, d, st, stream)
  if (N <= 64) OFB_FWD(64, 1);
  if (N <= 128) OFB_FWD(64, 2);
  if (N <= 192) OFB_FWD(64, 3);
  if (N <= 208) OFB_FWD(104, 2);
  OFB_FWD(64, 4);
#undef OFB_FWD
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 9 element strides, (batch, token, head) for q, k, v.
// o is contiguous (B, N, H, d), lse contiguous (B, H, N) fp32. Takes
// 1 <= N <= 256, d a multiple of 16 up to 128, 16-byte aligned rows, and
// B, H within the grid's limits; returns -1 for anything else, else
// cudaGetLastError() after the launch.
extern "C" int ofb_attention_fwd_resident(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int N, int H, int d,
                                          const long long* strides,
                                          void* stream) {
  using namespace ofb::sm90;
  const void* ptrs[3] = {q, k, v};
  if (N < 1 || N > 256 || d < 16 || d > 128 || d % 16 != 0 || B < 1 ||
      B > 65535 || H < 1 || !aligned_16(ptrs, strides, 3))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_fwd_keys<64>(q, k, v, o, lse, B, N, H, d, strides, s);
  return launch_fwd_keys<128>(q, k, v, o, lse, B, N, H, d, strides, s);
}
