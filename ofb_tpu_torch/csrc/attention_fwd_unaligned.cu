// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the
// unaligned body, bf16, any number of tokens, any head dim in [1, 128], rows
// at any alignment.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)) for the bf16 calls that the
// resident and the streaming bodies do not take: head dims off multiples of
// 8 (the search grids' 12, 20, 28, 36, 60, 84, ..., the heads of the
// subnets a narrow-head search exports) and views whose rows do not start
// on 16 bytes (a view offset by one element). ops/attention.py
// `attention_body` sends them here. Same function: q arrives already
// scaled; scores, row max and row sums are fp32; e = exp(s - m) is rounded
// to bf16 before e v, unnormalised, and o /= l comes at the end (as the
// streaming body); o keeps the input type; the row log-sum-exp goes out as
// fp32 (B, H, N) for the backward.
//
// Bound. 4 B H N² d flops against 4 B N H d * 2 bytes of q, k, v, o: at
// N = 197 about 100 flops a byte at d = 64 and 30 at d = 20, under the
// H100's ~295, so device memory bounds it ((256, 197, 6, 64): 0.046 ms at
// 3.35 TB/s; (256, 197, 6, 20): 0.0145 ms). The design keeps the copies,
// the tensor cores and the exponentials of neighbouring blocks running at
// once and moves nothing but operands and o through shared memory.
//
// Design (sm90.cuh):
//   * A block is one warpgroup and owns 64 query rows of one (batch, head);
//     the grid's x walks the query tiles of a head, so the blocks that run
//     together share its K and V in L2.
//   * Keys and values stream in 64-key tiles. The copy of tile t + 1 starts
//     right after the `wgmma`s of s = q k_tᵀ are issued, so it runs under
//     tile t's products and softmax; one block barrier a tile.
//   * The copies, by the widest width each view's first element and
//     strides allow (`row_width`, judged per tensor on the host): rows on
//     16, 8 or 4 bytes by `cp.async` of as many bytes, straight into the
//     operand tiles, which alternate between two slots (the search grids'
//     head dims, 12, 20, 28, 36, .., give rows on 8 bytes). Rows on 2 bytes
//     only are staged: the aligned 16-byte chunks that hold them come by
//     16-byte `cp.async` into the second slot, and at the top of the tile
//     the block shifts them into place in the first
//     (`stage_rows_async`, `unstage_rows`; a second barrier). So every
//     streamed copy is asynchronous (read through registers, such rows
//     make the block wait for them at every tile). q is copied once,
//     through registers when its rows start on 2 bytes, under the first
//     k, v copies. Rows past N and columns d .. d16 - 1 (d16 =
//     16 ceil(d / 16)) arrive as zeros.
//   * s = q kᵀ is KS = d16 / 16 `wgmma` k-steps (64 x 64, both operands
//     K-major) into fp32 registers. The softmax is online, row max and row
//     sum in registers (two quad shuffles), o rescaled in registers; keys
//     past N are left out of the max and give e = 0, and only the last
//     tile pays for that test.
//   * e is rounded to bf16 in registers and is the register A operand of
//     o += e v (four k-steps of 16 keys, v read MN-major, N = DP: 64
//     columns up to d16 = 64, else 128; the columns past d16 are never
//     stored). Scores, e and o never touch shared memory. Issuing e v of
//     tile t - 1 under the softmax of tile t (as the streaming body does)
//     measured no faster here: it needs a third v slot and more registers,
//     and the blocks that share an SM already overlap one another.
//   * KS is a template argument, so every product is a fixed run of
//     `wgmma`s with no loop or branch inside (ptxas serialises products
//     around either).
//   * o goes out through the query tile, in 16-, 4- or 2-byte stores by
//     d (o is contiguous: its rows start on 16 bytes when d % 8 == 0, on 4
//     when d is even).
//   * Shared memory: q, and k and v each in a tile and a slot (a tile or a
//     staging area of 64 rows of DP / 8 + 1 chunks): 43 KB up to d16 = 64,
//     83 KB above. ptxas gives a thread 146-151 registers at KS <= 3 and
//     124 at KS = 4 (on an H100 with CUDA 12.8), so three blocks run on an
//     SM, four at KS = 4; above d16 = 64, 168 registers and the 83 KB hold
//     it to two. One block's `wgmma` runs while another waits for its
//     copies or sits in its softmax.
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// Copy widths (`row_width`) of q, k, v and of the stores of o.
struct FwdWidths {
  int q, k, v, o;
};

// One key tile of the online softmax of rows r0 and r0 + 8: the scores s
// become e = exp(s - m') in place (with MASK, keys at or past `valid` are
// left out of the max and give 0); m becomes the new running max m', l this
// thread's partial row sums, a the factors exp(m - m') that rescale o.
// Every tile holds a key below N, so m' is finite.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[32], int valid,
                                               int col0, float (&m)[2],
                                               float (&l)[2], float (&a)[2]) {
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
    a[r] = ex2((m[r] - mx[r]) * LOG2E);      // m = -inf: 0
    m[r] = mx[r];
    mx[r] *= LOG2E;
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

// KS: k-steps of q kᵀ, ceil(d / 16).
template <int KS>
__global__ void __launch_bounds__(WG, 2)
attention_fwd_unaligned_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, float* __restrict__ lse,
                               int N, int H, int d, Strides sq, Strides sk,
                               Strides sv, FwdWidths w) {
  constexpr int DP = panel_cols(KS);
  constexpr int T = ROWS * DP * 2;           // bytes of a 64-row tile
  constexpr int SLOT = T + slot_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // q; k and v each a tile and a second slot: its next tile, or the
  // staging area of its next tile
  const uint32_t Qs = smem_u32(smem), Ks = Qs + T, Vs = Ks + SLOT;
  const bool stage_k = w.k == 2, stage_v = w.v == 2;

  const int m0 = ROWS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const int ntiles = (N + ROWS - 1) / ROWS;

  // the first k, v tile (as every later one), then q: by cp.async, or
  // for rows on 2 bytes only staged (k, v) or through registers (q)
  auto copy_kv = [&](int t, int n1) {
    if (stage_k)
      stage_rows_async<DP>(Ks + T, kbh, sk.n, n1, N, d);
    else
      load_rows_async_width<DP>(w.k, Ks + (t & 1) * T, kbh, sk.n, n1, N, d);
    if (stage_v)
      stage_rows_async<DP>(Vs + T, vbh, sv.n, n1, N, d);
    else
      load_rows_async_width<DP>(w.v, Vs + (t & 1) * T, vbh, sv.n, n1, N, d);
    cp_async_commit();
  };
  copy_kv(0, 0);
  load_rows_width<DP>(w.q, Qs, q + b * sq.b + h * sq.h, sq.n, m0, N, d);
  cp_async_commit();

  float acc[DP / 2];                         // o, rows r0 and r0 + 8
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
  float s[32];                               // 64 x 64 scores, then e
  uint32_t p[4][4];                          // e, bf16, the A operand

  for (int t = 0; t < ntiles; ++t) {
    // a tile copied straight in alternates between the slots; a staged
    // one is shifted into the first
    const uint32_t Kt = Ks + (stage_k ? 0 : (t & 1) * T),
                   Vt = Vs + (stage_v ? 0 : (t & 1) * T);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                         // tile t is in; tile t - 1 is
                                             // read by no product any more
    if (stage_k || stage_v) {
      if (stage_k)
        unstage_rows<DP>(Ks, smem + (Ks - Qs) + T, kbh, sk.n, ROWS * t, N, d);
      if (stage_v)
        unstage_rows<DP>(Vs, smem + (Vs - Qs) + T, vbh, sv.n, ROWS * t, N, d);
      fence_proxy_async();
      __syncthreads();
    }
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, desc_kmajor(Qs, ROWS, 0, kk), desc_kmajor(Kt, ROWS, 0, kk),
               kk > 0);
    wgmma_commit();
    fence_regs(s);
    if (t + 1 < ntiles)                      // tile t + 1, under tile t
      copy_kv(t + 1, ROWS * (t + 1));
    wgmma_wait<0>();
    fence_regs(s);

    const int valid = N - ROWS * t;          // keys of the tile below N
    if (valid < ROWS)
      online_softmax<true>(s, valid, col0, m, l, a);
    else
      online_softmax<false>(s, valid, col0, m, l, a);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= a[0];
      acc[4 * j + 1] *= a[0];
      acc[4 * j + 2] *= a[1];
      acc[4 * j + 3] *= a[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int j = 4 * (2 * kk + g);
        p[kk][2 * g] = pack_bf16(s[j], s[j + 1]);
        p[kk][2 * g + 1] = pack_bf16(s[j + 2], s[j + 3]);
      }
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p[kk], desc_mnmajor(Vt, ROWS, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if ((lane & 3) == 0) {
    const long long bh = static_cast<long long>(b) * H + h;
    const int n0 = m0 + r0;
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
  __syncthreads();                           // no product reads q any more
  stage_acc_tile<DP>(acc, smem);
  __syncthreads();
  store_rows_width(w.o, smem,
                   o + ((static_cast<long long>(b) * N + m0) * H + h) * d,
                   static_cast<long long>(H) * d, N - m0, d);
}

// Dynamic shared memory of the kernel: q, two slots each of k and v,
// alignment slack.
template <int DP>
constexpr size_t fwd_unaligned_smem() {
  return size_t(ROWS) * DP * 2 + 2 * (size_t(ROWS) * DP * 2
                                      + slot_bytes<DP>()) + 1024;
}

template <int KS>
int launch_fwd_unaligned(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int H, int d,
                         const long long* st, cudaStream_t stream) {
  static bool ready[64] = {};
  auto kernel = attention_fwd_unaligned_kernel<KS>;
  cudaError_t err = allow_full_smem(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long so[3] = {static_cast<long long>(N) * H * d,
                           static_cast<long long>(H) * d, d};
  const FwdWidths w{row_width(q, st), row_width(k, st + 3),
                    row_width(v, st + 6), row_width(o, so)};
  kernel<<<dim3((N + ROWS - 1) / ROWS, H, B), WG,
           fwd_unaligned_smem<panel_cols(KS)>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 9 element strides, (batch, token, head) for q, k, v,
// any alignment (the head-dim stride is 1). o is contiguous (B, N, H, d),
// lse contiguous (B, H, N) fp32. Takes any N >= 1, any d in [1, 128], and
// B, H within the grid's limits; returns -1 for anything else, else
// cudaGetLastError() after the launch.
extern "C" int ofb_attention_fwd_unaligned(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int N, int H, int d,
                                           const long long* strides,
                                           void* stream) {
  using namespace ofb::sm90;
  if (N < 1 || d < 1 || d > 128 || B < 1 || B > 65535 || H < 1 ||
      H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define OFB_CASE(KS)                                                         \
  case KS:                                                                   \
    return launch_fwd_unaligned<KS>(q, k, v, o, lse, B, N, H, d, strides, s);
    OFB_CASE(1) OFB_CASE(2) OFB_CASE(3) OFB_CASE(4)
    OFB_CASE(5) OFB_CASE(6) OFB_CASE(7) OFB_CASE(8)
#undef OFB_CASE
  }
  return -1;
}
