// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the
// streaming body, bf16, any number of tokens, head dims 8 to 128 in steps
// of 8, 16-byte aligned rows.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)) above 256 tokens: DeiT at
// 384 pixels (N = 577), ViT-L/16-384, ViT-H/14 and the exported subnets
// finetuned there. The resident body (attention_fwd_resident.cu) keeps
// N <= 256, the general body (attention_fwd.cu) unaligned views and fp32.
// Same function: q arrives already scaled; scores, row max and row sums are
// fp32; e = exp(s - m) is rounded to bf16 before e v, unnormalised, and
// o /= l comes at the end; o is bf16; the row log-sum-exp goes out as fp32
// (B, H, N) for the backward.
//
// Bound. 4 B H N² d flops against 4 B N H d * 2 bytes: at N = 577, d = 64
// about 290 flops a byte, the H100's own balance (~295 bf16 flops a byte),
// so bytes and tensor work bound it alike (B = 256, H = 6: 0.1355 ms of
// bytes at 3.35 TB/s, 0.1324 ms of dense bf16 at 989 TFLOP/s). The
// exponentials come close too: B H N² of them at 16 a clock an SM is
// ~0.15 ms there. So the design keeps the tensor cores, the exponentials
// and the copies running at once.
//
// Design (sm90_tma.cuh): a persistent block an SM of three warpgroups.
//   * Work items are 128 query rows of one (batch, head), the query block
//     fastest, so the blocks that run together share a head's K and V in
//     L2. Consumer warpgroup w takes rows 64 w .. 64 w + 63 of the item.
//   * The producer's first thread loads each item's queries (two buffers,
//     so the next item's arrive during this one) and then its K and V, 128
//     keys a tile, by TMA into a ring of stages (4 at d16 <= 80): a full
//     barrier for K and one for V (expected bytes), an empty barrier that
//     the eight consumer warps arrive on once the e v that read the stage
//     has retired. No block barrier runs after the set-up. Tiles of 128
//     keys halve the waits, barriers and turns a key against 64, and q kᵀ
//     is a `wgmma` of n = 128 (probe_kernels at DeiT-S-384: 64-key tiles
//     took 0.49 ms, these 0.41).
//   * A consumer issues s = q kᵀ of tile t, then o += e v of tile t - 1,
//     then waits for s alone: the online softmax of tile t runs while e v
//     of tile t - 1 is in flight, and under the other consumer's products.
//     The two do not take turns at issuing (TURNS): ordering them by named
//     barriers (ping-pong) measured slower in the forward.
//   * Keys past N arrive as zeros and are left out of the row max; they
//     give e = 0 on the last tile. A last tile of up to 16 keys (N = 257,
//     1025: 128 t + 1) runs one 16-key step, one of up to 80 (577: 128 t +
//     65) five, into scores of their own. Every
//     product is a fixed run of `wgmma`s (k-steps a template argument),
//     with no branch inside: ptxas serialises products around a branch or
//     a loop.
//   * Head dims: d16 = 16 ceil(d / 16) <= 64 in one 64-column panel (the
//     columns past d zero); above it a tail of 16 (d16 = 80), 32 (96) or 64
//     columns with its own box, swizzle and `wgmma`, so ViT-H/14's d = 80
//     does not pay for 128 columns.
//   * The output goes through the item's query buffer and out by a TMA
//     store, which clips the rows past N; the buffer returns to the
//     producer once the store has read it.
#include "sm90_tma.cuh"

namespace ofb {
namespace sm90 {

constexpr int QROWS = CONSUMERS * ROWS;      // query rows an item
constexpr int KEYS = 2 * ROWS;               // keys a tile
// The consumers issue as they come: taking turns (sm90_tma.cuh ping-pong)
// measured 1-3% slower here (probe_kernels), while the backward gains 4%.
constexpr bool TURNS = false;
// K/V stages of the ring, as many as fit beside the query buffers
template <int TW>
__host__ __device__ constexpr int fwd_stages() {
  return TW <= 16 ? 4 : TW == 32 ? 3 : 2;
}

template <int TW>
struct FwdMaps {
  CUtensorMap q, k, v, o;                    // 64-column panels
  CUtensorMap qt, kt, vt, ot;                // the tails (TW > 0)
};

template <int TW>
constexpr size_t fwd_streaming_smem() {
  // two query buffers of two 64-row tiles, the ring of 128-key K, V
  // stages, 4 + 3 STAGES barriers, slack
  return size_t(Tile<TW>::BYTES) * 2 * CONSUMERS +
         size_t(Tile<TW, KEYS>::BYTES) * 2 * fwd_stages<TW>() +
         8 * (4 + 3 * fwd_stages<TW>()) + 1024;
}

// One key tile of the online softmax of rows r0 and r0 + 8: the scores s
// become e = exp(s - m') in place (keys at or past `valid` give 0 when
// MASK); m becomes the new running max m', l this thread's partial row
// sums, a the factors exp(m - m') that rescale o.
template <bool MASK, int NC>
__device__ __forceinline__ void online_softmax(float (&s)[NC], int valid,
                                               int col0, float (&m)[2],
                                               float (&l)[2],
                                               float (&a)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NC / 4; ++j)
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
  for (int j = 0; j < NC / 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = ex2(fmaf(s[4 * j + c], LOG2E, -mx[c >> 1]));
      s[4 * j + c] = !MASK || 8 * j + col0 + (c & 1) < valid ? x : 0.f;
      rs[c >> 1] += s[4 * j + c];
    }
  l[0] = l[0] * a[0] + rs[0];
  l[1] = l[1] * a[1] + rs[1];
}

// e of one key tile of 8 NC / 4 keys, bf16, as the register A operands of
// its NC / 8 k-steps.
template <int NC>
__device__ __forceinline__ void pack_tile(const float (&e)[NC],
                                          uint32_t (&p)[KEYS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < NC / 8; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g);
      p[kk][2 * g] = pack_bf16(e[j], e[j + 1]);
      p[kk][2 * g + 1] = pack_bf16(e[j + 2], e[j + 3]);
    }
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// KS: k-steps of q kᵀ, ceil(d / 16).
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd_streaming_kernel(
    const __grid_constant__ FwdMaps<tail_of(KS)> maps, float* __restrict__ lse,
    int N, int H, int items) {
  constexpr int TW = tail_of(KS), STAGES = fwd_stages<TW>();
  using T = Tile<TW>;                        // 64 query rows
  using TK = Tile<TW, KEYS>;                 // 128 keys
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Qb = smem_u32(smem);                    // [buffer][consumer]
  const uint32_t Ring = Qb + 2 * CONSUMERS * T::BYTES;   // [stage]: K, V
  const uint32_t Bars = Ring + 2 * STAGES * TK::BYTES;
  auto q_full = [&](int i) { return Bars + 8 * i; };
  auto q_empty = [&](int i) { return Bars + 16 + 8 * i; };
  auto k_full = [&](int s) { return Bars + 32 + 8 * s; };
  auto v_full = [&](int s) { return Bars + 32 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return Bars + 32 + 8 * (2 * STAGES + s); };
  auto stage = [&](int s) { return Ring + 2 * s * TK::BYTES; };

  const int nqb = (N + QROWS - 1) / QROWS, ntiles = (N + KEYS - 1) / KEYS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);    // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {                     // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG != 0) return;
    int g = 0;                               // tiles loaded so far
    for (int item = blockIdx.x, k = 0; item < items;
         item += gridDim.x, ++k) {
      const int qb = item % nqb, h = (item / nqb) % H, b = item / (nqb * H);
      const int buf = k & 1;
      if (k >= 2) mbar_wait(q_empty(buf), ((k >> 1) - 1) & 1);
      mbar_expect(q_full(buf), CONSUMERS * T::BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        const uint32_t dst = Qb + (CONSUMERS * buf + w) * T::BYTES;
        const int n0 = QROWS * qb + ROWS * w;
        tma_load(dst, &maps.q, q_full(buf), 0, n0, h, b);
        if (TW > 0)
          tma_load(dst + T::TAIL, &maps.qt, q_full(buf), 64, n0, h, b);
      }
      for (int t = 0; t < ntiles; ++t, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
        const uint32_t K = stage(s), V = K + TK::BYTES;
        mbar_expect(k_full(s), TK::BYTES);
        tma_load(K, &maps.k, k_full(s), 0, KEYS * t, h, b);
        if (TW > 0)
          tma_load(K + TK::TAIL, &maps.kt, k_full(s), 64, KEYS * t, h, b);
        mbar_expect(v_full(s), TK::BYTES);
        tma_load(V, &maps.v, v_full(s), 0, KEYS * t, h, b);
        if (TW > 0)
          tma_load(V + TK::TAIL, &maps.vt, v_full(s), 64, KEYS * t, h, b);
      }
    }
    return;
  }

  // a consumer: rows r0 and r0 + 8 of its 64, columns 8 j + col0 (+1)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % WG, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  if (TURNS) turn_start(wg);

  float s[KEYS / 2];                         // 64 x 128 scores, then e
  uint32_t p[KEYS / 16][4];                  // e, bf16, the A operand
  Acc<TW> o;                                 // 64 x DP output sums
  int g = 0, pending = -1;                   // a query buffer in a store
  // The last key tile holds rem = N - 128 (ntiles - 1) keys: up to 16 of
  // them (257 = 2 * 128 + 1: ViT-H/14; 1025) run one 16-key step, up to 80
  // (577 = 4 * 128 + 65: DeiT-S-384) five, each into scores of their own.
  float s1[8], s5[40];
  const int rem = N > KEYS ? N % KEYS : 0;
  const int narrow = rem == 0 ? 0 : rem <= 16 ? 1 : rem <= 80 ? 5 : 0;
  auto run_item = [&](int item, int k) {
    const int qb = item % nqb, h = (item / nqb) % H, b = item / (nqb * H);
    const bool last_item = item + static_cast<int>(gridDim.x) >= items;
    const int buf = k & 1;
    const uint32_t Q = Qb + (CONSUMERS * buf + wg) * T::BYTES;
    float m[2] = {-INFINITY, -INFINITY};     // running max, rows r0, r0 + 8
    float l[2] = {0.f, 0.f};                 // this thread's partial sums
    float a[2];                              // o's rescale factors
    // scores of a tile of 16 W keys (W = 8, or 1 in s1, 5 in s5)
    auto qk = [&](auto& sw, int st) {        // = q kᵀ of the stage's K
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(sw, desc_k<TW>(Q, 0, kk), desc_k<TW, KEYS>(stage(st), 0, kk),
                 kk > 0);
    };
    auto pv = [&](auto w, int st, int t) {   // o += e v (e = 0 past N)
      constexpr int W = decltype(w)::value;
      const uint32_t V = stage(st) + TK::BYTES;
#pragma unroll
      for (int kk = 0; kk < W; ++kk)
        o.template mma<KEYS>(p[kk], V, 16 * kk, t > 0 || kk > 0);
    };
    auto softmax = [&](auto& sw, int t) {    // sw becomes e
      if (t == ntiles - 1 && N % KEYS)
        online_softmax<true>(sw, N - KEYS * t, col0, m, l, a);
      else
        online_softmax<false>(sw, KEYS, col0, m, l, a);
    };
    // the registers the products read and write are defined before the
    // wgmma fence and not touched again until the wait that retires them
    // (the scores sw of this turn's q kᵀ, if any, e and o)
    auto pin = [&](auto& sw) {
      fence_regs(sw);
      fence_regs(p);
      o.fence();
    };
    // tile 0: s alone
    auto first = [&]() {
      const int st = g % STAGES;
      mbar_wait(q_full(buf), (k >> 1) & 1);
      mbar_wait(k_full(st), (g / STAGES) & 1);
      if (TURNS) turn_take(wg);
      pin(s);
      wgmma_fence();
      qk(s, st);
      wgmma_commit();
      pin(s);
      if (TURNS) turn_give(wg, false);
      if (pending >= 0 && tid == 0) {        // the last item's store has
        bulk_wait_read();                    // read its buffer
        mbar_arrive(q_empty(pending));
      }
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, 0);
      pack_tile(s, p);
    };
    // tile t: s (s1, s5) of tile t, then e v of the full tile t - 1
    auto step = [&](auto& sw, int t) {
      const int cur = (g + t) % STAGES, prev = (g + t - 1) % STAGES;
      mbar_wait(k_full(cur), ((g + t) / STAGES) & 1);
      mbar_wait(v_full(prev), ((g + t - 1) / STAGES) & 1);
      if (TURNS) turn_take(wg);
      pin(sw);
      wgmma_fence();
      qk(sw, cur);
      wgmma_commit();
      pv(Int<KEYS / 16>{}, prev, t - 1);
      wgmma_commit();
      pin(sw);
      if (TURNS) turn_give(wg, false);
      wgmma_wait<1>();                       // s of tile t
      fence_regs(sw);
      softmax(sw, t);
      wgmma_wait<0>();                       // e v of tile t - 1
      o.fence();
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty(prev));
      o.scale(a[0], a[1]);
      pack_tile(sw, p);
    };
    // e v of the last tile
    auto last = [&](auto w) {
      const int t = ntiles - 1, cur = (g + t) % STAGES;
      mbar_wait(v_full(cur), ((g + t) / STAGES) & 1);
      if (TURNS) turn_take(wg);
      pin(p);
      wgmma_fence();
      pv(w, cur, t);
      wgmma_commit();
      pin(p);
      if (TURNS) turn_give(wg, last_item);
      wgmma_wait<0>();
      o.fence();
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty(cur));
    };

    first();
    for (int t = 1; t < ntiles - 1; ++t) step(s, t);
    if (narrow == 1) {
      step(s1, ntiles - 1);
      last(Int<1>{});
    } else if (narrow == 5) {
      step(s5, ntiles - 1);
      last(Int<5>{});
    } else {
      if (ntiles > 1) step(s, ntiles - 1);
      last(Int<KEYS / 16>{});
    }
    g += ntiles;

    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const int row0 = QROWS * qb + ROWS * wg;
    if ((lane & 3) == 0) {
      const long long bh = static_cast<long long>(b) * H + h;
      const int n0 = row0 + r0;
      if (n0 < N) lse[bh * N + n0] = m[0] + logf(l[0]);
      if (n0 + 8 < N) lse[bh * N + n0 + 8] = m[1] + logf(l[1]);
    }
    o.scale(1.f / l[0], 1.f / l[1]);
    bar_sync(WG_BAR + wg, WG);               // no product reads q any more
    o.write(smem + (Q - Qb), r0, lane);
    fence_proxy_async();
    bar_sync(WG_BAR + wg, WG);
    if (tid == 0) {
      tma_store(&maps.o, Q, 0, row0, h, b);
      if (TW > 0) tma_store(&maps.ot, Q + T::TAIL, 64, row0, h, b);
      bulk_commit();
    }
    pending = buf;
  };
  for (int item = blockIdx.x, k = 0; item < items; item += gridDim.x, ++k)
    run_item(item, k);
  if (tid == 0) bulk_wait();
}

template <int KS>
int launch_fwd_streaming(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int H, int d,
                         const long long* st, cudaStream_t stream) {
  constexpr int TW = tail_of(KS);
  FwdMaps<TW> maps;
  const long long so[3] = {static_cast<long long>(N) * H * d,
                           static_cast<long long>(H) * d, d};
  int rc = encode_operand<TW>(&maps.q, &maps.qt, q, B, N, H, d, st);
  if (rc == 0)
    rc = encode_operand<TW>(&maps.k, &maps.kt, k, B, N, H, d, st + 3, KEYS);
  if (rc == 0)
    rc = encode_operand<TW>(&maps.v, &maps.vt, v, B, N, H, d, st + 6, KEYS);
  if (rc == 0) rc = encode_operand<TW>(&maps.o, &maps.ot, o, B, N, H, d, so);
  if (rc != 0) return rc;
  static bool ready[64] = {};
  auto kernel = attention_fwd_streaming_kernel<KS>;
  cudaError_t err = allow_full_smem(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>((N + QROWS - 1) / QROWS) * H * B;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  kernel<<<grid, THREADS, fwd_streaming_smem<TW>(), stream>>>(
      maps, static_cast<float*>(lse), N, H, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 9 element strides, (batch, token, head) for q, k, v.
// o is contiguous (B, N, H, d), lse contiguous (B, H, N) fp32. Takes any
// N >= 1, d a multiple of 8 up to 128, 16-byte aligned rows, and B, H
// within the grid's limits; returns -1 for anything else, a code of
// sm90_tma.cuh if a tensor map cannot be encoded, else cudaGetLastError()
// after the launch.
extern "C" int ofb_attention_fwd_streaming(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int N, int H, int d,
                                           const long long* strides,
                                           void* stream) {
  using namespace ofb::sm90;
  const void* ptrs[3] = {q, k, v};
  if (N < 1 || d < 8 || d > 128 || d % 8 != 0 || B < 1 || B > 65535 ||
      H < 1 || H > 65535 || !aligned_16(ptrs, strides, 3) ||
      static_cast<long long>((N + QROWS - 1) / QROWS) * H * B >= (1LL << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define OFB_CASE(KS)                                                         \
  case KS:                                                                   \
    return launch_fwd_streaming<KS>(q, k, v, o, lse, B, N, H, d, strides, s);
    OFB_CASE(1) OFB_CASE(2) OFB_CASE(3) OFB_CASE(4)
    OFB_CASE(5) OFB_CASE(6) OFB_CASE(7) OFB_CASE(8)
#undef OFB_CASE
  }
  return -1;
}
