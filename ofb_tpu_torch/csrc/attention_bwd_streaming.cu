// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the streaming body, bf16, any number of tokens, head dims 8 to 128 in
// steps of 8, 16-byte aligned rows.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)) above 256 tokens (DeiT at
// 384 pixels: N = 577); attention_bwd_resident.cu keeps N <= 256 and
// attention_bwd.cu unaligned views and fp32. Same math, no scale inside:
//   p  = exp(q kᵀ − lse)                     lse from the forward, fp32
//   dv = pᵀ do                               p rounded to bf16
//   dp = do vᵀ                               fp32
//   ds = p ⊙ (dp − delta)                    delta = rowsum(do ⊙ o), fp32;
//                                            ds rounded to bf16
//   dq = ds k,  dk = dsᵀ q                   fp32 sums, bf16 out
//
// Bound. 10 B H N² d flops for the five products against seven (B, N, H, d)
// tensors: at N = 577, d = 64 about 410 flops a byte, above the H100's
// ~295, so the tensor cores bound it (B = 256, H = 6: 0.3309 ms at 989
// TFLOP/s, 0.2370 ms of bytes). This design recomputes q kᵀ and do vᵀ in
// both of its kernels, 14 B H N² d flops: its own floor is 0.4633 ms there.
//
// Design. dk and dv sum over queries and dq over keys; Hopper blocks carry
// no sums between them and atomics would change dq from run to run. So two
// kernels, each summing in registers what it walks over, deterministic like
// both other bodies; one wrapper call launches both. Each is a persistent
// block an SM of a producer warpgroup, whose first thread drives TMA into
// mbarrier rings, and two consumer warpgroups on `wgmma`, 64 resident rows
// each, that take turns at issuing products (sm90_tma.cuh):
//   * dq kernel: an item is 128 queries of one (batch, head); q, do and o
//     arrive by TMA (two buffers at d16 <= 96, so the next item's arrive
//     during this one). delta = rowsum(do ⊙ o) of the item's rows is taken
//     from shared memory first and written out for the second kernel. K
//     and V stream 64 keys at a time through a ring. Per tile: s = q kᵀ and
//     dp = do vᵀ by `wgmma` into registers, p and ds formed there, ds the
//     register A operand of dq += ds k with k read MN-major from the stage
//     that gave s K-major. Tile t's s and dp are issued before tile t - 1's
//     dq product and waited for alone, so the exponentials of tile t run
//     while that product is in flight. Keys past N give p = 0. Every
//     product is a fixed run of `wgmma`s (k-steps a template argument).
//   * dk/dv kernel: an item is 128 keys, k and v resident. Q and dO stream
//     through the ring by TMA; the 64 queries' lse and delta ride in the
//     same stage, copied 4 bytes a lane by the producer's warp (cp.async,
//     completing on the stage's barrier: rows of N fp32 are not 16-byte
//     aligned for a bulk copy). It computes the transposed tiles, sᵀ =
//     k qᵀ and dpᵀ = v doᵀ, so pᵀ and dsᵀ land in accumulator layout and
//     are the register A operands of dv += pᵀ do and dk += dsᵀ q (do and q
//     MN-major): no trip through shared memory. Queries past N read lse =
//     delta = 0 and give p = 0. At d16 <= 96 the next
//     tile's sᵀ and dpᵀ are issued before this tile's products, as in the
//     dq kernel; at 128 columns the registers do not hold both, and the
//     two run one after the other.
//   * Head dims as in the forward: a 64-column panel and a tail of 16, 32
//     or 64 columns; the outputs leave through the resident buffers by
//     TMA stores.
#include "sm90_tma.cuh"

namespace ofb {
namespace sm90 {

constexpr int BROWS = CONSUMERS * ROWS;      // resident rows an item

// resident buffers of the two kernels: two while they fit beside their
// rings; the rings as deep as the rest of shared memory allows, up to 6
// and 8 stages (probe_kernels: 4 and 4 took 4% longer at DeiT-S-384)
template <int TW>
__host__ __device__ constexpr int res_buffers() { return TW <= 32 ? 2 : 1; }
template <int TW>
__host__ __device__ constexpr int dq_stages() {
  return TW == 0 ? 6 : TW == 16 ? 4 : 3;
}
template <int TW>
__host__ __device__ constexpr int kv_stages() {
  return TW == 0 ? 8 : TW == 16 ? 6 : 4;
}
// the dk/dv kernel overlaps a tile's products with the next tile's sᵀ, dpᵀ
template <int TW>
__host__ __device__ constexpr bool kv_pipelined() { return TW < 64; }

template <int TW>
constexpr size_t dq_streaming_smem() {
  // q, do, o of both consumers a buffer; K and V a stage; barriers; slack
  return size_t(Tile<TW>::BYTES) *
             (3 * CONSUMERS * res_buffers<TW>() + 2 * dq_stages<TW>()) +
         8 * (4 + 2 * dq_stages<TW>()) + 1024;
}

template <int TW>
constexpr size_t dkdv_streaming_smem() {
  // k, v of both consumers a buffer; Q, dO, lse | delta a stage
  return size_t(Tile<TW>::BYTES) * 2 * CONSUMERS * res_buffers<TW>() +
         size_t(2 * Tile<TW>::BYTES + 1024) * kv_stages<TW>() +
         8 * (4 + 2 * kv_stages<TW>()) + 1024;
}

// p = exp(s - lse), with lse already times log2 e.
__device__ __forceinline__ float p_of(float s, float lse2) {
  return ex2(fmaf(s, LOG2E, -lse2));
}

// Two fp32 tiles as the register A operands of four k-steps, bf16.
__device__ __forceinline__ void pack_tile(const float (&x)[32],
                                          uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g);
      p[kk][2 * g] = pack_bf16(x[j], x[j + 1]);
      p[kk][2 * g + 1] = pack_bf16(x[j + 2], x[j + 3]);
    }
}

template <int TW>
struct DqMaps {
  CUtensorMap q, k, v, o, dout, dq;          // 64-column panels
  CUtensorMap qt, kt, vt, ot, dot, dqt;      // the tails (TW > 0)
};

// KS: k-steps of the K-major products, ceil(d / 16).
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_streaming_kernel(
    const __grid_constant__ DqMaps<tail_of(KS)> maps,
    const float* __restrict__ lse, float* __restrict__ delta, int N, int H,
    int d, int items) {
  constexpr int TW = tail_of(KS);
  using T = Tile<TW>;
  constexpr int RB = res_buffers<TW>(), STAGES = dq_stages<TW>();
  constexpr int RES = 3 * CONSUMERS * T::BYTES;   // q, do, o of a buffer
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Res = smem_u32(smem);
  const uint32_t Ring = Res + RB * RES;           // [stage]: K, V
  const uint32_t Bars = Ring + 2 * STAGES * T::BYTES;
  auto res_full = [&](int i) { return Bars + 8 * i; };
  auto res_empty = [&](int i) { return Bars + 16 + 8 * i; };
  auto full = [&](int s) { return Bars + 32 + 8 * s; };
  auto empty = [&](int s) { return Bars + 32 + 8 * (STAGES + s); };
  auto stage = [&](int s) { return Ring + 2 * s * T::BYTES; };
  // tile j of a buffer: q of consumer w at j = w, do at 2 + w, o at 4 + w
  auto res_tile = [&](int buf, int j) {
    return Res + buf * RES + j * T::BYTES;
  };

  const int nqb = (N + BROWS - 1) / BROWS, ntiles = (N + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(res_full(i), 1);
      mbar_init(res_empty(i), CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {                     // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % WG != 0) return;
    int g = 0;
    for (int item = blockIdx.x, k = 0; item < items;
         item += gridDim.x, ++k) {
      const int qb = item % nqb, h = (item / nqb) % H, b = item / (nqb * H);
      const int buf = k % RB;
      if (k >= RB) mbar_wait(res_empty(buf), (k / RB - 1) & 1);
      mbar_expect(res_full(buf), 3 * CONSUMERS * T::BYTES);
      auto load = [&](uint32_t dst, const CUtensorMap* panel,
                      const CUtensorMap* tail, int n0) {
        tma_load(dst, panel, res_full(buf), 0, n0, h, b);
        if (TW > 0) tma_load(dst + T::TAIL, tail, res_full(buf), 64, n0, h, b);
      };
      for (int w = 0; w < CONSUMERS; ++w) {
        const int n0 = BROWS * qb + ROWS * w;
        load(res_tile(buf, w), &maps.q, &maps.qt, n0);
        load(res_tile(buf, 2 + w), &maps.dout, &maps.dot, n0);
        load(res_tile(buf, 4 + w), &maps.o, &maps.ot, n0);
      }
      for (int t = 0; t < ntiles; ++t, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
        const uint32_t K = stage(s), V = K + T::BYTES;
        mbar_expect(full(s), 2 * T::BYTES);
        tma_load(K, &maps.k, full(s), 0, ROWS * t, h, b);
        tma_load(V, &maps.v, full(s), 0, ROWS * t, h, b);
        if (TW > 0) {
          tma_load(K + T::TAIL, &maps.kt, full(s), 64, ROWS * t, h, b);
          tma_load(V + T::TAIL, &maps.vt, full(s), 64, ROWS * t, h, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % WG, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  turn_start(wg);

  float s[32], dp[32];                       // scores, then p; do vᵀ, then ds
  uint32_t ds[4][4];                         // ds, bf16, the A operand
  Acc<TW> acc;                               // dq
  int g = 0, pending = -1;
  for (int item = blockIdx.x, k = 0; item < items; item += gridDim.x, ++k) {
    const int qb = item % nqb, h = (item / nqb) % H, b = item / (nqb * H);
    const bool last_item = item + static_cast<int>(gridDim.x) >= items;
    const int buf = k % RB;
    const long long bh = static_cast<long long>(b) * H + h;
    const int row0 = BROWS * qb + ROWS * wg;
    const uint32_t Q = res_tile(buf, wg), dO = res_tile(buf, 2 + wg),
                   O = res_tile(buf, 4 + wg);
    const int n0 = row0 + r0;
    const float lse0 = n0 < N ? lse[bh * N + n0] * LOG2E : 0.f;
    const float lse1 = n0 + 8 < N ? lse[bh * N + n0 + 8] * LOG2E : 0.f;

    mbar_wait(res_full(buf), (k / RB) & 1);
    float dl0, dl1;
    {  // delta = rowsum(do ⊙ o): two threads a row, 16 bytes a read
      const int r = tid >> 1, half = tid & 1;
      float x = 0.f;
      for (int c = half; c < (d >> 3); c += 2)
        x += dot8(tile_chunk<TW>(smem + (dO - Res), r, c),
                  tile_chunk<TW>(smem + (O - Res), r, c));
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      if (half == 0 && row0 + r < N) delta[bh * N + row0 + r] = x;
      dl0 = __shfl_sync(0xffffffffu, x, 2 * (lane >> 2));
      dl1 = __shfl_sync(0xffffffffu, x, 2 * (lane >> 2) + 16);
    }
    auto sdp = [&](int st) {                 // s = q kᵀ, dp = do vᵀ
      const uint32_t K = stage(st), V = K + T::BYTES;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(s, desc_k<TW>(Q, 0, kk), desc_k<TW>(K, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(dp, desc_k<TW>(dO, 0, kk), desc_k<TW>(V, 0, kk), kk > 0);
    };
    auto dq_mma = [&](int st, int t) {       // dq += ds k (ds = 0 past N)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc.mma(ds[kk], stage(st), 16 * kk, t > 0 || kk > 0);
    };
    auto pin = [&]() {                       // as in the forward
      fence_regs(s);
      fence_regs(dp);
      fence_regs(ds);
      acc.fence();
    };
    auto grads = [&](int t) {                // dp becomes ds, fp32
      const int valid = N - ROWS * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          const float pv = p_of(s[i], c < 2 ? lse0 : lse1);
          const float x = pv * (dp[i] - (c < 2 ? dl0 : dl1));
          dp[i] = 8 * j + col0 + (c & 1) < valid ? x : 0.f;
        }
    };

    mbar_wait(full(g % STAGES), (g / STAGES) & 1);
    turn_take(wg);
    pin();
    wgmma_fence();
    sdp(g % STAGES);
    wgmma_commit();
    pin();
    turn_give(wg, false);
    if (pending >= 0 && tid == 0) {
      bulk_wait_read();
      mbar_arrive(res_empty(pending));
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grads(0);
    pack_tile(dp, ds);

    for (int t = 1; t < ntiles; ++t) {
      const int cur = (g + t) % STAGES, prev = (g + t - 1) % STAGES;
      mbar_wait(full(cur), ((g + t) / STAGES) & 1);
      turn_take(wg);
      pin();
      wgmma_fence();
      sdp(cur);
      wgmma_commit();
      dq_mma(prev, t - 1);
      wgmma_commit();
      pin();
      turn_give(wg, false);
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      grads(t);
      wgmma_wait<0>();
      acc.fence();
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty(prev));
      pack_tile(dp, ds);
    }
    {
      const int t = ntiles - 1, cur = (g + t) % STAGES;
      turn_take(wg);
      pin();
      wgmma_fence();
      dq_mma(cur, t);
      wgmma_commit();
      pin();
      turn_give(wg, last_item);
      wgmma_wait<0>();
      acc.fence();
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty(cur));
    }
    g += ntiles;

    bar_sync(WG_BAR + wg, WG);               // no product reads q any more
    acc.write(smem + (Q - Res), r0, lane);
    fence_proxy_async();
    bar_sync(WG_BAR + wg, WG);
    if (tid == 0) {
      tma_store(&maps.dq, Q, 0, row0, h, b);
      if (TW > 0) tma_store(&maps.dqt, Q + T::TAIL, 64, row0, h, b);
      bulk_commit();
      if (RB == 1) {                         // the producer waits for it
        bulk_wait_read();
        mbar_arrive(res_empty(buf));
      }
    }
    pending = RB == 1 ? -1 : buf;
  }
  if (tid == 0) bulk_wait();
}

template <int TW>
struct KvMaps {
  CUtensorMap q, k, v, dout, dk, dv;         // 64-column panels
  CUtensorMap qt, kt, vt, dot, dkt, dvt;     // the tails (TW > 0)
};

template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkdv_streaming_kernel(
    const __grid_constant__ KvMaps<tail_of(KS)> maps,
    const float* __restrict__ lse, const float* __restrict__ delta, int N,
    int H, int items) {
  constexpr int TW = tail_of(KS);
  using T = Tile<TW>;
  constexpr int RB = res_buffers<TW>(), STAGES = kv_stages<TW>();
  constexpr bool PIPE = kv_pipelined<TW>();
  constexpr int RES = 2 * CONSUMERS * T::BYTES;   // k, v of a buffer
  constexpr int STAGE = 2 * T::BYTES + 1024;      // Q, dO, lse | delta
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Res = smem_u32(smem);
  const uint32_t Ring = Res + RB * RES;
  const uint32_t Bars = Ring + STAGES * STAGE;
  auto res_full = [&](int i) { return Bars + 8 * i; };
  auto res_empty = [&](int i) { return Bars + 16 + 8 * i; };
  auto full = [&](int s) { return Bars + 32 + 8 * s; };
  auto empty = [&](int s) { return Bars + 32 + 8 * (STAGES + s); };
  auto stage = [&](int s) { return Ring + s * STAGE; };
  // tile j of a buffer: k of consumer w at j = w, v at 2 + w
  auto res_tile = [&](int buf, int j) {
    return Res + buf * RES + j * T::BYTES;
  };

  const int nkb = (N + BROWS - 1) / BROWS, ntiles = (N + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(res_full(i), 1);
      mbar_init(res_empty(i), CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 32);            // TMA, and the warp's copies
      mbar_init(empty(s), CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {                     // the producer: its first warp
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % WG;
    if (lane >= 32) return;
    int g = 0;
    for (int item = blockIdx.x, k = 0; item < items;
         item += gridDim.x, ++k) {
      const int kb = item % nkb, h = (item / nkb) % H, b = item / (nkb * H);
      const long long bhn = (static_cast<long long>(b) * H + h) * N;
      const int buf = k % RB;
      if (k >= RB) mbar_wait(res_empty(buf), (k / RB - 1) & 1);
      if (lane == 0) {
        mbar_expect(res_full(buf), 2 * CONSUMERS * T::BYTES);
        for (int w = 0; w < CONSUMERS; ++w) {
          const int n0 = BROWS * kb + ROWS * w;
          const uint32_t K = res_tile(buf, w), V = res_tile(buf, 2 + w);
          tma_load(K, &maps.k, res_full(buf), 0, n0, h, b);
          tma_load(V, &maps.v, res_full(buf), 0, n0, h, b);
          if (TW > 0) {
            tma_load(K + T::TAIL, &maps.kt, res_full(buf), 64, n0, h, b);
            tma_load(V + T::TAIL, &maps.vt, res_full(buf), 64, n0, h, b);
          }
        }
      }
      for (int t = 0; t < ntiles; ++t, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
        const uint32_t Qt = stage(s), dOt = Qt + T::BYTES;
        if (lane == 0) {
          mbar_expect(full(s), 2 * T::BYTES);
          tma_load(Qt, &maps.q, full(s), 0, ROWS * t, h, b);
          tma_load(dOt, &maps.dout, full(s), 0, ROWS * t, h, b);
          if (TW > 0) {
            tma_load(Qt + T::TAIL, &maps.qt, full(s), 64, ROWS * t, h, b);
            tma_load(dOt + T::TAIL, &maps.dot, full(s), 64, ROWS * t, h, b);
          }
        }
        // the 64 queries' lse (lanes 0-15) and delta (16-31), 4 a lane;
        // queries past N read as 0
        const float* src = (lane < 16 ? lse : delta) + bhn;
        const uint32_t dst = Qt + 2 * T::BYTES + 4 * (lane / 16) * ROWS;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = 4 * (lane % 16) + j, n = ROWS * t + x;
          cp_async_4(dst + 4 * x, src + (n < N ? n : 0), n < N ? 4 : 0);
        }
        cp_async_mbar_arrive(full(s));
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % WG, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  turn_start(wg);

  float st[32], dpt[32];                     // sᵀ, then pᵀ; dpᵀ, then dsᵀ
  uint32_t pt[4][4], dst[4][4];              // pᵀ, dsᵀ, bf16, A operands
  Acc<TW> acc_k, acc_v;
  int g = 0, pending = -1;
  for (int item = blockIdx.x, k = 0; item < items; item += gridDim.x, ++k) {
    const int kb = item % nkb, h = (item / nkb) % H, b = item / (nkb * H);
    const bool last_item = item + static_cast<int>(gridDim.x) >= items;
    const int buf = k % RB;
    const int row0 = BROWS * kb + ROWS * wg;
    const uint32_t K = res_tile(buf, wg), V = res_tile(buf, 2 + wg);

    auto sdp = [&](int s) {                  // sᵀ = k qᵀ, dpᵀ = v doᵀ
      const uint32_t Qt = stage(s), dOt = Qt + T::BYTES;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(st, desc_k<TW>(K, 0, kk), desc_k<TW>(Qt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(dpt, desc_k<TW>(V, 0, kk), desc_k<TW>(dOt, 0, kk), kk > 0);
    };
    auto kv_mma = [&](int s, int t) {        // dv += pᵀ do, dk += dsᵀ q
      const uint32_t Qt = stage(s), dOt = Qt + T::BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_v.mma(pt[kk], dOt, 16 * kk, t > 0 || kk > 0);
        acc_k.mma(dst[kk], Qt, 16 * kk, t > 0 || kk > 0);
      }
    };
    auto grads = [&](int s, int t) {         // sᵀ becomes pᵀ, dpᵀ dsᵀ
      const float* lse_t = reinterpret_cast<const float*>(
          smem + (stage(s) - Res) + 2 * T::BYTES);
      const float* delta_t = lse_t + ROWS;
      const int valid = N - ROWS * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + col0;
        const float2 l = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
        const float lc[2] = {l.x * LOG2E, l.y * LOG2E}, dc[2] = {dl.x, dl.y};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          const bool in = col + (c & 1) < valid;
          const float pv = in ? p_of(st[i], lc[c & 1]) : 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - dc[c & 1]);
        }
      }
    };
    auto pin = [&]() {                       // as in the forward
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(pt);
      fence_regs(dst);
      acc_k.fence();
      acc_v.fence();
    };
    auto release_pending = [&]() {
      if (pending >= 0 && tid == 0) {
        bulk_wait_read();
        mbar_arrive(res_empty(pending));
      }
    };

    mbar_wait(res_full(buf), (k / RB) & 1);
    if constexpr (PIPE) {
      mbar_wait(full(g % STAGES), (g / STAGES) & 1);
      turn_take(wg);
      pin();
      wgmma_fence();
      sdp(g % STAGES);
      wgmma_commit();
      pin();
      turn_give(wg, false);
      release_pending();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grads(g % STAGES, 0);
      pack_tile(st, pt);
      pack_tile(dpt, dst);
      for (int t = 1; t < ntiles; ++t) {
        const int cur = (g + t) % STAGES, prev = (g + t - 1) % STAGES;
        mbar_wait(full(cur), ((g + t) / STAGES) & 1);
        turn_take(wg);
        pin();
        wgmma_fence();
        sdp(cur);
        wgmma_commit();
        kv_mma(prev, t - 1);
        wgmma_commit();
        pin();
        turn_give(wg, false);
        wgmma_wait<1>();
        fence_regs(st);
        fence_regs(dpt);
        grads(cur, t);
        wgmma_wait<0>();
        acc_k.fence();
        acc_v.fence();
        fence_regs(pt);
        fence_regs(dst);
        if (lane == 0) mbar_arrive(empty(prev));
        pack_tile(st, pt);
        pack_tile(dpt, dst);
      }
      {
        const int t = ntiles - 1, cur = (g + t) % STAGES;
        turn_take(wg);
        pin();
        wgmma_fence();
        kv_mma(cur, t);
        wgmma_commit();
        pin();
        turn_give(wg, last_item);
        wgmma_wait<0>();
        acc_k.fence();
        acc_v.fence();
        fence_regs(pt);
        fence_regs(dst);
        if (lane == 0) mbar_arrive(empty(cur));
      }
    } else {
      for (int t = 0; t < ntiles; ++t) {
        const int cur = (g + t) % STAGES;
        mbar_wait(full(cur), ((g + t) / STAGES) & 1);
        turn_take(wg);
        pin();
        wgmma_fence();
        sdp(cur);
        wgmma_commit();
        pin();
        turn_give(wg, false);
        if (t == 0) release_pending();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        grads(cur, t);
        pack_tile(st, pt);
        pack_tile(dpt, dst);
        turn_take(wg);
        pin();
        wgmma_fence();
        kv_mma(cur, t);
        wgmma_commit();
        pin();
        turn_give(wg, last_item && t == ntiles - 1);
        wgmma_wait<0>();
        acc_k.fence();
        acc_v.fence();
        fence_regs(pt);
        fence_regs(dst);
        if (lane == 0) mbar_arrive(empty(cur));
      }
    }
    g += ntiles;

    bar_sync(WG_BAR + wg, WG);               // no product reads k, v any more
    acc_k.write(smem + (K - Res), r0, lane);
    acc_v.write(smem + (V - Res), r0, lane);
    fence_proxy_async();
    bar_sync(WG_BAR + wg, WG);
    if (tid == 0) {
      tma_store(&maps.dk, K, 0, row0, h, b);
      tma_store(&maps.dv, V, 0, row0, h, b);
      if (TW > 0) {
        tma_store(&maps.dkt, K + T::TAIL, 64, row0, h, b);
        tma_store(&maps.dvt, V + T::TAIL, 64, row0, h, b);
      }
      bulk_commit();
      if (RB == 1) {
        bulk_wait_read();
        mbar_arrive(res_empty(buf));
      }
    }
    pending = RB == 1 ? -1 : buf;
  }
  if (tid == 0) bulk_wait();
}

template <int KS>
int launch_bwd_streaming(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int N, int H, int d, const long long* st,
                         cudaStream_t stream) {
  constexpr int TW = tail_of(KS);
  const long long sc[3] = {static_cast<long long>(N) * H * d,
                           static_cast<long long>(H) * d, d};
  DqMaps<TW> mq;
  int rc = encode_operand<TW>(&mq.q, &mq.qt, q, B, N, H, d, st);
  if (rc == 0) rc = encode_operand<TW>(&mq.k, &mq.kt, k, B, N, H, d, st + 3);
  if (rc == 0) rc = encode_operand<TW>(&mq.v, &mq.vt, v, B, N, H, d, st + 6);
  if (rc == 0) rc = encode_operand<TW>(&mq.o, &mq.ot, o, B, N, H, d, st + 9);
  if (rc == 0)
    rc = encode_operand<TW>(&mq.dout, &mq.dot, dout, B, N, H, d, st + 12);
  if (rc == 0) rc = encode_operand<TW>(&mq.dq, &mq.dqt, dq, B, N, H, d, sc);
  KvMaps<TW> mk;
  mk.q = mq.q, mk.k = mq.k, mk.v = mq.v, mk.dout = mq.dout;
  mk.qt = mq.qt, mk.kt = mq.kt, mk.vt = mq.vt, mk.dot = mq.dot;
  if (rc == 0) rc = encode_operand<TW>(&mk.dk, &mk.dkt, dk, B, N, H, d, sc);
  if (rc == 0) rc = encode_operand<TW>(&mk.dv, &mk.dvt, dv, B, N, H, d, sc);
  if (rc != 0) return rc;

  static bool ready_dq[64] = {}, ready_kv[64] = {};
  const long long items =
      static_cast<long long>((N + BROWS - 1) / BROWS) * H * B;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  cudaError_t err =
      allow_full_smem(attention_bwd_dq_streaming_kernel<KS>, ready_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_streaming_kernel<KS>
      <<<grid, THREADS, dq_streaming_smem<TW>(), stream>>>(
          mq, static_cast<const float*>(lse), static_cast<float*>(delta), N,
          H, d, static_cast<int>(items));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_full_smem(attention_bwd_dkdv_streaming_kernel<KS>, ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_streaming_kernel<KS>
      <<<grid, THREADS, dkdv_streaming_smem<TW>(), stream>>>(
          mk, static_cast<const float*>(lse),
          static_cast<const float*>(delta), N, H, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 15 element strides, (batch, token, head) for q, k, v,
// o, do. lse and delta are contiguous (B, H, N) fp32 (delta is scratch the
// call fills); dq, dk, dv are contiguous (B, N, H, d). Takes any N >= 1,
// d a multiple of 8 up to 128, 16-byte aligned rows, and B, H within the
// grid's limits; returns -1 for anything else, a code of sm90_tma.cuh if a
// tensor map cannot be encoded, else cudaGetLastError() after the launches.
extern "C" int ofb_attention_bwd_streaming(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk,
                                           void* dv, int B, int N, int H,
                                           int d, const long long* strides,
                                           void* stream) {
  using namespace ofb::sm90;
  const void* ptrs[5] = {q, k, v, o, dout};
  if (N < 1 || d < 8 || d > 128 || d % 8 != 0 || B < 1 || B > 65535 ||
      H < 1 || H > 65535 || !aligned_16(ptrs, strides, 5) ||
      static_cast<long long>(B) * H * N >= (1LL << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define OFB_CASE(KS)                                                         \
  case KS:                                                                   \
    return launch_bwd_streaming<KS>(q, k, v, o, dout, lse, delta, dq, dk, dv, \
                                    B, N, H, d, strides, s);
    OFB_CASE(1) OFB_CASE(2) OFB_CASE(3) OFB_CASE(4)
    OFB_CASE(5) OFB_CASE(6) OFB_CASE(7) OFB_CASE(8)
#undef OFB_CASE
  }
  return -1;
}
