// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the resident body, bf16, up to 256 tokens, 16-byte aligned rows.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)) at the shapes the search
// step runs (DeiT: N = 197, d = 64); attention_bwd.cu keeps the general
// body for everything else. Same math, no scale inside:
//   p  = softmax(q kᵀ) = exp(q kᵀ − lse)    lse from the forward, fp32
//   dv = pᵀ do                               p rounded to bf16
//   dp = do vᵀ                               fp32
//   ds = p ⊙ (dp − delta)                    delta = rowsum(do ⊙ o), fp32;
//                                            ds rounded to bf16
//   dq = ds k,  dk = dsᵀ q                   fp32 sums, bf16 out
//
// Bound. 10 B H N² d flops for the five products against seven (B, N, H, d)
// tensors: about 140 flops a byte at N = 197, under the H100's ~295, so
// device memory bounds it (B = 256: 271 MB, ~81 us at 3.35 TB/s).
//
// Design. dk and dv sum over queries and dq over keys, and Hopper blocks
// cannot carry sums between them. So the work is two passes, each summing in
// registers what it walks over, without atomics (their order would change dq
// from run to run):
//   * the dq pass takes 64 queries at a time (the `wgmma` M) and walks the
//     keys 64 a step: s = q kᵀ and dp = do vᵀ leave `wgmma` in registers,
//     ds is formed there and is the register A operand of dq += ds k, with
//     k read MN-major from the tile that gave s K-major;
//   * the dk/dv pass takes 64 keys at a time and walks the queries. It
//     computes the transposed tiles directly, sᵀ = k qᵀ and dpᵀ = v doᵀ, so
//     pᵀ and dsᵀ are register A operands of dv += pᵀ do and dk += dsᵀ q,
//     with do and q read MN-major. lse and delta of all queries sit in
//     shared memory; a thread needs those of its columns.
//   Nothing but operands and finished output tiles touches shared memory.
//   All copies are 16-byte `cp.async` into the swizzled tiles of sm90.cuh;
//   rows past N arrive as zeros, which makes their terms vanish (padded
//   queries also get lse = +inf, so p = 0).
//   * Head dims up to 64 (the search step): one kernel, one block of two
//     warpgroups per (batch, head). q, k, v, do and o are copied in once
//     (five arrays of whole 64-row tiles: 160 KB at N = 197), delta =
//     rowsum(do ⊙ o) is formed from shared memory with 16-byte reads, then
//     warpgroup 0 runs the dq pass while warpgroup 1 runs the dk/dv pass on
//     the same resident operands. Every input leaves device memory once,
//     delta never does, and one warpgroup's `wgmma` runs under the other's
//     exponentials.
//   * Head dims above 64: five such arrays do not fit a block, so the passes
//     are two kernels, a block (one warpgroup) per (batch, head) each. The
//     dq kernel holds K and V whole and streams tiles of q and do through
//     two buffers (o through one), a tile ahead; it writes delta out for the
//     dk/dv kernel, which holds Q and dO whole and streams tiles of k and v.
//   * q kᵀ and do vᵀ are computed in both passes: 7 products for the 5 the
//     math needs. Sharing them would need ds in both orientations, that is a
//     transpose through shared memory; the arithmetic is not the bound.
//   * The ragged edge: the side a pass takes 64 at a time comes in full
//     64-row tiles, the last one mostly dead at N = 197, as in the forward.
//     The side it walks gets a narrower last step (16, 32 or 48: the `wgmma`
//     N), so it is padded to 16 only: 208 of the 256 rows for 197.
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// p = exp(s - lse), with lse already times log2 e.
__device__ __forceinline__ float p_of(float s, float lse2) {
  return ex2(fmaf(s, LOG2E, -lse2));
}

// Rows of the resident side: N rounded up to whole k-steps of 16.
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// One step of the dq kernel: W keys (key0 ..) against the 64 queries of the
// tile. lse (times log2 e) and delta of rows r0 and r0 + 8 come in
// registers. Keys past N need no mask: their k rows are zeros, so whatever
// ds holds there adds nothing to dq.
template <int DP, int W>
__device__ __forceinline__ void dq_step(float (&acc)[DP / 2], uint32_t Qt,
                                        uint32_t dOt, uint32_t Ks,
                                        uint32_t Vs, int NP, int key0,
                                        int ksteps, float lse0, float lse1,
                                        float dl0, float dl1) {
  float s[W / 2], dp[W / 2];
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss(s, desc_kmajor(Qt, ROWS, 0, kk), desc_kmajor(Ks, NP, key0, kk),
             kk > 0);
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss(dp, desc_kmajor(dOt, ROWS, 0, kk), desc_kmajor(Vs, NP, key0, kk),
             kk > 0);
  wgmma_commit();
  wgmma_wait<0>();

  uint32_t ds[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g);
      ds[kk][2 * g] = pack_bf16(p_of(s[j], lse0) * (dp[j] - dl0),
                                p_of(s[j + 1], lse0) * (dp[j + 1] - dl0));
      ds[kk][2 * g + 1] = pack_bf16(p_of(s[j + 2], lse1) * (dp[j + 2] - dl1),
                                    p_of(s[j + 3], lse1) * (dp[j + 3] - dl1));
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs(acc, ds[kk], desc_mnmajor(Ks, NP, key0 + 16 * kk),
             (key0 | kk) > 0);
  wgmma_commit();
  wgmma_wait<0>();
}

// The dq pass as a kernel of its own (head dims above 64). DP: head dim
// padded to 64 or 128. TAIL: width of the last step over the keys,
// pad16(N) % 64.
template <int DP, int TAIL>
__global__ void __launch_bounds__(WG)
attention_bwd_dq_resident_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 float* __restrict__ delta,
                                 bf16* __restrict__ dq, int N, int H, int d,
                                 Strides sq, Strides sk, Strides sv,
                                 Strides so, Strides sdo) {
  constexpr int T_BYTES = ROWS * DP * 2;     // one streamed tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int ntiles = (N + ROWS - 1) / ROWS, NP = pad16(N);   // padded keys
  const int kv_bytes = NP * DP * 2;
  const uint32_t Ts = smem_u32(smem),        // 2 buffers x (q, do)
                 Os = Ts + 4 * T_BYTES,      // o: read once, early in a tile
                 Ks = Os + T_BYTES, Vs = Ks + kv_bytes;
  float* row_lse = reinterpret_cast<float*>(smem + 5 * T_BYTES + 2 * kv_bytes);
  float* row_delta = row_lse + ROWS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const bf16* qbh = q + b * sq.b + h * sq.h;
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const bf16* obh = o + b * so.b + h * so.h;
  const bf16* dobh = dout + b * sdo.b + h * sdo.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ksteps = d >> 4, cpr = d >> 3;

  auto load_tile = [&](int t) {              // q, do rows 64 t ..
    const uint32_t T = Ts + (t & 1) * 2 * T_BYTES;
    load_rows_async<DP>(T, ROWS, 0, qbh, sq.n, ROWS * t, ROWS, N, d);
    load_rows_async<DP>(T + T_BYTES, ROWS, 0, dobh, sdo.n, ROWS * t, ROWS, N,
                        d);
  };
  // two groups are committed a tile (o of the next tile, then q and do of
  // the one after), so "at most one group in flight" always means that
  // this tile's three are there
  load_rows_async<DP>(Ks, NP, 0, kbh, sk.n, 0, NP, N, d);
  load_rows_async<DP>(Vs, NP, 0, vbh, sv.n, 0, NP, N, d);
  load_tile(0);
  load_rows_async<DP>(Os, ROWS, 0, obh, so.n, 0, ROWS, N, d);
  cp_async_commit();
  if (ntiles > 1) load_tile(1);
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    const uint32_t Qt = Ts + (t & 1) * 2 * T_BYTES, dOt = Qt + T_BYTES;
    unsigned char* tile = smem + (Qt - Ts);
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    {  // delta = rowsum(do ⊙ o): two threads a row, 16 bytes a read
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      float acc = 0.f;
      for (int c = half; c < cpr; c += 2) {
        const uint32_t off = chunk_offset(ROWS, r, c);
        acc += dot8(*reinterpret_cast<const uint4*>(tile + T_BYTES + off),
                    *reinterpret_cast<const uint4*>(smem + (Os - Ts) + off));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const int n = ROWS * t + r;
        row_delta[r] = acc;
        row_lse[r] = (n < N) ? lse[bh * N + n] * LOG2E : 0.f;
        if (n < N) delta[bh * N + n] = acc;
      }
    }
    __syncthreads();
    if (t + 1 < ntiles)
      load_rows_async<DP>(Os, ROWS, 0, obh, so.n, ROWS * (t + 1), ROWS, N, d);
    cp_async_commit();
    const float lse0 = row_lse[r0], lse1 = row_lse[r0 + 8];
    const float dl0 = row_delta[r0], dl1 = row_delta[r0 + 8];

    // the keys, 64 a step and a narrower last step
    float acc[DP / 2];
    int key0 = 0;
    for (; key0 + ROWS <= NP; key0 += ROWS)
      dq_step<DP, 64>(acc, Qt, dOt, Ks, Vs, NP, key0, ksteps, lse0, lse1, dl0,
                      dl1);
    if constexpr (TAIL > 0)
      dq_step<DP, TAIL>(acc, Qt, dOt, Ks, Vs, NP, key0, ksteps, lse0, lse1,
                        dl0, dl1);

    __syncthreads();                     // the row terms have been read
    store_acc_tile<DP>(acc, tile,
                       dq + ((static_cast<long long>(b) * N + ROWS * t) * H + h)
                           * d,
                       static_cast<long long>(H) * d, N - ROWS * t, d);
    __syncthreads();                     // the buffers are free again
    if (t + 2 < ntiles) load_tile(t + 2);
    cp_async_commit();
  }
}

// One step of the dk/dv kernel: the tile's 64 keys (rows) against W queries
// (columns, q0 ..). lse (times log2 e, +inf past N so that p = 0 there) and
// delta of all queries are in shared memory; a thread reads those of its
// columns.
template <int DP, int W>
__device__ __forceinline__ void dkdv_step(float (&acc_k)[DP / 2],
                                          float (&acc_v)[DP / 2], uint32_t Kt,
                                          uint32_t Vt, uint32_t Qs,
                                          uint32_t dOs, int NP, int q0,
                                          int ksteps, const float* lse_s,
                                          const float* delta_s) {
  float st[W / 2], dpt[W / 2];
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss(st, desc_kmajor(Kt, ROWS, 0, kk), desc_kmajor(Qs, NP, q0, kk),
             kk > 0);
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss(dpt, desc_kmajor(Vt, ROWS, 0, kk), desc_kmajor(dOs, NP, q0, kk),
             kk > 0);
  wgmma_commit();
  wgmma_wait<0>();

  const int col0 = q0 + 2 * (threadIdx.x & 3);
  uint32_t pt[W / 16][4], dst[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g);
      const int col = col0 + 8 * (2 * kk + g);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
      const float p0 = p_of(st[j], l2.x), p1 = p_of(st[j + 1], l2.y);
      const float p2 = p_of(st[j + 2], l2.x), p3 = p_of(st[j + 3], l2.y);
      pt[kk][2 * g] = pack_bf16(p0, p1);
      pt[kk][2 * g + 1] = pack_bf16(p2, p3);
      dst[kk][2 * g] = pack_bf16(p0 * (dpt[j] - dl.x),
                                 p1 * (dpt[j + 1] - dl.y));
      dst[kk][2 * g + 1] = pack_bf16(p2 * (dpt[j + 2] - dl.x),
                                     p3 * (dpt[j + 3] - dl.y));
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    wgmma_rs(acc_v, pt[kk], desc_mnmajor(dOs, NP, q0 + 16 * kk),
             (q0 | kk) > 0);
    wgmma_rs(acc_k, dst[kk], desc_mnmajor(Qs, NP, q0 + 16 * kk),
             (q0 | kk) > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// The dk/dv pass as a kernel of its own (head dims above 64); delta comes
// from the dq kernel, launched before it on the same stream.
template <int DP, int TAIL>
__global__ void __launch_bounds__(WG)
attention_bwd_dkdv_resident_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const bf16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int N, int H, int d,
                                   Strides sq, Strides sk, Strides sv,
                                   Strides sdo) {
  constexpr int T_BYTES = ROWS * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int ntiles = (N + ROWS - 1) / ROWS, NP = pad16(N);   // padded queries
  const int qd_bytes = NP * DP * 2;
  const uint32_t Ts = smem_u32(smem),        // 2 buffers x (k, v)
                 Qs = Ts + 4 * T_BYTES, dOs = Qs + qd_bytes;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * T_BYTES + 2 * qd_bytes);
  float* delta_s = lse_s + NP;

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* qbh = q + b * sq.b + h * sq.h;
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const bf16* dobh = dout + b * sdo.b + h * sdo.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ksteps = d >> 4;

  auto load_tile = [&](int t) {              // k, v rows 64 t ..
    const uint32_t T = Ts + (t & 1) * 2 * T_BYTES;
    load_rows_async<DP>(T, ROWS, 0, kbh, sk.n, ROWS * t, ROWS, N, d);
    load_rows_async<DP>(T + T_BYTES, ROWS, 0, vbh, sv.n, ROWS * t, ROWS, N, d);
  };
  load_rows_async<DP>(Qs, NP, 0, qbh, sq.n, 0, NP, N, d);
  load_rows_async<DP>(dOs, NP, 0, dobh, sdo.n, 0, NP, N, d);
  load_tile(0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1);
  cp_async_commit();
  for (int n = threadIdx.x; n < NP; n += WG) {
    lse_s[n] = (n < N) ? lse[bh * N + n] * LOG2E : INFINITY;
    delta_s[n] = (n < N) ? delta[bh * N + n] : 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const uint32_t Kt = Ts + (t & 1) * 2 * T_BYTES, Vt = Kt + T_BYTES;
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    // the queries, 64 a step and a narrower last step
    float acc_k[DP / 2], acc_v[DP / 2];
    int q0 = 0;
    for (; q0 + ROWS <= NP; q0 += ROWS)
      dkdv_step<DP, 64>(acc_k, acc_v, Kt, Vt, Qs, dOs, NP, q0, ksteps, lse_s,
                        delta_s);
    if constexpr (TAIL > 0)
      dkdv_step<DP, TAIL>(acc_k, acc_v, Kt, Vt, Qs, dOs, NP, q0, ksteps,
                          lse_s, delta_s);

    const long long out0 =
        ((static_cast<long long>(b) * N + ROWS * t) * H + h) * d;
    store_acc_tile<DP>(acc_k, smem + (Kt - Ts), dk + out0,
                       static_cast<long long>(H) * d, N - ROWS * t, d);
    store_acc_tile<DP>(acc_v, smem + (Vt - Ts), dv + out0,
                       static_cast<long long>(H) * d, N - ROWS * t, d);
    __syncthreads();                     // the buffers are free again
    if (t + 2 < ntiles) load_tile(t + 2);
    cp_async_commit();
  }
}

// Both passes in one block of two warpgroups, for head dims up to 64. All
// five arrays hold whole 64-row tiles (rows past N are zeros), since either
// side is the A operand of one pass, 64 rows at a time.
template <int TAIL>
__global__ void __launch_bounds__(2 * WG)
attention_bwd_fused_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int N, int H, int d,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           Strides sdo) {
  constexpr int DP = 64, T_BYTES = ROWS * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int ntiles = (N + ROWS - 1) / ROWS, NR = ROWS * ntiles;
  const int NP = pad16(N);                   // the side that is walked
  const int a_bytes = NR * ROW_BYTES;
  const uint32_t Qs = smem_u32(smem), Ks = Qs + a_bytes, Vs = Ks + a_bytes,
                 dOs = Vs + a_bytes, Os = dOs + a_bytes;
  unsigned char* stage = smem + 5 * a_bytes;  // dq | dk | dv, a tile each
  float* lse_s = reinterpret_cast<float*>(stage + 3 * T_BYTES);
  float* delta_s = lse_s + NR;

  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ksteps = d >> 4, cpr = d >> 3;

  load_rows_async<DP>(Qs, NR, 0, q + b * sq.b + h * sq.h, sq.n, 0, NR, N, d);
  load_rows_async<DP>(Ks, NR, 0, k + b * sk.b + h * sk.h, sk.n, 0, NR, N, d);
  load_rows_async<DP>(Vs, NR, 0, v + b * sv.b + h * sv.h, sv.n, 0, NR, N, d);
  load_rows_async<DP>(dOs, NR, 0, dout + b * sdo.b + h * sdo.h, sdo.n, 0, NR,
                      N, d);
  load_rows_async<DP>(Os, NR, 0, o + b * so.b + h * so.h, so.n, 0, NR, N, d);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // delta = rowsum(do ⊙ o) and lse (times log2 e; +inf past N, so p = 0)
  for (int r = threadIdx.x; r < NR; r += 2 * WG) {
    float acc = 0.f;
    for (int c = 0; c < cpr; ++c) {
      const uint32_t off = chunk_offset(NR, r, c);
      acc += dot8(*reinterpret_cast<const uint4*>(smem + (dOs - Qs) + off),
                  *reinterpret_cast<const uint4*>(smem + (Os - Qs) + off));
    }
    delta_s[r] = acc;
    lse_s[r] = (r < N) ? lse[bh * N + r] * LOG2E : INFINITY;
  }
  __syncthreads();

  const long long out_stride = static_cast<long long>(H) * d;
  if (threadIdx.x < WG) {                    // warpgroup 0: dq
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
    for (int t = 0; t < ntiles; ++t) {
      const uint32_t Qt = Qs + t * T_BYTES, dOt = dOs + t * T_BYTES;
      const float lse0 = lse_s[ROWS * t + r0], lse1 = lse_s[ROWS * t + r0 + 8];
      const float dl0 = delta_s[ROWS * t + r0],
                  dl1 = delta_s[ROWS * t + r0 + 8];
      float acc[DP / 2];
      int key0 = 0;
      for (; key0 + ROWS <= NP; key0 += ROWS)
        dq_step<DP, 64>(acc, Qt, dOt, Ks, Vs, NR, key0, ksteps, lse0, lse1,
                        dl0, dl1);
      if constexpr (TAIL > 0)
        dq_step<DP, TAIL>(acc, Qt, dOt, Ks, Vs, NR, key0, ksteps, lse0, lse1,
                          dl0, dl1);
      store_acc_tile<DP, 1>(acc, stage,
                            dq + ((static_cast<long long>(b) * N + ROWS * t)
                                  * H + h) * d,
                            out_stride, N - ROWS * t, d);
      warpgroup_sync<1>();               // the stage is free again
    }
  } else {                                   // warpgroup 1: dk, dv
    for (int t = 0; t < ntiles; ++t) {
      const uint32_t Kt = Ks + t * T_BYTES, Vt = Vs + t * T_BYTES;
      float acc_k[DP / 2], acc_v[DP / 2];
      int q0 = 0;
      for (; q0 + ROWS <= NP; q0 += ROWS)
        dkdv_step<DP, 64>(acc_k, acc_v, Kt, Vt, Qs, dOs, NR, q0, ksteps,
                          lse_s, delta_s);
      if constexpr (TAIL > 0)
        dkdv_step<DP, TAIL>(acc_k, acc_v, Kt, Vt, Qs, dOs, NR, q0, ksteps,
                            lse_s, delta_s);
      const long long out0 =
          ((static_cast<long long>(b) * N + ROWS * t) * H + h) * d;
      store_acc_tile<DP, 2>(acc_k, stage + T_BYTES, dk + out0, out_stride,
                            N - ROWS * t, d);
      store_acc_tile<DP, 2>(acc_v, stage + 2 * T_BYTES, dv + out0, out_stride,
                            N - ROWS * t, d);
      warpgroup_sync<2>();               // the stages are free again
    }
  }
}

// Shared memory of the kernels, alignment slack included.
inline size_t fused_smem(int N) {
  const size_t NR = ROWS * ((N + ROWS - 1) / ROWS);
  return 5 * NR * ROW_BYTES + 3 * ROWS * ROW_BYTES + 2 * NR * sizeof(float) +
         1024;
}

inline size_t dq_smem(int N, int DP) {
  return 2 * size_t(pad16(N)) * DP * 2 + 5 * size_t(ROWS) * DP * 2 +
         2 * ROWS * sizeof(float) + 1024;
}

inline size_t dkdv_smem(int N, int DP) {
  return 2 * size_t(pad16(N)) * DP * 2 + 4 * size_t(ROWS) * DP * 2 +
         2 * pad16(N) * sizeof(float) + 1024;
}

template <int TAIL>
int launch_bwd_fused(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dq, void* dk, void* dv, int B, int N, int H, int d,
                     const long long* st, cudaStream_t stream) {
  static bool ready[64] = {};
  cudaError_t err = allow_full_smem(attention_bwd_fused_kernel<TAIL>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_fused_kernel<TAIL>
      <<<dim3(H, B), 2 * WG, fused_smem(N), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), N, H, d, Strides{st[0], st[1], st[2]},
          Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
          Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]});
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int TAIL>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int d,
               const long long* st, cudaStream_t stream) {
  static bool ready_dq[64] = {}, ready_kv[64] = {};
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const dim3 grid(H, B);

  cudaError_t err =
      allow_full_smem(attention_bwd_dq_resident_kernel<DP, TAIL>, ready_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_resident_kernel<DP, TAIL><<<grid, WG, dq_smem(N, DP), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), N, H, d, sq, sk,
      sv, so, sdo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_full_smem(attention_bwd_dkdv_resident_kernel<DP, TAIL>, ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_resident_kernel<DP, TAIL>
      <<<grid, WG, dkdv_smem(N, DP), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H, d, sq, sk,
          sv, sdo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 15 element strides, (batch, token, head) for q, k, v,
// o, do. lse and delta are contiguous (B, H, N) fp32 (delta is scratch the
// call fills); dq, dk, dv are contiguous (B, N, H, d). Takes 1 <= N <= 256,
// d a multiple of 16 up to 128, 16-byte aligned rows, and B, H within the
// grid's limits; returns -1 for anything else, else cudaGetLastError()
// after the launches.
extern "C" int ofb_attention_bwd_resident(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk,
                                          void* dv, int B, int N, int H,
                                          int d, const long long* strides,
                                          void* stream) {
  using namespace ofb::sm90;
  const void* ptrs[5] = {q, k, v, o, dout};
  if (N < 1 || N > 256 || d < 16 || d > 128 || d % 16 != 0 || B < 1 ||
      B > 65535 || H < 1 || !aligned_16(ptrs, strides, 5))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OFB_BWD(tail)                                                        \
  case tail:                                                                 \
    if (d <= 64)                                                             \
      return launch_bwd_fused<tail>(q, k, v, o, dout, lse, dq, dk, dv, B, N, \
                                    H, d, strides, s);                       \
    return launch_bwd<128, tail>(q, k, v, o, dout, lse, delta, dq, dk, dv,   \
                                 B, N, H, d, strides, s);
  switch (pad16(N) % ROWS) { OFB_BWD(0) OFB_BWD(16) OFB_BWD(32) OFB_BWD(48) }
#undef OFB_BWD
  return -1;
}
