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
// both of its passes, 14 B H N² d flops: its own floor is 0.4633 ms there.
//
// Design. dk and dv sum over queries and dq over keys; Hopper blocks carry
// no sums between them and atomics would change dq from run to run. So two
// kernels, each summing in registers what it walks over, deterministic like
// both other bodies; one wrapper call launches both:
//   * dq kernel: 64 queries a block (one warpgroup), q and do resident in
//     shared memory; delta = rowsum(do ⊙ o) of the block's rows first (o
//     read once from device memory), written out for the second kernel.
//     K and V stream 64 keys at a time through a ring of three `cp.async`
//     stages. Per tile: s = q kᵀ and dp = do vᵀ by `wgmma` into
//     registers, p and ds formed there, ds the register A operand of
//     dq += ds k with k read MN-major from the stage that gave s K-major.
//     Keys past N need no mask: their k rows are zeros, so whatever ds
//     holds there adds nothing to dq.
//   * dk/dv kernel: two warpgroups, 64 keys each, k and v resident. Q, dO
//     and the 64 queries' lse and delta stream through the same kind of
//     ring. It computes the transposed tiles, sᵀ = k qᵀ and dpᵀ = v doᵀ, so
//     pᵀ and dsᵀ land in accumulator layout and are the register A operands
//     of dv += pᵀ do and dk += dsᵀ q (do and q MN-major): no trip through
//     shared memory. Queries past N arrive as zero rows with lse = delta =
//     0, so p = 1 and ds = 0 there, and the zero rows of do and q make
//     their terms vanish.
//   * In both, a tile's output product is waited for only at the next
//     tile's first wait, and a stage is refilled only behind the block
//     barrier after that wait: a stage holds tile t - 1 (still read), t and
//     t + 1 (being copied).
//   * Head dims 8 * odd run as the next multiple of 16 (sm90.cuh).
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// tiles copied ahead of the one in use by the dq and the dk/dv kernel; the
// ring also holds the tile in use and the one before it, which the last
// output product still reads
constexpr int DQ_AHEAD = 1, KV_AHEAD = 1;
// warpgroups a block of the dq and of the dk/dv kernel, 64 resident rows
// each. The dq kernel (148 registers a thread at d16 <= 64) runs one
// warpgroup a block, three blocks an SM; the dk/dv kernel (205) two, whose
// warpgroups share the streamed q and do tiles (probe_kernels times both
// the other way).
constexpr int DQ_WGS = 1, KV_WGS = 2;

// p = exp(s - lse), with lse already times log2 e.
__device__ __forceinline__ float p_of(float s, float lse2) {
  return ex2(fmaf(s, LOG2E, -lse2));
}

// Shared memory of the kernels, alignment slack included.
inline size_t dq_streaming_smem(int DP) {
  constexpr size_t BROWS = DQ_WGS * ROWS, STAGES = DQ_AHEAD + 2;
  return 2 * BROWS * DP * 2 + STAGES * 2 * size_t(ROWS) * DP * 2 +
         2 * BROWS * sizeof(float) + 1024;
}

inline size_t dkdv_streaming_smem(int DP) {
  constexpr size_t BROWS = KV_WGS * ROWS, STAGES = KV_AHEAD + 2;
  return 2 * BROWS * DP * 2 +
         STAGES * (2 * size_t(ROWS) * DP * 2 + 1024) + 1024;
}

// DP: head dim padded to 64 or 128.
template <int DP>
__global__ void __launch_bounds__(DQ_WGS * WG)
attention_bwd_dq_streaming_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ o,
                                  const bf16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  bf16* __restrict__ dq, int N, int H, int d,
                                  Strides sq, Strides sk, Strides sv,
                                  Strides so, Strides sdo) {
  constexpr int BROWS = DQ_WGS * ROWS;       // resident rows a block
  constexpr int AHEAD = DQ_AHEAD, STAGES = AHEAD + 2;
  constexpr int T_BYTES = ROWS * DP * 2;
  constexpr int STAGE_BYTES = 2 * T_BYTES;   // K, then V
  constexpr int A_BYTES = BROWS * DP * 2;    // a resident array
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Qs = smem_u32(smem), dOs = Qs + A_BYTES,
                 Ring = dOs + A_BYTES;
  float* row_lse = reinterpret_cast<float*>(smem + 2 * A_BYTES +
                                            STAGES * STAGE_BYTES);
  float* row_delta = row_lse + BROWS;

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk0 = BROWS * blockIdx.x, row0 = blk0 + ROWS * wg;
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const bf16* obh = o + b * so.b + h * so.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS, ksteps = (d + 15) >> 4;

  auto stage = [&](int t) { return Ring + (t % STAGES) * STAGE_BYTES; };
  auto load_kv = [&](int t) {
    load_rows_async<DP>(stage(t), ROWS, 0, kbh, sk.n, ROWS * t, ROWS, N, d);
    load_rows_async<DP>(stage(t) + T_BYTES, ROWS, 0, vbh, sv.n, ROWS * t,
                        ROWS, N, d);
  };
  load_rows_async<DP>(Qs, BROWS, 0, q + b * sq.b + h * sq.h, sq.n, blk0,
                      BROWS, N, d);
  load_rows_async<DP>(dOs, BROWS, 0, dout + b * sdo.b + h * sdo.h, sdo.n,
                      blk0, BROWS, N, d);
  cp_async_commit();
  for (int t = 0; t < AHEAD; ++t) {          // one group a tile
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }
  cp_async_wait<AHEAD>();                    // q and do are here
  __syncthreads();

  {  // delta = rowsum(do ⊙ o): two threads a row, 16 bytes a read
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, n = blk0 + r;
    float acc = 0.f;
    if (n < N)
      for (int c = half; c < (d >> 3); c += 2)
        acc += dot8(*reinterpret_cast<const uint4*>(
                        smem + (dOs - Qs) + chunk_offset(BROWS, r, c)),
                    *reinterpret_cast<const uint4*>(obh + n * so.n + c * 8));
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      row_delta[r] = acc;
      row_lse[r] = (n < N) ? lse[bh * N + n] * LOG2E : 0.f;
      if (n < N) delta[bh * N + n] = acc;
    }
  }
  __syncthreads();
  const float lse0 = row_lse[ROWS * wg + r0], lse1 = row_lse[ROWS * wg + r0 + 8];
  const float dl0 = row_delta[ROWS * wg + r0],
              dl1 = row_delta[ROWS * wg + r0 + 8];

  float s[32], dp[32], acc[DP / 2];
  uint32_t ds[4][4];
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();                         // tile t is here, t - 2 is free
    if (t + AHEAD < ntiles) load_kv(t + AHEAD);
    cp_async_commit();

    const uint32_t Kt = stage(t), Vt = Kt + T_BYTES;
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss(s, desc_kmajor(Qs, BROWS, ROWS * wg, kk),
               desc_kmajor(Kt, ROWS, 0, kk), kk > 0);
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss(dp, desc_kmajor(dOs, BROWS, ROWS * wg, kk),
               desc_kmajor(Vt, ROWS, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();                         // and dq += ds k of tile t - 1
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int j = 4 * (2 * kk + g);
        ds[kk][2 * g] = pack_bf16(p_of(s[j], lse0) * (dp[j] - dl0),
                                  p_of(s[j + 1], lse0) * (dp[j + 1] - dl0));
        ds[kk][2 * g + 1] =
            pack_bf16(p_of(s[j + 2], lse1) * (dp[j + 2] - dl1),
                      p_of(s[j + 3], lse1) * (dp[j + 3] - dl1));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (ROWS * t + 16 * kk < N)
        wgmma_rs(acc, ds[kk], desc_mnmajor(Kt, ROWS, 16 * kk), (t | kk) > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  __syncthreads();                           // every product has retired
  bf16* dst = dq + ((static_cast<long long>(b) * N + row0) * H + h) * d;
  const long long stride = static_cast<long long>(H) * d;
  if (wg == 0)
    store_acc_tile<DP, 1>(acc, smem + (Ring - Qs), dst, stride, N - row0, d);
  else
    store_acc_tile<DP, 2>(acc, smem + (Ring - Qs) + T_BYTES, dst, stride,
                          N - row0, d);
}

// DP: head dim padded to 64 or 128. delta comes from the dq kernel,
// launched before it on the same stream.
template <int DP>
__global__ void __launch_bounds__(KV_WGS * WG)
attention_bwd_dkdv_streaming_kernel(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const bf16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int N, int H,
                                    int d, Strides sq, Strides sk, Strides sv,
                                    Strides sdo) {
  constexpr int BROWS = KV_WGS * ROWS;       // resident rows a block
  constexpr int AHEAD = KV_AHEAD, STAGES = AHEAD + 2;
  constexpr int T_BYTES = ROWS * DP * 2;
  constexpr int STAGE_BYTES = 2 * T_BYTES + 1024;  // Q, dO, lse | delta
  constexpr int A_BYTES = BROWS * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t Ks = smem_u32(smem), Vs = Ks + A_BYTES, Ring = Vs + A_BYTES;

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int lane = tid & 31;
  const int col0 = 2 * (lane & 3);
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk0 = BROWS * blockIdx.x, row0 = blk0 + ROWS * wg;
  const bf16* qbh = q + b * sq.b + h * sq.h;
  const bf16* dobh = dout + b * sdo.b + h * sdo.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS, ksteps = (d + 15) >> 4;

  auto stage = [&](int t) { return Ring + (t % STAGES) * STAGE_BYTES; };
  auto row_terms = [&](int t) {              // lse (64), then delta (64)
    return reinterpret_cast<const float*>(smem + (stage(t) - Ks) +
                                          2 * T_BYTES);
  };
  auto load_q = [&](int t) {                 // q, do, lse, delta of 64 rows
    const uint32_t base = stage(t);
    load_rows_async<DP>(base, ROWS, 0, qbh, sq.n, ROWS * t, ROWS, N, d);
    load_rows_async<DP>(base + T_BYTES, ROWS, 0, dobh, sdo.n, ROWS * t, ROWS,
                        N, d);
    const int n = ROWS * t + threadIdx.x % ROWS;
    const float* src = (threadIdx.x < ROWS ? lse : delta) + bh * N;
    if (threadIdx.x < 2 * ROWS)
      cp_async_4(base + 2 * T_BYTES + 4 * threadIdx.x, src + (n < N ? n : 0),
                 n < N ? 4 : 0);
  };
  load_rows_async<DP>(Ks, BROWS, 0, k + b * sk.b + h * sk.h, sk.n, blk0,
                      BROWS, N, d);
  load_rows_async<DP>(Vs, BROWS, 0, v + b * sv.b + h * sv.h, sv.n, blk0,
                      BROWS, N, d);
  for (int t = 0; t < AHEAD; ++t) {          // one group a tile, k and v
    if (t < ntiles) load_q(t);               // with the first
    cp_async_commit();
  }

  float st[32], dpt[32], acc_k[DP / 2], acc_v[DP / 2];
  uint32_t pt[4][4], dst[4][4];
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();                         // tile t is here, t - 2 is free
    if (t + AHEAD < ntiles) load_q(t + AHEAD);
    cp_async_commit();

    const uint32_t Qt = stage(t), dOt = Qt + T_BYTES;
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss(st, desc_kmajor(Ks, BROWS, ROWS * wg, kk),
               desc_kmajor(Qt, ROWS, 0, kk), kk > 0);
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss(dpt, desc_kmajor(Vs, BROWS, ROWS * wg, kk),
               desc_kmajor(dOt, ROWS, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();                         // and dk, dv of tile t - 1
    fence_regs(st);
    fence_regs(dpt);

    const float* lse_t = row_terms(t);
    const float* delta_t = lse_t + ROWS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int j = 4 * (2 * kk + g);
        const int col = col0 + 8 * (2 * kk + g);
        const float2 l = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
        const float l2x = l.x * LOG2E, l2y = l.y * LOG2E;
        const float p0 = p_of(st[j], l2x), p1 = p_of(st[j + 1], l2y);
        const float p2 = p_of(st[j + 2], l2x), p3 = p_of(st[j + 3], l2y);
        pt[kk][2 * g] = pack_bf16(p0, p1);
        pt[kk][2 * g + 1] = pack_bf16(p2, p3);
        dst[kk][2 * g] = pack_bf16(p0 * (dpt[j] - dl.x),
                                   p1 * (dpt[j + 1] - dl.y));
        dst[kk][2 * g + 1] = pack_bf16(p2 * (dpt[j + 2] - dl.x),
                                       p3 * (dpt[j + 3] - dl.y));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (ROWS * t + 16 * kk < N) {
        wgmma_rs(acc_v, pt[kk], desc_mnmajor(dOt, ROWS, 16 * kk),
                 (t | kk) > 0);
        wgmma_rs(acc_k, dst[kk], desc_mnmajor(Qt, ROWS, 16 * kk),
                 (t | kk) > 0);
      }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc_k);
  fence_regs(acc_v);

  __syncthreads();                           // every product has retired
  // warpgroup w stages dk and dv through the q and do tiles of stage w
  const long long out0 = ((static_cast<long long>(b) * N + row0) * H + h) * d;
  const long long stride = static_cast<long long>(H) * d;
  unsigned char* mine = smem + (Ring - Ks) + wg * STAGE_BYTES;
  if (wg == 0) {
    store_acc_tile<DP, 1>(acc_k, mine, dk + out0, stride, N - row0, d);
    store_acc_tile<DP, 1>(acc_v, mine + T_BYTES, dv + out0, stride, N - row0,
                          d);
  } else {
    store_acc_tile<DP, 2>(acc_k, mine, dk + out0, stride, N - row0, d);
    store_acc_tile<DP, 2>(acc_v, mine + T_BYTES, dv + out0, stride, N - row0,
                          d);
  }
}

template <int DP>
int launch_bwd_streaming(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int N, int H, int d, const long long* st,
                         cudaStream_t stream) {
  static bool ready_dq[64] = {}, ready_kv[64] = {};
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};

  cudaError_t err =
      allow_full_smem(attention_bwd_dq_streaming_kernel<DP>, ready_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_streaming_kernel<DP>
      <<<dim3((N + DQ_WGS * ROWS - 1) / (DQ_WGS * ROWS), H, B), DQ_WGS * WG,
         dq_streaming_smem(DP), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<bf16*>(dq), N, H, d, sq,
          sk, sv, so, sdo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_full_smem(attention_bwd_dkdv_streaming_kernel<DP>, ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_streaming_kernel<DP>
      <<<dim3((N + KV_WGS * ROWS - 1) / (KV_WGS * ROWS), H, B), KV_WGS * WG,
         dkdv_streaming_smem(DP), stream>>>(
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
// call fills); dq, dk, dv are contiguous (B, N, H, d). Takes any N >= 1,
// d a multiple of 8 up to 128, 16-byte aligned rows, and B, H within the
// grid's limits; returns -1 for anything else, else cudaGetLastError()
// after the launches.
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
      H < 1 || H > 65535 || !aligned_16(ptrs, strides, 5))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_bwd_streaming<64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, N, H, d, strides, s);
  return launch_bwd_streaming<128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, N, H, d, strides, s);
}
