// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the unaligned body, bf16, any number of tokens, any head dim in [1, 128],
// rows at any alignment.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)) for the bf16 calls that the
// resident and the streaming bodies do not take (attention_fwd_unaligned.cu
// says which). Same math, no scale inside:
//   p  = softmax(q kᵀ) = exp(q kᵀ − lse)    lse from the forward, fp32
//   dv = pᵀ do                               p rounded to bf16
//   dp = do vᵀ                               fp32
//   ds = p ⊙ (dp − delta)                    delta = rowsum(do ⊙ o), fp32;
//                                            ds rounded to bf16
//   dq = ds k,  dk = dsᵀ q                   fp32 sums, bf16 out
//
// Bound. 10 B H N² d flops for the five products against seven (B, N, H, d)
// tensors: about 140 flops a byte at N = 197, d = 64, and 40 at d = 20,
// under the H100's ~295, so device memory bounds it at N = 197 ((256, 197,
// 6, 64): 0.081 ms at 3.35 TB/s); at (64, 577, 6, 20) the operations do.
//
// Design. dk and dv sum over queries and dq over keys, and Hopper blocks
// cannot carry sums between them, so there are two kernels, each summing in
// registers what it walks over, with no atomics (their order would change
// the sums from run to run, and a CUDA graph replay would no longer equal
// an eager call bit for bit). Both rebuild p from the forward's lse.
//   * The dq kernel: a block (one warpgroup) keeps 64 query rows of one
//     (batch, head), their do and their row terms, and walks the keys in
//     64-key tiles through two buffers each of k and v, the copy of tile
//     t + 1 started right after the `wgmma`s of tile t are issued. s = q kᵀ
//     and dp = do vᵀ leave `wgmma` in fp32 registers, ds is formed there
//     and is the register A operand of dq += ds k, with k read MN-major from
//     the tile that gave s K-major.
//   * delta is computed here, the cheapest place: the dq kernel copies the
//     64 rows of o once, into a k slot that is free until the first key
//     tile is in place, and forms rowsum(do ⊙ o) from shared memory with
//     16-byte reads (two threads a row); it uses delta and writes it out
//     for the dk/dv kernel, launched after it on the same stream. So o is
//     read from device memory once, do once a kernel, and delta costs 4
//     bytes a row (a kernel of its own would read do a third time).
//   * The dk/dv kernel: a block keeps 64 keys and their v, and walks the
//     queries in 64-row tiles through two buffers each of q, do and their
//     lse and delta (4-byte `cp.async`). It computes the transposed tiles
//     directly, sᵀ = k qᵀ and dpᵀ = v doᵀ, so pᵀ and dsᵀ are register A
//     operands of dv += pᵀ do and dk += dsᵀ q, with do and q read MN-major.
//   * The copies as in attention_fwd_unaligned.cu (sm90.cuh): at each
//     view's own width, `cp.async` of 16, 8 or 4 bytes straight into the
//     operand tiles (two slots a streamed operand), and rows that start on 2
//     bytes only staged by 16-byte `cp.async` and shifted into place at the
//     top of their tile; the resident operands of such rows through registers,
//     under the first streamed copy. Rows past N and columns d .. d16 - 1
//     arrive as zeros, and p is set to 0 past N (only the last tile pays
//     for that test), so padded rows and keys add nothing. The products read
//     columns up to d16 (K-major) and DP (MN-major: 64 columns up to d16 =
//     64, else 128), and only d columns of dq, dk and dv are stored, in
//     16-, 4- or 2-byte stores by d (the outputs are contiguous).
//   * q kᵀ and do vᵀ are computed in both kernels: 7 products for the 5 the
//     math needs; sharing them would need ds in both orientations.
//   * k-steps (KS = d16 / 16) are a template argument: every product is a
//     fixed run of `wgmma`s, with no loop or branch inside.
//   * Shared memory: two resident tiles and two streamed operands of a tile
//     and a slot each (52 KB up to d16 = 64, 100 KB above) and 512 or 1024
//     bytes of row terms. Registers are held to three blocks an SM up to
//     d16 = 64 and two above (`bwd_blocks`): three measured 4-10% faster
//     than two; above 64 the dk/dv kernel's two 64 x 128 sums would spill.
#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// Copy widths (`row_width`) of q, k, v, o, do and of the stores of dq, dk
// and dv.
struct BwdWidths {
  int q, k, v, o, dout, out;
};

// Blocks an SM the kernels' registers are held to: three up to d16 = 64
// (168 registers a thread, no spills), two above (at three the dk/dv
// kernel's two 64 x 128 sums spill).
__host__ __device__ constexpr int bwd_blocks(int ks) { return ks <= 4 ? 3 : 2; }

// p = exp(s - lse) with lse already times log2 e.
__device__ __forceinline__ float p_of(float s, float lse2) {
  return ex2(fmaf(s, LOG2E, -lse2));
}

// ds = p (dp - delta) of the dq kernel's 64 x 64 tile, rows r0 and r0 + 8
// (their lse times log2 e and delta in `rows`: lse0, lse1, delta0,
// delta1), rounded to bf16 as the register A operands of dq += ds k; with
// MASK, the keys at or past `valid` give 0.
template <bool MASK>
__device__ __forceinline__ void ds_rows(const float (&s)[32],
                                        const float (&dp)[32], int valid,
                                        int col0, const float (&rows)[4],
                                        uint32_t (&ds)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g), col = 8 * (2 * kk + g) + col0;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = p_of(s[j + e], rows[e >> 1]) * (dp[j + e] - rows[2 + (e >> 1)]);
        if (MASK && col + (e & 1) >= valid) x[e] = 0.f;
      }
      ds[kk][2 * g] = pack_bf16(x[0], x[1]);
      ds[kk][2 * g + 1] = pack_bf16(x[2], x[3]);
    }
}

// pᵀ and dsᵀ of the dk/dv kernel's 64 x 64 tile (keys r0, r0 + 8 by the
// tile's queries; their lse and delta in shared memory), rounded to bf16
// as the register A operands of dv += pᵀ do and dk += dsᵀ q; with MASK,
// the queries at or past `valid` give 0.
template <bool MASK>
__device__ __forceinline__ void p_ds_cols(const float (&st)[32],
                                          const float (&dpt)[32],
                                          const float* lse_t,
                                          const float* delta_t, int valid,
                                          int col0, uint32_t (&pt)[4][4],
                                          uint32_t (&dst)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = 4 * (2 * kk + g), col = 8 * (2 * kk + g) + col0;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
      const float lc[2] = {l2.x * LOG2E, l2.y * LOG2E}, dc[2] = {dl.x, dl.y};
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = p_of(st[j + e], lc[e & 1]);
        if (MASK && col + (e & 1) >= valid) pv[e] = 0.f;
        dsv[e] = pv[e] * (dpt[j + e] - dc[e & 1]);
      }
      pt[kk][2 * g] = pack_bf16(pv[0], pv[1]);
      pt[kk][2 * g + 1] = pack_bf16(pv[2], pv[3]);
      dst[kk][2 * g] = pack_bf16(dsv[0], dsv[1]);
      dst[kk][2 * g + 1] = pack_bf16(dsv[2], dsv[3]);
    }
}

// The 64 x 64 products summed over the head dim: x = a bᵀ, y = c eᵀ, all
// four tiles K-major.
template <int KS>
__device__ __forceinline__ void two_products(float (&x)[32], float (&y)[32],
                                             uint32_t a, uint32_t bt,
                                             uint32_t c, uint32_t e) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss(x, desc_kmajor(a, ROWS, 0, kk), desc_kmajor(bt, ROWS, 0, kk),
             kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss(y, desc_kmajor(c, ROWS, 0, kk), desc_kmajor(e, ROWS, 0, kk),
             kk > 0);
  wgmma_commit();
}

template <int KS>
__global__ void __launch_bounds__(WG, bwd_blocks(KS))
attention_bwd_dq_unaligned_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ o,
                                  const bf16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  bf16* __restrict__ dq, int N, int H, int d,
                                  Strides sq, Strides sk, Strides sv,
                                  Strides so, Strides sdo, BwdWidths w) {
  constexpr int DP = panel_cols(KS);
  constexpr int T = ROWS * DP * 2;           // bytes of a 64-row tile
  constexpr int SLOT = T + slot_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // q, do; k and v each a tile and a second slot (its next tile, or the
  // staging area of its next tile); the row terms
  const uint32_t Qs = smem_u32(smem), dOs = Qs + T, Ks = dOs + T,
                 Vs = Ks + SLOT;
  float* row_lse = reinterpret_cast<float*>(smem + 2 * T + 2 * SLOT);
  float* row_delta = row_lse + ROWS;
  const bool stage_k = w.k == 2, stage_v = w.v == 2;

  const int m0 = ROWS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bf16* kbh = k + b * sk.b + h * sk.h;
  const bf16* vbh = v + b * sv.b + h * sv.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS;

  // key tile 0 (as every later one), then q, do and o of the rows (o into
  // the k slot that tile 0 leaves free until its shift, or until the copy
  // of key tile 1): by cp.async, or for rows on 2 bytes only staged (k,
  // v) or through registers (q, do, o)
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
  load_rows_width<DP>(w.dout, dOs, dout + b * sdo.b + h * sdo.h, sdo.n, m0,
                      N, d);
  const uint32_t Os = stage_k ? Ks : Ks + T;
  load_rows_width<DP>(w.o, Os, o + b * so.b + h * so.h, so.n, m0, N, d);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  {  // delta = rowsum(do ⊙ o): two threads a row, 16 bytes a read
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    for (int c = half; c < (d + 7) >> 3; c += 2) {
      const uint32_t off = chunk_offset(ROWS, r, c);
      acc += dot8(*reinterpret_cast<const uint4*>(smem + T + off),
                  *reinterpret_cast<const uint4*>(smem + (Os - Qs) + off));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const int n = m0 + r;
      row_delta[r] = acc;
      row_lse[r] = n < N ? lse[bh * N + n] * LOG2E : 0.f;
      if (n < N) delta[bh * N + n] = acc;
    }
  }
  __syncthreads();                           // o is read; the row terms are in
  // lse (times log2 e) and delta of rows r0 and r0 + 8
  const float rows[4] = {row_lse[r0], row_lse[r0 + 8], row_delta[r0],
                         row_delta[r0 + 8]};

  float acc[DP / 2];                         // dq, rows r0 and r0 + 8
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t ds[4][4];
  for (int t = 0; t < ntiles; ++t) {
    // a tile copied straight in alternates between the slots; a staged
    // one is shifted into the first
    const uint32_t Kt = Ks + (stage_k ? 0 : (t & 1) * T),
                   Vt = Vs + (stage_v ? 0 : (t & 1) * T);
    if (t > 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();                       // tile t is in; tile t - 1 is
    }                                        // read by no product any more
    if (stage_k || stage_v) {
      if (stage_k)
        unstage_rows<DP>(Ks, smem + (Ks - Qs) + T, kbh, sk.n, ROWS * t, N, d);
      if (stage_v)
        unstage_rows<DP>(Vs, smem + (Vs - Qs) + T, vbh, sv.n, ROWS * t, N, d);
      fence_proxy_async();
      __syncthreads();
    }
    fence_regs(s);
    fence_regs(dp);
    two_products<KS>(s, dp, Qs, Kt, dOs, Vt);
    fence_regs(s);
    fence_regs(dp);
    if (t + 1 < ntiles)                      // tile t + 1, under tile t
      copy_kv(t + 1, ROWS * (t + 1));
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int valid = N - ROWS * t;          // keys of the tile below N
    if (valid < ROWS)
      ds_rows<true>(s, dp, valid, col0, rows, ds);
    else
      ds_rows<false>(s, dp, valid, col0, rows, ds);
    fence_regs(acc);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, ds[kk], desc_mnmajor(Kt, ROWS, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
  }

  __syncthreads();                           // no product reads q any more
  stage_acc_tile<DP>(acc, smem);
  __syncthreads();
  store_rows_width(w.out, smem,
                   dq + ((static_cast<long long>(b) * N + m0) * H + h) * d,
                   static_cast<long long>(H) * d, N - m0, d);
}

template <int KS>
__global__ void __launch_bounds__(WG, bwd_blocks(KS))
attention_bwd_dkdv_unaligned_kernel(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const bf16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int N, int H,
                                    int d, Strides sq, Strides sk, Strides sv,
                                    Strides sdo, BwdWidths w) {
  constexpr int DP = panel_cols(KS);
  constexpr int T = ROWS * DP * 2;
  constexpr int SLOT = T + slot_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // k, v; q and do each a tile and a second slot (as k, v in the dq
  // kernel); lse and delta, [buffer][lse, delta][64]
  const uint32_t Ks = smem_u32(smem), Vs = Ks + T, Qs = Vs + T,
                 dOs = Qs + SLOT;
  float* terms = reinterpret_cast<float*>(smem + 2 * T + 2 * SLOT);
  const bool stage_q = w.q == 2, stage_do = w.dout == 2;

  const int n0 = ROWS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int col0 = 2 * (lane & 3);
  const bf16* qbh = q + b * sq.b + h * sq.h;
  const bf16* dobh = dout + b * sdo.b + h * sdo.h;
  const long long bh = static_cast<long long>(b) * H + h;
  const int ntiles = (N + ROWS - 1) / ROWS;

  // lse and delta of queries m0 .. m0 + 63 into buffer `buf`, zeros past N
  auto load_terms = [&](int buf, int m0) {
    const int i = threadIdx.x % ROWS, n = m0 + i;
    const float* src = (threadIdx.x < ROWS ? lse : delta) + bh * N
        + (n < N ? n : N - 1);
    cp_async_4(smem_u32(terms + (2 * buf + threadIdx.x / ROWS) * ROWS + i),
               src, n < N ? 4 : 0);
  };
  // the copies of query tile t (rows m1 ..): q and do by cp.async, or for
  // rows on 2 bytes only staged, and their lse and delta
  auto copy_qdo = [&](int t, int m1) {
    if (stage_q)
      stage_rows_async<DP>(Qs + T, qbh, sq.n, m1, N, d);
    else
      load_rows_async_width<DP>(w.q, Qs + (t & 1) * T, qbh, sq.n, m1, N, d);
    if (stage_do)
      stage_rows_async<DP>(dOs + T, dobh, sdo.n, m1, N, d);
    else
      load_rows_async_width<DP>(w.dout, dOs + (t & 1) * T, dobh, sdo.n, m1,
                                N, d);
    load_terms(t & 1, m1);
    cp_async_commit();
  };
  // query tile 0 (as every later one), then k and v of the keys: by
  // cp.async, or through registers
  copy_qdo(0, 0);
  load_rows_width<DP>(w.k, Ks, k + b * sk.b + h * sk.h, sk.n, n0, N, d);
  load_rows_width<DP>(w.v, Vs, v + b * sv.b + h * sv.h, sv.n, n0, N, d);
  cp_async_commit();

  float acc_k[DP / 2], acc_v[DP / 2];        // dk, dv: keys r0 and r0 + 8
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pt[4][4], dst[4][4];
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const uint32_t Qt = Qs + (stage_q ? 0 : buf * T),
                   dOt = dOs + (stage_do ? 0 : buf * T);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                         // tile t is in; tile t - 1 is
                                             // read by no product any more
    if (stage_q || stage_do) {
      if (stage_q)
        unstage_rows<DP>(Qs, smem + (Qs - Ks) + T, qbh, sq.n, ROWS * t, N, d);
      if (stage_do)
        unstage_rows<DP>(dOs, smem + (dOs - Ks) + T, dobh, sdo.n, ROWS * t,
                         N, d);
      fence_proxy_async();
      __syncthreads();
    }
    fence_regs(st);
    fence_regs(dpt);
    two_products<KS>(st, dpt, Ks, Qt, Vs, dOt);
    fence_regs(st);
    fence_regs(dpt);
    if (t + 1 < ntiles)                      // tile t + 1, under tile t
      copy_qdo(t + 1, ROWS * (t + 1));
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const float* lse_t = terms + 2 * buf * ROWS;
    const float* delta_t = lse_t + ROWS;
    const int valid = N - ROWS * t;          // queries of the tile below N
    if (valid < ROWS)
      p_ds_cols<true>(st, dpt, lse_t, delta_t, valid, col0, pt, dst);
    else
      p_ds_cols<false>(st, dpt, lse_t, delta_t, valid, col0, pt, dst);
    fence_regs(acc_k);
    fence_regs(acc_v);
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc_v, pt[kk], desc_mnmajor(dOt, ROWS, 16 * kk), 1);
      wgmma_rs(acc_k, dst[kk], desc_mnmajor(Qt, ROWS, 16 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
    fence_regs(pt);
    fence_regs(dst);
  }

  __syncthreads();                           // no product reads k, v any more
  const long long out0 = ((static_cast<long long>(b) * N + n0) * H + h) * d;
  stage_acc_tile<DP>(acc_k, smem);
  stage_acc_tile<DP>(acc_v, smem + T);
  __syncthreads();
  store_rows_width(w.out, smem, dk + out0, static_cast<long long>(H) * d,
                   N - n0, d);
  store_rows_width(w.out, smem + T, dv + out0, static_cast<long long>(H) * d,
                   N - n0, d);
}

// Dynamic shared memory of the kernels: two 64-row tiles, two streamed
// operands of a tile and a second slot each, the row terms (the dq
// kernel's lse and delta of its rows; the dk/dv kernel's of two query
// tiles), alignment slack.
template <int DP>
constexpr size_t bwd_unaligned_smem(int terms) {
  return 2 * size_t(ROWS) * DP * 2 + 2 * (size_t(ROWS) * DP * 2
                                          + slot_bytes<DP>())
      + terms * ROWS * 4 + 1024;
}

template <int KS>
int launch_bwd_unaligned(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int N, int H, int d, const long long* st,
                         cudaStream_t stream) {
  static bool ready_dq[64] = {}, ready_kv[64] = {};
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const long long sout[3] = {static_cast<long long>(N) * H * d,
                             static_cast<long long>(H) * d, d};
  // dq, dk, dv are allocated alike; their stores take the narrowest width
  int wout = row_width(dq, sout);
  if (row_width(dk, sout) < wout) wout = row_width(dk, sout);
  if (row_width(dv, sout) < wout) wout = row_width(dv, sout);
  const BwdWidths w{row_width(q, st), row_width(k, st + 3),
                    row_width(v, st + 6), row_width(o, st + 9),
                    row_width(dout, st + 12), wout};
  const dim3 grid((N + ROWS - 1) / ROWS, H, B);

  cudaError_t err =
      allow_full_smem(attention_bwd_dq_unaligned_kernel<KS>, ready_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_unaligned_kernel<KS>
      <<<grid, WG, bwd_unaligned_smem<panel_cols(KS)>(2), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<bf16*>(dq), N, H, d, sq, sk,
          sv, so, sdo, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_full_smem(attention_bwd_dkdv_unaligned_kernel<KS>, ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_unaligned_kernel<KS>
      <<<grid, WG, bwd_unaligned_smem<panel_cols(KS)>(4), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H, d, sq, sk,
          sv, sdo, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ofb

// bf16 only. strides: 15 element strides, (batch, token, head) for q, k, v,
// o, do, any alignment (the head-dim stride is 1). lse and delta are
// contiguous (B, H, N) fp32 (delta is scratch the call fills); dq, dk, dv
// are contiguous (B, N, H, d). Takes any N >= 1, any d in [1, 128], and
// B, H within the grid's limits; returns -1 for anything else, else
// cudaGetLastError() after the launches.
extern "C" int ofb_attention_bwd_unaligned(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk,
                                           void* dv, int B, int N, int H,
                                           int d, const long long* strides,
                                           void* stream) {
  using namespace ofb::sm90;
  if (N < 1 || d < 1 || d > 128 || B < 1 || B > 65535 || H < 1 ||
      H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
#define OFB_CASE(KS)                                                         \
  case KS:                                                                   \
    return launch_bwd_unaligned<KS>(q, k, v, o, dout, lse, delta, dq, dk,    \
                                    dv, B, N, H, d, strides, s);
    OFB_CASE(1) OFB_CASE(2) OFB_CASE(3) OFB_CASE(4)
    OFB_CASE(5) OFB_CASE(6) OFB_CASE(7) OFB_CASE(8)
#undef OFB_CASE
  }
  return -1;
}
