// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the general body, for every shape, type and view the wrapper takes.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)). Same math, no scale inside:
//   p  = softmax(q kᵀ)               fp32
//   dv = pᵀ do                        p and do in fp32
//   dp = do vᵀ                        fp32
//   ds = p ⊙ (dp − rowsum(p ⊙ dp))    rounded to q's type
//   dq = ds k,  dk = dsᵀ q            fp32 sums, outputs in the input type
//
// Which calls come here: as in attention_fwd.cu, every fp32 call, bf16
// views whose rows are not 16-byte aligned and head dims that are not a
// multiple of 8 (bf16 with aligned rows and d % 8 == 0 goes to
// attention_bwd_resident.cu or attention_bwd_streaming.cu). Any N >= 1 and
// any d in [1, 128].
//
// Split. The TPU kernel keeps one (batch, head) in VMEM and sums dk, dv
// over all query rows inside it. Hopper blocks run in no order and cannot
// carry sums between them, so the work is split by what it sums over, with
// no atomics:
//   * the dq kernel: a block keeps query rows (and their do) resident,
//     walks the keys and sums dq in registers;
//   * the dk/dv kernel: a block keeps key rows (and their v) resident,
//     walks the queries and sums dk and dv in registers.
// p is rebuilt from the forward's row log-sum-exp, p = exp(q kᵀ − lse), so
// no block needs a whole row of scores. The row term rowsum(p ⊙ dp) equals
// rowsum(do ⊙ o) (o = p v): the dq kernel computes it once per row from do
// and the forward's o, uses it, and writes it to `delta` for the dk/dv
// kernel, launched after it on the same stream. Rows and keys past N get
// p = 0 and are never written.
//
// fp32 (attention_bwd_dq_kernel, attention_bwd_dkdv_kernel): FMA on the
// CUDA cores. Bound: 10 B H N² d flops (the bound counts the recomputed
// q kᵀ and four products) against 67 TFLOP/s, 0.569 ms at (256, 197, 6, 64),
// where moving the seven (B, N, H, d) tensors once takes 0.099 ms: the
// operations bound it. The split computes q kᵀ and do vᵀ in both kernels,
// seven products where the bound counts five. Both kernels follow the
// forward's design (attention_common.cuh): 128 threads, register tiles of
// scores (rows a0 + 4t, streamed rows cg + 8i), the streamed side in
// 64-row tiles through two cp.async buffers one tile ahead (k and v into
// the dq kernel; q, do and their lse and delta into the dk/dv kernel), the
// last tile computed only as far as its valid rows (steps of 8 for the
// scores, 4 for the products), warps whose rows all lie past N idle. A
// score tile leaves registers once, into a 64-column buffer of the warp's
// own rows (only __syncwarp): the dq kernel keeps dp − delta there while it
// computes q kᵀ, then ds; the dk/dv kernel keeps p there for pᵀ do while it
// computes do vᵀ, then ds for dsᵀ q. So a thread holds its output tiles (dq;
// dk and dv) and one score tile, no more. ds is rounded to q's type, a
// no-op in fp32.
// Tiles: the backward keeps 64 resident rows, 4 x 8 register tiles (2.67
// FMAs a shared-memory word), so that two blocks fit an SM: 112 KB (dq: q,
// do 2 x 16 KB, k and v 4 x 16 KB, ds 16 KB) and 113 KB (dk/dv) at d = 64,
// 208 registers, no spills. The forward's 8 x 8 tiles over 128 rows need
// 160 KB and 255 registers here, one block (4 warps) an SM, and measured
// slower on the H100 (`probe_kernels general`, PERF.md). What holds both kernels
// back is the forward's: shared-memory words, here 3 for every 8 FMAs.
//
// bf16 runs on the tensor cores (WMMA) with the same split.
#include "attention_common.cuh"

namespace ofb {

template <int RM, int DJ, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int N, int H, int d, Strides sq, Strides sk,
                        Strides sv, Strides so, Strides sdo, bool vec) {
  constexpr int DP = 32 * DJ, BM = 4 * RM * NW;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // BM x DP
  float* dOs = Qs + BM * DP;                 // BM x DP
  float* Ks = dOs + BM * DP;                 // 2 x 64 x DP
  float* Vs = Ks + 2 * TILE * DP;            // 2 x 64 x DP
  float* Ds = Vs + 2 * TILE * DP;            // BM x 64: dp − delta, then ds

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, rg = (threadIdx.x >> 3) & 3,
            cg = threadIdx.x & 7;
  const int a0 = 4 * RM * warp + rg;
  const bool active = m0 + 4 * RM * warp < N;
  const long long bh = static_cast<long long>(b) * H + h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nt = (N + TILE - 1) / TILE, nk4 = (d + 3) >> 2;

  stage_rows<DP>(Qs, q + b * sq.b + h * sq.h, sq.n, m0, BM, N, d, vec);
  stage_rows<DP>(dOs, dout + b * sdo.b + h * sdo.h, sdo.n, m0, BM, N, d, vec);
  stage_rows<DP>(Ks, kb, sk.n, 0, TILE, N, d, vec);
  stage_rows<DP>(Vs, vb, sv.n, 0, TILE, N, d, vec);
  sm90::cp_async_commit();

  float acc[RM][4 * DJ], row_lse[RM], row_delta[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t)
#pragma unroll
    for (int j = 0; j < 4 * DJ; ++j) acc[t][j] = 0.f;

  for (int jt = 0; jt < nt; ++jt) {
    sm90::cp_async_wait<0>();
    __syncthreads();                 // tile jt landed; tile jt - 1 is done
    if (jt + 1 < nt) {
      const int nb = (jt + 1) & 1;
      stage_rows<DP>(Ks + nb * TILE * DP, kb, sk.n, (jt + 1) * TILE, TILE, N,
                     d, vec);
      stage_rows<DP>(Vs + nb * TILE * DP, vb, sv.n, (jt + 1) * TILE, TILE, N,
                     d, vec);
      sm90::cp_async_commit();
    }
    if (!active) continue;
    if (jt == 0) {
      // delta = rowsum(do ⊙ o) over the lane's columns, then its row's 8
      // lanes; written once, for the dk/dv kernel
#pragma unroll
      for (int t = 0; t < RM; ++t) {
        const int r = a0 + 4 * t, n = m0 + r;
        float part = 0.f;
        if (n < N) {
          const float* orow = o + b * so.b + n * so.n + h * so.h;
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            const int c = 32 * jj + 4 * cg;
            const float4 x = *reinterpret_cast<const float4*>(
                dOs + r * DP + tswz(r, 8 * jj + cg));
            if (c < d) part = fmaf(x.x, orow[c], part);
            if (c + 1 < d) part = fmaf(x.y, orow[c + 1], part);
            if (c + 2 < d) part = fmaf(x.z, orow[c + 2], part);
            if (c + 3 < d) part = fmaf(x.w, orow[c + 3], part);
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        row_delta[t] = part;
        row_lse[t] = n < N ? lse[bh * N + n] : 0.f;
        if (cg == 0 && n < N) delta[bh * N + n] = part;
      }
    }
    const float* Kt = Ks + (jt & 1) * TILE * DP;
    const float* Vt = Vs + (jt & 1) * TILE * DP;
    const int n0 = jt * TILE, nv = min(TILE, N - n0), ni = (nv + 7) >> 3;

    float s[RM][8];
    mm_nt_rows<RM, DP>(s, dOs, a0, Vt, cg, nk4, ni);      // dp = do vᵀ
#pragma unroll
    for (int t = 0; t < RM; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        Ds[pidx<TILE>(a0 + 4 * t, cg + 8 * i)] = s[t][i] - row_delta[t];
    mm_nt_rows<RM, DP>(s, Qs, a0, Kt, cg, nk4, ni);       // s = q kᵀ
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      const bool row_in = m0 + a0 + 4 * t < N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int at = pidx<TILE>(a0 + 4 * t, cg + 8 * i);
        const float p = row_in && cg + 8 * i < nv
            ? exp_f32(s[t][i] - row_lse[t]) : 0.f;
        Ds[at] = p * Ds[at];         // ds, fp32: no rounding
      }
    }
    __syncwarp();
    mm_pv<RM, DJ, TILE>(acc, Ds, a0, Kt, cg, (nv + 3) >> 2);  // dq += ds k
    __syncwarp();                    // Ds is read before the next tile
  }
  if (!active) return;
  float one[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) one[t] = 1.f;
  store_rows_f32<RM, DJ>(dq, acc, one, b, h, m0, a0, cg, N, H, d);
}

template <int RM, int DJ, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int N, int H, int d, Strides sq, Strides sk,
                          Strides sv, Strides sdo, bool vec) {
  constexpr int DP = 32 * DJ, BM = 4 * RM * NW;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // BM x DP
  float* Vs = Ks + BM * DP;                  // BM x DP
  float* Qs = Vs + BM * DP;                  // 2 x 64 x DP
  float* dOs = Qs + 2 * TILE * DP;           // 2 x 64 x DP
  float* Bs = dOs + 2 * TILE * DP;           // BM x 64: p, then ds (keys x queries)
  float* Ls = Bs + BM * TILE;                // 2 x 64: lse of the query tile
  float* Dl = Ls + 2 * TILE;                 // 2 x 64: delta of the query tile

  const int n0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, rg = (threadIdx.x >> 3) & 3,
            cg = threadIdx.x & 7;
  const int a0 = 4 * RM * warp + rg;
  const bool active = n0 + 4 * RM * warp < N;
  const long long bh = static_cast<long long>(b) * H + h;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sdo.b + h * sdo.h;
  const int nt = (N + TILE - 1) / TILE, nk4 = (d + 3) >> 2;

  // the query tile mt's rows: q, do, and their lse and delta (4 bytes each)
  auto stage_queries = [&](int mt) {
    const int nb = mt & 1, r0 = mt * TILE;
    stage_rows<DP>(Qs + nb * TILE * DP, qb, sq.n, r0, TILE, N, d, vec);
    stage_rows<DP>(dOs + nb * TILE * DP, db, sdo.n, r0, TILE, N, d, vec);
    if (threadIdx.x < 2 * TILE) {
      const int i = threadIdx.x & (TILE - 1), n = r0 + i;
      const bool ok = n < N;
      const float* src = (threadIdx.x < TILE ? lse : delta) + bh * N;
      float* dst = (threadIdx.x < TILE ? Ls : Dl) + nb * TILE + i;
      sm90::cp_async_4(sm90::smem_u32(dst), ok ? src + n : src, ok ? 4 : 0);
    }
    sm90::cp_async_commit();
  };
  stage_rows<DP>(Ks, k + b * sk.b + h * sk.h, sk.n, n0, BM, N, d, vec);
  stage_rows<DP>(Vs, v + b * sv.b + h * sv.h, sv.n, n0, BM, N, d, vec);
  stage_queries(0);

  float acc_k[RM][4 * DJ], acc_v[RM][4 * DJ];
#pragma unroll
  for (int t = 0; t < RM; ++t)
#pragma unroll
    for (int j = 0; j < 4 * DJ; ++j) {
      acc_k[t][j] = 0.f;
      acc_v[t][j] = 0.f;
    }

  for (int mt = 0; mt < nt; ++mt) {
    sm90::cp_async_wait<0>();
    __syncthreads();                 // tile mt landed; tile mt - 1 is done
    if (mt + 1 < nt) stage_queries(mt + 1);
    if (!active) continue;
    const int nb = mt & 1;
    const float* Qt = Qs + nb * TILE * DP;
    const float* dOt = dOs + nb * TILE * DP;
    const float* Lt = Ls + nb * TILE;
    const float* Dt = Dl + nb * TILE;
    const int nv = min(TILE, N - mt * TILE), ni = (nv + 7) >> 3;

    float s[RM][8];
    mm_nt_rows<RM, DP>(s, Ks, a0, Qt, cg, nk4, ni);      // sᵀ = k qᵀ
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      const bool key_in = n0 + a0 + 4 * t < N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = cg + 8 * i;
        Bs[pidx<TILE>(a0 + 4 * t, c)] =
            key_in && c < nv ? exp_f32(s[t][i] - Lt[c]) : 0.f;
      }
    }
    __syncwarp();
    mm_pv<RM, DJ, TILE>(acc_v, Bs, a0, dOt, cg, (nv + 3) >> 2);  // dv += pᵀ do
    mm_nt_rows<RM, DP>(s, Vs, a0, dOt, cg, nk4, ni);     // dpᵀ = v doᵀ
    __syncwarp();                    // the warp's pᵀ do reads are done
#pragma unroll
    for (int t = 0; t < RM; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = cg + 8 * i, at = pidx<TILE>(a0 + 4 * t, c);
        Bs[at] = Bs[at] * (s[t][i] - Dt[c]);   // dsᵀ, fp32: no rounding
      }
    __syncwarp();
    mm_pv<RM, DJ, TILE>(acc_k, Bs, a0, Qt, cg, (nv + 3) >> 2);  // dk += dsᵀ q
  }
  if (!active) return;
  float one[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) one[t] = 1.f;
  store_rows_f32<RM, DJ>(dk, acc_k, one, b, h, n0, a0, cg, N, H, d);
  store_rows_f32<RM, DJ>(dv, acc_v, one, b, h, n0, a0, cg, N, H, d);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Same split and math; each warp owns 16 rows of
// the block's tile. Scores are computed transposed in the dk/dv kernel
// (warp rows = keys), so that pᵀ do and dsᵀ q are plain row-major products.
// p enters pᵀ do rounded to bf16 (the tensor cores take bf16 operands), a
// relative error of 2^-9 per term where the TPU kernel kept p in fp32.
// ---------------------------------------------------------------------------

template <int NJ>
__global__ void __launch_bounds__(WTHREADS)
attention_bwd_dq_wmma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq,
                             int N, int H, int d, Strides sq, Strides sk,
                             Strides sv, Strides so, Strides sdo, bool vec) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = 16 * NJ, ldb = dp + 8, ldo = dp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // 64 x ldb
  bf16* dOs = Qs + TILE * ldb;                       // 64 x ldb
  bf16* Ks = dOs + TILE * ldb;                       // 64 x ldb
  bf16* Vs = Ks + TILE * ldb;                        // 64 x ldb
  bf16* dSs = Vs + TILE * ldb;                       // 64 x LDP
  float* Ss = reinterpret_cast<float*>(dSs + TILE * LDP);  // 64 x LDS
  float* dPs = Ss + TILE * LDS;                      // 64 x LDS
  float* Stage = dPs + TILE * LDS;                   // 64 x ldo
  float* row_lse = Stage + TILE * ldo;
  float* row_delta = row_lse + TILE;

  const int m0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 2, half = lane % 2;
  const long long bh = static_cast<long long>(b) * H + h;
  const bool row_in = m0 + row < N;

  load_tile_bf16(Qs, ldb, q, sq, b, h, m0, N, d, dp, vec);
  load_tile_bf16(dOs, ldb, dout, sdo, b, h, m0, N, d, dp, vec);
  __syncthreads();
  {  // delta = rowsum(do ⊙ o), two lanes a row
    float acc = 0.f;
    if (row_in) {
      const bf16* orow = o + b * so.b + (m0 + row) * so.n + h * so.h;
      for (int c = half; c < d; c += 2)
        acc += __bfloat162float(dOs[row * ldb + c]) * __bfloat162float(orow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      row_delta[row] = acc;
      row_lse[row] = row_in ? lse[bh * N + m0 + row] : 0.f;
      if (row_in) delta[bh * N + m0 + row] = acc;
    }
  }
  __syncwarp();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int n0 = 0; n0 < N; n0 += TILE) {
    __syncthreads();
    load_tile_bf16(Ks, ldb, k, sk, b, h, n0, N, d, dp, vec);
    load_tile_bf16(Vs, ldb, v, sv, b, h, n0, N, d, dp, vec);
    __syncthreads();
    for (int j = 0; j < TILE / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dpf;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dpf, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + 16 * warp * ldb + kk, ldb);
        wmma::load_matrix_sync(fb, Ks + 16 * j * ldb + kk, ldb);
        wmma::mma_sync(s, fa, fb, s);
        wmma::load_matrix_sync(fa, dOs + 16 * warp * ldb + kk, ldb);
        wmma::load_matrix_sync(fb, Vs + 16 * j * ldb + kk, ldb);
        wmma::mma_sync(dpf, fa, fb, dpf);
      }
      wmma::store_matrix_sync(Ss + 16 * warp * LDS + 16 * j, s, LDS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dPs + 16 * warp * LDS + 16 * j, dpf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = (row_in && n0 + c < N)
          ? expf(Ss[row * LDS + c] - row_lse[row]) : 0.f;
      dSs[row * LDP + c] =
          __float2bfloat16(p * (dPs[row * LDS + c] - row_delta[row]));
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, dSs + 16 * warp * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, Ks + kk * ldb + 16 * j, ldb);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(Stage + 16 * warp * ldo + 16 * j, acc[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dq, Stage, ldo, nullptr, b, h, m0, N, H, d);
}

template <int NJ>
__global__ void __launch_bounds__(WTHREADS)
attention_bwd_dkdv_wmma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int N, int H, int d, Strides sq, Strides sk,
                               Strides sv, Strides sdo, bool vec) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = 16 * NJ, ldb = dp + 8, ldo = dp + 4;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);      // 64 x ldb
  bf16* Vs = Ks + TILE * ldb;                        // 64 x ldb
  bf16* Qs = Vs + TILE * ldb;                        // 64 x ldb
  bf16* dOs = Qs + TILE * ldb;                       // 64 x ldb
  bf16* Pt = dOs + TILE * ldb;                       // 64 keys x LDP
  bf16* dSt = Pt + TILE * LDP;                       // 64 keys x LDP
  float* St = reinterpret_cast<float*>(dSt + TILE * LDP);  // 64 x LDS
  float* dPt = St + TILE * LDS;                      // 64 x LDS
  float* Stage = dPt + TILE * LDS;                   // 64 x ldo
  float* col_lse = Stage + TILE * ldo;
  float* col_delta = col_lse + TILE;

  const int n0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int krow = 16 * warp + lane / 2, half = lane % 2;
  const long long bh = static_cast<long long>(b) * H + h;
  const bool key_in = n0 + krow < N;

  load_tile_bf16(Ks, ldb, k, sk, b, h, n0, N, d, dp, vec);
  load_tile_bf16(Vs, ldb, v, sv, b, h, n0, N, d, dp, vec);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[NJ],
      acc_v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::fill_fragment(acc_k[j], 0.f);
    wmma::fill_fragment(acc_v[j], 0.f);
  }

  for (int m0 = 0; m0 < N; m0 += TILE) {
    __syncthreads();
    load_tile_bf16(Qs, ldb, q, sq, b, h, m0, N, d, dp, vec);
    load_tile_bf16(dOs, ldb, dout, sdo, b, h, m0, N, d, dp, vec);
    if (threadIdx.x < TILE) {
      const int n = m0 + threadIdx.x;
      col_lse[threadIdx.x] = (n < N) ? lse[bh * N + n] : 0.f;
      col_delta[threadIdx.x] = (n < N) ? delta[bh * N + n] : 0.f;
    }
    __syncthreads();
    // sᵀ = k qᵀ and dpᵀ = v doᵀ for the warp's 16 keys and 64 queries
    for (int j = 0; j < TILE / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dpf;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dpf, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Ks + 16 * warp * ldb + kk, ldb);
        wmma::load_matrix_sync(fb, Qs + 16 * j * ldb + kk, ldb);
        wmma::mma_sync(s, fa, fb, s);
        wmma::load_matrix_sync(fa, Vs + 16 * warp * ldb + kk, ldb);
        wmma::load_matrix_sync(fb, dOs + 16 * j * ldb + kk, ldb);
        wmma::mma_sync(dpf, fa, fb, dpf);
      }
      wmma::store_matrix_sync(St + 16 * warp * LDS + 16 * j, s, LDS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dPt + 16 * warp * LDS + 16 * j, dpf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = (key_in && m0 + c < N)
          ? expf(St[krow * LDS + c] - col_lse[c]) : 0.f;
      Pt[krow * LDP + c] = __float2bfloat16(p);
      dSt[krow * LDP + c] =
          __float2bfloat16(p * (dPt[krow * LDS + c] - col_delta[c]));
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pt + 16 * warp * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, dOs + kk * ldb + 16 * j, ldb);
        wmma::mma_sync(acc_v[j], fa, fb, acc_v[j]);
        wmma::load_matrix_sync(fa, dSt + 16 * warp * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, Qs + kk * ldb + 16 * j, ldb);
        wmma::mma_sync(acc_k[j], fa, fb, acc_k[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(Stage + 16 * warp * ldo + 16 * j, acc_k[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dk, Stage, ldo, nullptr, b, h, n0, N, H, d);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(Stage + 16 * warp * ldo + 16 * j, acc_v[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dv, Stage, ldo, nullptr, b, h, n0, N, H, d);
}

// NJ = head dim / 16, rounded up: the accumulator fragments a warp holds
// per output (compile-time, so they stay in registers).
template <int NJ>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int N,
                    int H, int d, const long long* st, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const void* ptrs[5] = {q, k, v, o, dout};
  const bool vec = vec_ok(ptrs, st, 5, d, 8);
  const int dp = 16 * NJ;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  const size_t fp = sizeof(float) * (2 * TILE * LDS + TILE * (dp + 4) + 2 * TILE);

  const size_t smem_dq = sizeof(bf16) * (4 * TILE * (dp + 8) + TILE * LDP) + fp;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_wmma_kernel<NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_wmma_kernel<NJ><<<grid, WTHREADS, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), N, H, d, sq, sk,
      sv, so, sdo, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv =
      sizeof(bf16) * (4 * TILE * (dp + 8) + 2 * TILE * LDP) + fp;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_wmma_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_wmma_kernel<NJ><<<grid, WTHREADS, smem_kv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H, d, sq, sk, sv,
      sdo, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_bf16_any(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv, int B,
                        int N, int H, int d, const long long* st,
                        cudaStream_t stream) {
#define OFB_BWD_NJ(nj)                                                      \
  case nj:                                                                  \
    return launch_bwd_bf16<nj>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, \
                               N, H, d, st, stream);
  switch (pad16(d) / 16) {
    OFB_BWD_NJ(1) OFB_BWD_NJ(2) OFB_BWD_NJ(3) OFB_BWD_NJ(4)
    OFB_BWD_NJ(5) OFB_BWD_NJ(6) OFB_BWD_NJ(7) OFB_BWD_NJ(8)
  }
#undef OFB_BWD_NJ
  return -1;
}

template <int RM, int DJ, int NW, int MINB>
int launch_bwd_f32_t(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int B, int N,
                     int H, int d, const long long* st, cudaStream_t stream) {
  constexpr int BM = 4 * RM * NW;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const void* ptrs[5] = {q, k, v, o, dout};
  const bool vec = vec_ok(ptrs, st, 5, d, 4);
  const dim3 grid((N + BM - 1) / BM, H, B);

  const size_t smem_dq = f32_smem_dq(32 * DJ, BM);
  auto dq_kernel = attention_bwd_dq_kernel<RM, DJ, NW, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<grid, 32 * NW, smem_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), N, H, d, sq, sk,
      sv, so, sdo, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = f32_smem_dkdv(32 * DJ, BM);
  auto dkdv_kernel = attention_bwd_dkdv_kernel<RM, DJ, NW, MINB>;
  err = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<grid, 32 * NW, smem_kv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), N, H, d, sq, sk, sv,
      sdo, vec);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 kernels' tiles by head dim, as in the forward.
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int B, int N,
                   int H, int d, const long long* st, cudaStream_t stream) {
#define OFB_BWD_F32(dj, rm, nw, minb)                                        \
  case dj:                                                                   \
    return launch_bwd_f32_t<rm, dj, nw, minb>(q, k, v, o, dout, lse, delta,  \
                                              dq, dk, dv, B, N, H, d, st,    \
                                              stream);
  switch ((d + 31) / 32) {
    OFB_BWD_F32(1, 4, 4, 2) OFB_BWD_F32(2, 4, 4, 2)
    OFB_BWD_F32(3, 4, 4, 1) OFB_BWD_F32(4, 4, 4, 1)
  }
#undef OFB_BWD_F32
  return -1;
}

}  // namespace ofb

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, (batch,
// token, head) for q, k, v, o, do. lse and delta are contiguous (B, H, N)
// fp32 (delta is scratch the call fills); dq, dk, dv are contiguous
// (B, N, H, d). Returns cudaGetLastError() after the launches.
extern "C" int ofb_attention_bwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const void* lse,
                                 void* delta, void* dq, void* dk, void* dv,
                                 int B, int N, int H, int d,
                                 const long long* strides, void* stream) {
  if (d < 1 || d > ofb::DMAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ofb::launch_bwd_f32(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                N, H, d, strides, s);
  if (dtype == 1)
    return ofb::launch_bwd_bf16_any(q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, B, N, H, d, strides, s);
  return -1;
}
