// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the general body, fp32, for every shape and view the wrapper takes.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)). Same math, no scale inside:
//   p  = softmax(q kᵀ)               fp32
//   dv = pᵀ do                        p and do in fp32
//   dp = do vᵀ                        fp32
//   ds = p ⊙ (dp − rowsum(p ⊙ dp))    rounded to q's type
//   dq = ds k,  dk = dsᵀ q            fp32 sums, outputs in the input type
//
// Which calls come here: as in attention_fwd.cu, every fp32 call (bf16 goes
// to attention_bwd_resident.cu, attention_bwd_streaming.cu or
// attention_bwd_unaligned.cu). Any N >= 1 and any d in [1, 128].
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
  const bool vec = vec_ok(ptrs, st, 5, d);
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

// fp32 only. strides: 15 element strides, (batch, token, head) for q, k, v,
// o, do. lse and delta are contiguous (B, H, N) fp32 (delta is scratch the
// call fills); dq, dk, dv are contiguous (B, N, H, d). Returns -1 for a
// head dim outside [1, 128], else cudaGetLastError() after the launches.
extern "C" int ofb_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int N, int H,
                                 int d, const long long* strides,
                                 void* stream) {
  if (d < 1 || d > ofb::DMAX) return -1;
  return ofb::launch_bwd_f32(q, k, v, o, dout, lse, delta, dq, dk, dv, B, N,
                             H, d, strides,
                             static_cast<cudaStream_t>(stream));
}
