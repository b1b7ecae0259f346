// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the general
// body, for every shape, type and view the wrapper takes.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)). Same function: q arrives
// already scaled; scores, row max and row sums are fp32; p is rounded to
// v's type before p @ v; o keeps the input type; the block also writes the
// row log-sum-exp (fp32, (B, H, N)), from which the backward kernels
// rebuild p. No mask, no dropout. Any N >= 1 and any d in [1, 128].
//
// Which calls come here. bf16 with 16-byte aligned rows and d % 8 == 0 goes
// to the resident body (attention_fwd_resident.cu, N <= 256) or the
// streaming one (attention_fwd_streaming.cu, N > 256); ops/attention.py
// `attention_body` decides. This body takes the rest: every fp32 call
// (`--compute-dtype float32`, the fp32 checks), bf16 views whose rows are
// not 16-byte aligned, and head dims that are not a multiple of 8.
//
// fp32 (attention_fwd_kernel): FMA on the CUDA cores, not the tensor cores
// (TF32 would keep ~3 decimal digits). Bound: 4 B H N² d flops against the
// CUDA cores' 67 TFLOP/s; at (B, N, H, d) = (256, 197, 6, 64) 0.228 ms,
// where moving q, k, v, o once takes 0.057 ms: the operations bound it.
// So the design is about keeping the FMA pipes fed:
//   * a block of 128 threads keeps 128 query rows resident (64 when
//     d > 64) and walks the keys in 64-row tiles; each thread owns an 8 x 8
//     tile of scores (rows a0 + 4t, keys cg + 8i; attention_common.cuh), so
//     every float4 it reads from shared memory feeds 16 FMAs (4 a word);
//   * the scores, the running row max and the row sums stay in registers;
//     the 8 lanes of a row reduce the max with three __shfl_xor_sync, and
//     the sums once at the end. p passes through shared memory once, half
//     a key tile (32 keys) at a time in a buffer of the warp's own rows
//     (only __syncwarp), to feed p v, read back as float4 broadcasts;
//   * k and v come by cp.async (16 bytes when d % 4 == 0 and the rows are
//     aligned, else 4) into the second of two buffers while the current
//     tile is computed: one block barrier a tile;
//   * the last key tile computes q kᵀ only for its ceil(valid / 8) steps of
//     8 keys, p v only for its ceil(valid / 4) groups of 4, and a warp whose
//     32 rows all lie past N does no arithmetic. At N = 197 that is 224
//     query rows x 200 keys for q kᵀ and 224 x 200 for p v: 1.15x the
//     bound's 197 x 197.
//   Shared memory at d = 64: q 32 KB, k and v 2 x 2 x 16 KB, p 16 KB, 112 KB
//   a block, so two blocks (8 warps) fit an SM, as `__launch_bounds__(128,
//   2)` holds the registers to 255 a thread (ptxas: 254, no spills; above
//   d = 64, 4 x 8 tiles of 64 rows, one block an SM). chip_smoke.py prints
//   what ptxas reports for every kernel.
// What holds it back: an 8 x 8 tile reads one shared-memory word for every
// 4 FMAs, which is all an SM's shared memory delivers for its FMA rate
// (attention_common.cuh), so the two pipes share the time; at
// (256, 197, 6, 64) the kernel runs at about 42% of the FMA peak on the
// padded work (PERF.md). 4 x 8 tiles, with or without twice the warps,
// were slower (`probe_kernels general`).
//
// bf16 (attention_fwd_wmma_kernel): the products on the tensor cores with
// WMMA, 4 warps of 16 query rows each, the running o in shared memory.
#include "attention_common.cuh"

namespace ofb {

template <int RM, int DJ, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int N, int H, int d, Strides sq,
                     Strides sk, Strides sv, bool vec) {
  constexpr int DP = 32 * DJ, BM = 4 * RM * NW, KP = 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // BM x DP
  float* Ks = Qs + BM * DP;                  // 2 x 64 x DP
  float* Vs = Ks + 2 * TILE * DP;            // 2 x 64 x DP
  float* Ps = Vs + 2 * TILE * DP;            // BM x 32: p of half a key tile

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, rg = (threadIdx.x >> 3) & 3,
            cg = threadIdx.x & 7;
  const int a0 = 4 * RM * warp + rg;
  const bool active = m0 + 4 * RM * warp < N;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nt = (N + TILE - 1) / TILE, nk4 = (d + 3) >> 2;

  stage_rows<DP>(Qs, q + b * sq.b + h * sq.h, sq.n, m0, BM, N, d, vec);
  stage_rows<DP>(Ks, kb, sk.n, 0, TILE, N, d, vec);
  stage_rows<DP>(Vs, vb, sv.n, 0, TILE, N, d, vec);
  sm90::cp_async_commit();

  float acc[RM][4 * DJ], m_run[RM], l_part[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    m_run[t] = -INFINITY;
    l_part[t] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DJ; ++j) acc[t][j] = 0.f;
  }

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
    const float* Kt = Ks + (jt & 1) * TILE * DP;
    const float* Vt = Vs + (jt & 1) * TILE * DP;
    const int n0 = jt * TILE, nv = min(TILE, N - n0), ni = (nv + 7) >> 3;

    float s[RM][8];
    mm_nt_rows<RM, DP>(s, Qs, a0, Kt, cg, nk4, ni);

    // online softmax over the tile's keys, in registers
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (cg + 8 * i >= nv) s[t][i] = -INFINITY;
        mx = fmaxf(mx, s[t][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[t], mx);  // finite: key n0 is valid
      const float alpha = exp_f32(m_run[t] - m_new);
      m_run[t] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[t][i] = exp_f32(s[t][i] - m_new);  // fp32: p needs no rounding
        sum += s[t][i];
      }
      l_part[t] = l_part[t] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 4 * DJ; ++j) acc[t][j] *= alpha;
    }

    // o += p v, 32 keys at a time through the warp's rows of Ps
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nh = min(KP, nv - KP * half);   // valid keys of this half
      if (nh <= 0) break;
      __syncwarp();                    // the last half's reads are done
#pragma unroll
      for (int t = 0; t < RM; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Ps[pidx<KP>(a0 + 4 * t, cg + 8 * i)] = s[t][4 * half + i];
      __syncwarp();
      mm_pv<RM, DJ, KP>(acc, Ps, a0, Vt + KP * half * DP, cg, (nh + 3) >> 2);
    }
  }

  if (!active) return;
  float inv[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    float l = l_part[t];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    inv[t] = 1.f / l;
    const int n = m0 + a0 + 4 * t;
    if (cg == 0 && n < N)
      lse[(static_cast<long long>(b) * H + h) * N + n] = m_run[t] + logf(l);
  }
  store_rows_f32<RM, DJ>(o, acc, inv, b, h, m0, a0, cg, N, H, d);
}

// The bf16 version on the tensor cores: the same running-max softmax, with
// s = q kᵀ and o += p v as WMMA products. Warp w owns query rows 16w ..;
// the running o lives in shared memory (fp32) so the rescale by
// exp(m - m') can touch it element by element between products.
__global__ void __launch_bounds__(WTHREADS)
attention_fwd_wmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int N, int H, int d,
                          Strides sq, Strides sk, Strides sv, bool vec) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = pad16(d), ldb = dp + 8, ldo = dp + 4, nj = dp / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // 64 x ldb
  bf16* Ks = Qs + TILE * ldb;                        // 64 x ldb
  bf16* Vs = Ks + TILE * ldb;                        // 64 x ldb
  bf16* Ps = Vs + TILE * ldb;                        // 64 x LDP
  float* Ss = reinterpret_cast<float*>(Ps + TILE * LDP);  // 64 x LDS
  float* Os = Ss + TILE * LDS;                       // 64 x ldo
  float* row_m = Os + TILE * ldo;
  float* row_l = row_m + TILE;

  const int m0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 2, half = lane % 2;  // softmax lanes

  load_tile_bf16(Qs, ldb, q, sq, b, h, m0, N, d, dp, vec);
  for (int i = threadIdx.x; i < TILE * ldo; i += blockDim.x) Os[i] = 0.f;
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += TILE) {
    __syncthreads();                     // the last tile is no longer read
    load_tile_bf16(Ks, ldb, k, sk, b, h, n0, N, d, dp, vec);
    load_tile_bf16(Vs, ldb, v, sv, b, h, n0, N, d, dp, vec);
    __syncthreads();

    // s = q kᵀ for the warp's 16 rows and the tile's 64 keys
    for (int j = 0; j < TILE / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + 16 * warp * ldb + kk, ldb);
        wmma::load_matrix_sync(fb, Ks + 16 * j * ldb + kk, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + 16 * warp * LDS + 16 * j, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // running-max softmax: two lanes a row, 32 columns each
    {
      const float* srow = Ss + row * LDS + half * 32;
      bf16* prow = Ps + row * LDP + half * 32;
      const int c0 = n0 + half * 32;
      float mx = -INFINITY;
      for (int c = 0; c < 32; ++c)
        if (c0 + c < N) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float p = (c0 + c < N) ? expf(srow[c] - m_new) : 0.f;
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float a = expf(m_old - m_new);
      float* orow = Os + row * ldo;
      for (int c = half; c < dp; c += 2) orow[c] *= a;
      __syncwarp();                      // both lanes have read row_m[row]
      if (half == 0) {
        row_l[row] = row_l[row] * a + sum;
        row_m[row] = m_new;
      }
    }
    __syncwarp();

    // o += p v for the warp's 16 rows
    for (int j = 0; j < nj; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + 16 * warp * ldo + 16 * j, ldo,
                             wmma::mem_row_major);
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + 16 * warp * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, Vs + kk * ldb + 16 * j, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + 16 * warp * ldo + 16 * j, acc, ldo,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (lane < 16) {
    const int r = 16 * warp + lane, n = m0 + r;
    const float l = row_l[r];
    if (n < N)
      lse[(static_cast<long long>(b) * H + h) * N + n] = row_m[r] + logf(l);
    row_l[r] = 1.f / l;                  // now the output row scale
  }
  __syncwarp();
  store_rows_bf16(o, Os, ldo, row_l, b, h, m0, N, H, d);
}

template <int RM, int DJ, int NW, int MINB>
int launch_fwd_f32_t(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int N, int H, int d,
                     const long long* st, cudaStream_t stream) {
  constexpr int BM = 4 * RM * NW;
  const size_t smem = f32_smem_fwd(32 * DJ, BM);
  auto kernel = attention_fwd_kernel<RM, DJ, NW, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* ptrs[3] = {q, k, v};
  const dim3 grid((N + BM - 1) / BM, H, B);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      vec_ok(ptrs, st, 3, d, 4));
  return static_cast<int>(cudaGetLastError());
}

// By DJ = ceil(d / 32), the output column groups a lane holds: the rows a
// thread owns (RM), the warps of a block (NW) and the blocks an SM is to
// hold (MINB, which caps the registers).
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int H, int d, const long long* st,
                   cudaStream_t stream) {
#define OFB_FWD_F32(dj, rm, nw, minb)                                        \
  case dj:                                                                   \
    return launch_fwd_f32_t<rm, dj, nw, minb>(q, k, v, o, lse, B, N, H, d,   \
                                              st, stream);
  switch ((d + 31) / 32) {
    OFB_FWD_F32(1, 8, 4, 2) OFB_FWD_F32(2, 8, 4, 2)
    OFB_FWD_F32(3, 4, 4, 1) OFB_FWD_F32(4, 4, 4, 1)
  }
#undef OFB_FWD_F32
  return -1;
}

int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int N, int H, int d,
                    const long long* st, cudaStream_t stream) {
  const int dp = pad16(d);
  const size_t smem = align128(sizeof(bf16) * (3 * TILE * (dp + 8) + TILE * LDP))
      + sizeof(float) * (TILE * LDS + TILE * (dp + 4) + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* ptrs[3] = {q, k, v};
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  attention_fwd_wmma_kernel<<<grid, WTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      vec_ok(ptrs, st, 3, d, 8));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ofb

// dtype: 0 = float32, 1 = bfloat16. strides: 9 element strides, (batch,
// token, head) for q, k, v. o is contiguous (B, N, H, d), lse contiguous
// (B, H, N) fp32. Returns cudaGetLastError() after the launch.
extern "C" int ofb_attention_fwd(int dtype, const void* q, const void* k,
                                 const void* v, void* o, void* lse, int B,
                                 int N, int H, int d,
                                 const long long* strides, void* stream) {
  if (d < 1 || d > ofb::DMAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ofb::launch_fwd_f32(q, k, v, o, lse, B, N, H, d, strides, s);
  if (dtype == 1)
    return ofb::launch_fwd_bf16(q, k, v, o, lse, B, N, H, d, strides, s);
  return -1;
}
