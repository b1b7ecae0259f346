// Attention backward for Hopper (sm_90a): dq, dk, dv of o = softmax(q kᵀ) v,
// the general body, for every shape and type the wrapper takes. (bf16 with
// at most 256 tokens, a head dim that is a multiple of 16 and 16-byte
// aligned rows goes to attention_bwd_resident.cu, several times faster at
// the search step's shapes (PERF.md); ops/attention.py `attention_body`
// decides.)
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_bwd_kernel`
// (launched by `_mha_bwd_pallas`, grid (B, H)). Same math, no scale inside:
//   p  = softmax(q kᵀ)               fp32
//   dv = pᵀ do                        p and do in fp32
//   dp = do vᵀ                        fp32
//   ds = p ⊙ (dp − rowsum(p ⊙ dp))    rounded to q's type
//   dq = ds k,  dk = dsᵀ q            fp32 sums, outputs in the input type
//
// Bound. 10 B H N² d flops (the recomputed q kᵀ and four products) against
// seven (B, N, H, d) tensors (q, k, v, do in; dq, dk, dv out): at DeiT-S
// shapes (N = 197, d = 64, bf16) about 140 flops a byte, under the H100's
// ~295, so device memory bounds it (B = 256: 271 MB, ~81 us at 3.35 TB/s).
//
// Design. The TPU kernel keeps one (batch, head) in VMEM and sums dk, dv
// over all query rows inside it. Hopper blocks run in no order and cannot
// carry sums between them, so the work is split by what it sums over:
//   * attention_bwd_dq_kernel: a block per 64 query rows walks the keys and
//     accumulates dq in registers;
//   * attention_bwd_dkdv_kernel: a block per 64 key rows walks the queries
//     and accumulates dk and dv in registers.
// Neither needs atomics. p is rebuilt from the forward's row log-sum-exp,
// p = exp(q kᵀ − lse), so no block needs a whole row of scores. The row
// term rowsum(p ⊙ dp) equals rowsum(do ⊙ o) (o = p v), so the dq kernel
// computes it once per row from do and the forward's o, uses it, and
// writes it to `delta` for the dk/dv kernel, launched after it on the same
// stream. Rows and keys past N get p = 0 and are never written.
//
// As in the forward, bf16 runs on the tensor cores (WMMA) and fp32 on the
// CUDA cores.
#include "attention_common.cuh"

namespace ofb {

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int N,
                        int H, int d, Strides sq, Strides sk, Strides sv,
                        Strides so, Strides sdo) {
  extern __shared__ float smem[];
  const int ld = d + 1, ldp = TILE + 1;
  float* Qs = smem;                      // 64 x ld
  float* dOs = Qs + TILE * ld;           // 64 x ld
  float* Ks = dOs + TILE * ld;           // 64 x ld
  float* Vs = Ks + TILE * ld;            // 64 x ld
  float* dSs = Vs + TILE * ld;           // 64 x ldp
  float* row_lse = dSs + TILE * ldp;
  float* row_delta = row_lse + TILE;

  const int m0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long bh = static_cast<long long>(b) * H + h;

  load_tile(Qs, ld, q, sq, b, h, m0, N, d);
  load_tile(dOs, ld, dout, sdo, b, h, m0, N, d);
  __syncthreads();
  {  // delta = rowsum(do ⊙ o), four lanes a row
    const int row = threadIdx.x / 4, part = threadIdx.x % 4;
    const int n = m0 + row;
    float acc = 0.f;
    if (n < N) {
      const T* orow = o + b * so.b + n * so.n + h * so.h;
      for (int c = part; c < d; c += 4) acc += dOs[row * ld + c] * to_f<T>(orow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      row_delta[row] = acc;
      row_lse[row] = (n < N) ? lse[bh * N + n] : 0.f;
      if (n < N) delta[bh * N + n] = acc;
    }
  }

  float acc[TR][DC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += TILE) {
    __syncthreads();
    load_tile(Ks, ld, k, sk, b, h, n0, N, d);
    load_tile(Vs, ld, v, sv, b, h, n0, N, d);
    __syncthreads();
    float s[TR][TQ], dp[TR][TQ];
    mm_abt(s, Qs, Ks, ld, d);
    mm_abt(dp, dOs, Vs, ld, d);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = ty * TR + r;
      const bool row_in = m0 + row < N;
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int col = tx + 16 * j;
        const float p = (row_in && n0 + col < N) ? expf(s[r][j] - row_lse[row]) : 0.f;
        dSs[row * ldp + col] = round_to<T>(p * (dp[r][j] - row_delta[row]));
      }
    }
    __syncthreads();
    mm_ab_acc(acc, dSs, ldp, Ks, ld, d);
  }
  store_tile(dq, acc, b, h, m0, N, H, d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int N,
                          int H, int d, Strides sq, Strides sk, Strides sv,
                          Strides sdo) {
  extern __shared__ float smem[];
  const int ld = d + 1, ldp = TILE + 1;
  float* Ks = smem;                      // 64 x ld
  float* Vs = Ks + TILE * ld;            // 64 x ld
  float* Qs = Vs + TILE * ld;            // 64 x ld
  float* dOs = Qs + TILE * ld;           // 64 x ld
  float* Ps = dOs + TILE * ld;           // 64 x ldp: p, fp32
  float* dSs = Ps + TILE * ldp;          // 64 x ldp: ds, rounded
  float* row_lse = dSs + TILE * ldp;
  float* row_delta = row_lse + TILE;

  const int n0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long bh = static_cast<long long>(b) * H + h;

  load_tile(Ks, ld, k, sk, b, h, n0, N, d);
  load_tile(Vs, ld, v, sv, b, h, n0, N, d);

  float acc_k[TR][DC], acc_v[TR][DC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      acc_k[r][j] = 0.f;
      acc_v[r][j] = 0.f;
    }

  for (int m0 = 0; m0 < N; m0 += TILE) {
    __syncthreads();
    load_tile(Qs, ld, q, sq, b, h, m0, N, d);
    load_tile(dOs, ld, dout, sdo, b, h, m0, N, d);
    if (threadIdx.x < TILE) {
      const int n = m0 + threadIdx.x;
      row_lse[threadIdx.x] = (n < N) ? lse[bh * N + n] : 0.f;
      row_delta[threadIdx.x] = (n < N) ? delta[bh * N + n] : 0.f;
    }
    __syncthreads();
    float s[TR][TQ], dp[TR][TQ];
    mm_abt(s, Qs, Ks, ld, d);            // rows: queries, columns: keys
    mm_abt(dp, dOs, Vs, ld, d);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = ty * TR + r;
      const bool row_in = m0 + row < N;
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int col = tx + 16 * j;
        const float p = (row_in && n0 + col < N) ? expf(s[r][j] - row_lse[row]) : 0.f;
        Ps[row * ldp + col] = p;
        dSs[row * ldp + col] = round_to<T>(p * (dp[r][j] - row_delta[row]));
      }
    }
    __syncthreads();
    mm_atb_acc(acc_v, Ps, ldp, dOs, ld, d);
    mm_atb_acc(acc_k, dSs, ldp, Qs, ld, d);
  }
  store_tile(dk, acc_k, b, h, n0, N, H, d);
  store_tile(dv, acc_v, b, h, n0, N, H, d);
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
  const bool vec = vec_ok(ptrs, st, 5);
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

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int d,
               const long long* st, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const dim3 grid((N + TILE - 1) / TILE, H, B);

  const size_t smem_dq =
      sizeof(float) * (4 * TILE * (d + 1) + TILE * (TILE + 1) + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<T><<<grid, THREADS, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), N, H, d, sq, sk, sv,
      so, sdo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv =
      sizeof(float) * (4 * TILE * (d + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<T><<<grid, THREADS, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), N, H, d, sq, sk, sv, sdo);
  return static_cast<int>(cudaGetLastError());
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
  if (d < 8 || d > ofb::DMAX || d % 8 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ofb::launch_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                  N, H, d, strides, s);
  if (dtype == 1)
    return ofb::launch_bwd_bf16_any(q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, B, N, H, d, strides, s);
  return -1;
}
