// Attention forward, o = softmax(q kᵀ) v, for Hopper (sm_90a): the general
// body, for every shape and type the wrapper takes.
//
// Replaces the TPU kernel ofb_tpu/ops/pallas_attention.py `_fwd_kernel`
// (launched by `_mha_fwd_pallas`, grid (B, H)). Same function: q arrives
// already scaled; scores, row max and row sums are fp32; p is rounded to
// v's type before p @ v; o keeps the input type. No mask, no dropout.
//
// Which calls come here. bf16 with at most 256 tokens and 16-byte aligned
// rows, at every head dim (the search step's and the exported subnets'
// shapes, 8 * odd head dims included), goes to the resident body in
// attention_fwd_resident.cu, several times faster there (PERF.md);
// ops/attention.py `attention_body` decides. This body keeps the rest:
// more than 256 tokens, unaligned views, fp32.
//
// Bound. At the DeiT-S search-step shapes (N = 197, H = 6, d = 64, bf16)
// the work is 4 B H N² d flops against 4 B N H d * 2 bytes of q, k, v, o:
// about 100 flops a byte, under the H100's ~295 bf16 flops a byte, so
// device memory bounds it (B = 256: 155 MB, ~46 us at 3.35 TB/s).
//
// Design. The TPU kernel holds a whole head's N x N fp32 scores in VMEM;
// at N = 197 that alone is 155 KB, and with q, k, v it no longer fits the
// 227 KB a Hopper block may use. So the block owns 64 query rows of one
// (batch, head) (grid (ceil(N/64), H, B)) and walks the keys in 64-row
// tiles with the running-max softmax: per tile, s = q kᵀ, the row max
// moves from m to m', o and the row sum are rescaled by exp(m - m'), and
// exp(s - m') (rounded to v's type) times v is added. Keys past N score
// -inf; query rows past N are computed on zeros and never written. The
// block also writes the row log-sum-exp (fp32, (B, H, N)), which the
// backward kernels use to rebuild p without a second softmax pass.
// Any N >= 1 and any d that is a multiple of 8 up to 128 work.
//
// Two bodies: bf16 (the search step's type) runs the products on the
// tensor cores with WMMA, 4 warps of 16 query rows each; fp32 runs them as
// fp32 FMA on the CUDA cores, 256 threads (the tensor cores would round
// fp32 to TF32).
#include "attention_common.cuh"

namespace ofb {

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int N, int H, int d, Strides sq,
                     Strides sk, Strides sv) {
  extern __shared__ float smem[];
  const int ld = d + 1, ldp = TILE + 1;
  float* Qs = smem;                      // 64 x ld
  float* Ks = Qs + TILE * ld;            // 64 x ld
  float* Vs = Ks + TILE * ld;            // 64 x ld
  float* Ss = Vs + TILE * ld;            // 64 x ldp: scores, then p
  float* row_m = Ss + TILE * ldp;        // running row max
  float* row_l = row_m + TILE;           // running row sum
  float* row_a = row_l + TILE;           // this tile's rescale factor

  const int m0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile(Qs, ld, q, sq, b, h, m0, N, d);
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }
  float acc[TR][DC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += TILE) {
    __syncthreads();                     // the last tile is no longer read
    load_tile(Ks, ld, k, sk, b, h, n0, N, d);
    load_tile(Vs, ld, v, sv, b, h, n0, N, d);
    __syncthreads();

    float s[TR][TQ];
    mm_abt(s, Qs, Ks, ld, d);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int col = tx + 16 * j;
        Ss[(ty * TR + r) * ldp + col] = (n0 + col < N) ? s[r][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share one row, 16 columns each
    {
      const int row = threadIdx.x / 4, part = threadIdx.x % 4;
      float* srow = Ss + row * ldp + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);   // finite: key n0 is in range
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        srow[j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();                      // every lane has read row_m[row]
      if (part == 0) {
        const float a = expf(m_old - m_new);
        row_a[row] = a;
        row_l[row] = row_l[row] * a + sum;
        row_m[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float a = row_a[ty * TR + r];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[r][j] *= a;
    }
    mm_ab_acc(acc, Ss, ldp, Vs, ld, d);
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const float inv = 1.f / row_l[ty * TR + r];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] *= inv;
  }
  store_tile(o, acc, b, h, m0, N, H, d);
  if (threadIdx.x < TILE) {
    const int n = m0 + threadIdx.x;
    if (n < N)
      lse[(static_cast<long long>(b) * H + h) * N + n] =
          row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
  }
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

int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int H, int d, const long long* st,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * TILE * (d + 1) + TILE * (TILE + 1) + 3 * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  attention_fwd_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), N, H, d, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]});
  return static_cast<int>(cudaGetLastError());
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
      vec_ok(ptrs, st, 3));
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
  if (d < 8 || d > ofb::DMAX || d % 8 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ofb::launch_fwd_f32(q, k, v, o, lse, B, N, H, d, strides, s);
  if (dtype == 1)
    return ofb::launch_fwd_bf16(q, k, v, o, lse, B, N, H, d, strides, s);
  return -1;
}
