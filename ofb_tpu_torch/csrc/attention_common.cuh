// Shared pieces of the general attention body (attention_fwd.cu,
// attention_bwd.cu): the fp32 path on the CUDA cores and the bf16 path on
// the tensor cores (WMMA).
//
// Layout. q, k, v, o, do are (B, N, H, d) tensors read through element
// strides (batch, token, head); the head-dim stride is 1. On the search
// step q is a fresh (B, N, H, d) tensor (the scale was folded into it) and
// k, v are strided views into the qkv buffer (B, N, 3, H, d), token stride
// 3*H*d, so the kernels read them in place with no transpose. Any head dim
// d in [1, 128] is taken.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "sm90.cuh"

namespace ofb {

constexpr int TILE = 64;         // rows of a streamed tile (both paths)
constexpr int DMAX = 128;        // largest head dim taken

struct Strides {
  long long b, n, h;             // element strides; the head-dim stride is 1
};

// ---------------------------------------------------------------------------
// fp32 path: FMA on the CUDA cores
//
// A block of 32 NW threads keeps BM = 4 RM NW rows of one (batch, head)
// resident in shared memory and streams the other side through 64-row
// tiles, two buffers filled by cp.async one tile ahead of the arithmetic.
// Lane l of warp w is (rg, cg) = (l / 8, l % 8). It owns the resident rows
// a0 + 4t, t < RM, with a0 = 4 RM w + rg, and of a streamed tile the rows
// cg + 8i, i < 8. So a product summed over the head dim (q kᵀ, do vᵀ) leaves
// every thread an RM x 8 register tile: per 4 head-dim columns it reads
// RM + 8 float4 and does 32 RM FMAs. The 8 lanes that share a resident row
// sit in one warp and reduce over it with __shfl_xor_sync (1, 2, 4). The
// products summed over the streamed rows (p v, ds k, pᵀ do, dsᵀ q) read the
// score tile back from shared memory by rows, as float4, and give the
// thread the output columns 32 jj + 4 cg .. + 3 (jj < DJ = ceil(d / 32)) of
// its resident rows: per 4 streamed rows RM + 4 DJ float4 for 16 RM DJ
// FMAs.
//
// What bounds these kernels on Hopper is the shared memory, not the FMA
// pipes: an SM does 128 fp32 FMAs a clock but delivers 32 words a clock
// (a broadcast word still takes a lane's slot), so a tile needs 4 FMAs a
// word to keep both busy. RM = 8 (an 8 x 8 tile, 16 floats for 64 FMAs) is
// exactly that balance; RM = 4 gives 2.67. The inner loops compile to
// FFMA with interleaved LDS.128 and little else (`cuobjdump -sass`), so no
// other instruction stream limits them.
//
// Tiles hold fp32 with a row pitch of DP = 32 DJ floats; the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8), so the 8 lanes of a quarter-warp
// reading chunk k of rows cg + 8i, and the four quarters reading chunk k of
// rows a0 + 4t, hit distinct banks. Columns d .. DP - 1 and rows at or past
// N are copied in as zeros (a copy of 0 bytes), so they add nothing to any
// sum and stale NaN bits never meet a zero. Score buffers (p, ds) have a
// pitch of W = 32 or 64 floats and keep chunk c of row r at
// c ^ (2 (r % 4)): the 32 scalar stores of a warp's register tile land in
// 32 banks, and the row-wise float4 reads are broadcasts.
// ---------------------------------------------------------------------------

// Float offset of chunk k (4 floats) of row r in a tile.
__device__ __forceinline__ int tswz(int r, int k) {
  return (k ^ (r & 7)) << 2;
}

// Float offset of chunk k of row r in a score buffer.
__device__ __forceinline__ int pswz(int r, int k) {
  return (k ^ ((r & 3) << 1)) << 2;
}

// Start the copy of rows r0 .. r0 + rows - 1 of one (batch, head) (base
// points at its row 0, stride_n elements a row) into rows 0 .. of the tile
// dst: 16 bytes at a time when vec (d % 4 == 0 and 16-byte aligned rows),
// else 4. Rows at or past N and columns at or past d become zeros.
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           long long stride_n, int r0,
                                           int rows, int N, int d, bool vec) {
  if (vec) {
    constexpr int C = DP / 4;
    for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
      const int r = idx / C, c = idx % C, n = r0 + r;
      const bool ok = n < N && 4 * c < d;
      sm90::cp_async_16(sm90::smem_u32(dst + r * DP + tswz(r, c)),
                        ok ? base + n * stride_n + 4 * c : base, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += blockDim.x) {
      const int r = idx / DP, e = idx % DP, n = r0 + r;
      const bool ok = n < N && e < d;
      sm90::cp_async_4(
          sm90::smem_u32(dst + r * DP + tswz(r, e >> 2) + (e & 3)),
          ok ? base + n * stride_n + e : base, ok ? 4 : 0);
    }
  }
}

// acc[t][i] = sum over the head dim of A[a0 + 4t][.] B[cg + 8i][.], for
// i < NI (the rest 0): A the resident tile, B a streamed one, nk4 chunks
// of 4 columns. The sum runs over the columns in order. Rows a0 + 4t have
// swizzle phase (a0 % 8) ^ 4 (t % 2) (a0 % 8 = rg < 4), rows cg + 8i phase
// cg, so a k-step needs three offsets and every address is one of them
// plus a constant.
template <int RM, int DP, int NI>
__device__ __forceinline__ void mm_nt(float (&acc)[RM][8], const float* A,
                                      int a0, const float* B, int cg,
                                      int nk4) {
#pragma unroll
  for (int t = 0; t < RM; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
  const float* Ab = A + a0 * DP;
  const float* Bb = B + cg * DP;
  const int ra = a0 & 7;
  for (int k4 = 0; k4 < nk4; ++k4) {
    const int ob = (k4 ^ cg) << 2, oa = (k4 ^ ra) << 2;
    float4 b[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      b[i] = *reinterpret_cast<const float4*>(Bb + 8 * i * DP + ob);
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(
          Ab + 4 * t * DP + ((t & 1) ? (oa ^ 16) : oa));
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        acc[t][i] = fmaf(a.x, b[i].x, acc[t][i]);
        acc[t][i] = fmaf(a.y, b[i].y, acc[t][i]);
        acc[t][i] = fmaf(a.z, b[i].z, acc[t][i]);
        acc[t][i] = fmaf(a.w, b[i].w, acc[t][i]);
      }
    }
  }
}

// mm_nt for the ni = ceil(valid rows / 8) steps of a streamed tile that
// hold rows below N: the last tile computes only those.
template <int RM, int DP>
__device__ __forceinline__ void mm_nt_rows(float (&acc)[RM][8],
                                           const float* A, int a0,
                                           const float* B, int cg, int nk4,
                                           int ni) {
  switch (ni) {
    case 1: mm_nt<RM, DP, 1>(acc, A, a0, B, cg, nk4); break;
    case 2: mm_nt<RM, DP, 2>(acc, A, a0, B, cg, nk4); break;
    case 3: mm_nt<RM, DP, 3>(acc, A, a0, B, cg, nk4); break;
    case 4: mm_nt<RM, DP, 4>(acc, A, a0, B, cg, nk4); break;
    case 5: mm_nt<RM, DP, 5>(acc, A, a0, B, cg, nk4); break;
    case 6: mm_nt<RM, DP, 6>(acc, A, a0, B, cg, nk4); break;
    case 7: mm_nt<RM, DP, 7>(acc, A, a0, B, cg, nk4); break;
    default: mm_nt<RM, DP, 8>(acc, A, a0, B, cg, nk4);
  }
}

// acc[t][4 jj + e] += sum_c P[a0 + 4t][c] X[c][32 jj + 4 cg + e] over
// c < 4 nm: P a score buffer (pitch W), X a tile (pitch 32 DJ), in order
// of c. Rows a0 + 4t of P share the phase 2 (a0 % 4); row 4m + u of X has
// phase 4 (m % 2) + u, so its chunk cg + 8 jj sits at
// ((cg ^ u) ^ 4 (m % 2)) + 8 jj.
template <int RM, int DJ, int W>
__device__ __forceinline__ void mm_pv(float (&acc)[RM][4 * DJ],
                                      const float* P, int a0, const float* X,
                                      int cg, int nm) {
  constexpr int DP = 32 * DJ;
  const float* Pb = P + a0 * W;
  const int pr = (a0 & 3) << 1;
  int xo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) xo[u] = (cg ^ u) << 2;
  for (int m = 0; m < nm; ++m) {
    const int po = (m ^ pr) << 2, flip = (m & 1) << 4;
    float4 p[RM];
#pragma unroll
    for (int t = 0; t < RM; ++t)
      p[t] = *reinterpret_cast<const float4*>(Pb + 4 * t * W + po);
    const float* Xm = X + 4 * m * DP;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* Xu = Xm + u * DP + (xo[u] ^ flip);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float4 x = *reinterpret_cast<const float4*>(Xu + 32 * jj);
#pragma unroll
        for (int t = 0; t < RM; ++t) {
          const float pc = u == 0 ? p[t].x : u == 1 ? p[t].y
                         : u == 2 ? p[t].z : p[t].w;
          acc[t][4 * jj + 0] = fmaf(pc, x.x, acc[t][4 * jj + 0]);
          acc[t][4 * jj + 1] = fmaf(pc, x.y, acc[t][4 * jj + 1]);
          acc[t][4 * jj + 2] = fmaf(pc, x.z, acc[t][4 * jj + 2]);
          acc[t][4 * jj + 3] = fmaf(pc, x.w, acc[t][4 * jj + 3]);
        }
      }
    }
  }
}

// e^x as 2^(x log2 e): the exponent the kernels take, x = s - (row max or
// log-sum-exp) computed first, so the product adds one rounding of x.
__device__ __forceinline__ float exp_f32(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Float offset of the lane's score (row a0 + 4t, column c) in a buffer of
// pitch W.
template <int W>
__device__ __forceinline__ int pidx(int r, int c) {
  return r * W + pswz(r, c >> 2) + (c & 3);
}

// Write rows r0 + a0 + 4t (those below N) of the register tile acc (columns
// 32 jj + 4 cg + e), each times scale[t], to a contiguous (B, N, H, d)
// fp32 tensor: float4 stores when d % 4 == 0.
template <int RM, int DJ>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               const float (&acc)[RM][4 * DJ],
                                               const float (&scale)[RM],
                                               int b, int h, int r0, int a0,
                                               int cg, int N, int H, int d) {
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    const int n = r0 + a0 + 4 * t;
    if (n >= N) continue;
    float* row = dst + ((static_cast<long long>(b) * N + n) * H + h) * d;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = 32 * jj + 4 * cg;
      const float4 x = make_float4(
          acc[t][4 * jj] * scale[t], acc[t][4 * jj + 1] * scale[t],
          acc[t][4 * jj + 2] * scale[t], acc[t][4 * jj + 3] * scale[t]);
      if ((d & 3) == 0) {
        if (c < d) *reinterpret_cast<float4*>(row + c) = x;
      } else {
        if (c < d) row[c] = x.x;
        if (c + 1 < d) row[c + 1] = x.y;
        if (c + 2 < d) row[c + 2] = x.z;
        if (c + 3 < d) row[c + 3] = x.w;
      }
    }
  }
}

// Shared memory (bytes) of the fp32 kernels at DP columns and BM resident
// rows: the forward (q resident; k and v double-buffered; p of half a key
// tile), the dq kernel (q, do resident; k, v double-buffered; the
// 64-column ds tile) and the dk/dv kernel (k, v resident; q, do
// double-buffered with their lse and delta; the 64-column p / ds tile).
// ops/attention.py repeats this.
inline size_t f32_smem_fwd(int dp, int bm) {
  return sizeof(float) * (bm * dp + 4 * TILE * dp + bm * 32);
}
inline size_t f32_smem_dq(int dp, int bm) {
  return sizeof(float) * (2 * bm * dp + 4 * TILE * dp + bm * TILE);
}
inline size_t f32_smem_dkdv(int dp, int bm) {
  return f32_smem_dq(dp, bm) + sizeof(float) * 4 * TILE;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path (WMMA 16 x 16 x 16, fp32 sums)
//
// Four warps a block; warp w owns rows 16w .. 16w + 15 of the block's
// 64-row tile, so between the block-wide tile loads a warp touches only its
// own rows and needs no more than __syncwarp. Tiles are staged in shared
// memory as bf16 with the head dim padded with zeros to dp (a multiple of
// 16) and a row pitch of dp + 8; scores and the other fp32 tiles have a
// pitch of 64 + 4. Every array starts on a 128-byte boundary, and fragment
// pointers land on 32-byte ones, as WMMA requires.
// ---------------------------------------------------------------------------

constexpr int WTHREADS = 128;    // 4 warps x 16 rows = 64
constexpr int LDS = TILE + 4;    // fp32 pitch of a 64-column tile
constexpr int LDP = TILE + 8;    // bf16 pitch of a 64-column tile

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) & ~15; }

// Stage rows r0 .. r0 + 63 of head h, batch b as bf16 (pitch ldb, head dim
// zero-padded to dp); rows at or past N are zero. With vec (vec_ok: d and
// the strides multiples of 8), every row starts on 16 bytes and is copied 8
// elements at a time; otherwise element by element.
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int ldb,
                                               const bf16* src, Strides s,
                                               int b, int h, int r0, int N,
                                               int d, int dp, bool vec) {
  if (vec) {
    const int c8 = dp / 8;
    for (int idx = threadIdx.x; idx < TILE * c8; idx += blockDim.x) {
      const int r = idx / c8, c = (idx - r * c8) * 8;
      const int n = r0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && c < d)
        x = *reinterpret_cast<const uint4*>(src + b * s.b + n * s.n +
                                            h * s.h + c);
      *reinterpret_cast<uint4*>(dst + r * ldb + c) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < TILE * dp; idx += blockDim.x) {
      const int r = idx / dp, c = idx - r * dp;
      const int n = r0 + r;
      bf16 x = __float2bfloat16(0.f);
      if (n < N && c < d) x = src[b * s.b + n * s.n + h * s.h + c];
      dst[r * ldb + c] = x;
    }
  }
}

// Write the warp's 16 rows of an fp32 staging tile (pitch ld) to rows
// r0 + 16w .. of a contiguous (B, N, H, d) bf16 tensor, times row_scale
// (or 1 when null).
__device__ __forceinline__ void store_rows_bf16(bf16* dst, const float* src,
                                                int ld, const float* row_scale,
                                                int b, int h, int r0, int N,
                                                int H, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int idx = lane; idx < 16 * d; idx += 32) {
    const int r = 16 * warp + idx / d, c = idx % d;
    const int n = r0 + r;
    if (n >= N) continue;
    const float x = src[r * ld + c] * (row_scale ? row_scale[r] : 1.f);
    dst[((static_cast<long long>(b) * N + n) * H + h) * d + c] =
        __float2bfloat16(x);
  }
}

// Whether every tensor can be staged 16 bytes at a time: the head dim and
// every stride a multiple of `per16` elements (8 bf16 or 4 fp32) and every
// pointer on 16 bytes. Otherwise a row may start inside a 16-byte chunk, or
// its last chunk reach past d.
inline bool vec_ok(const void* const* ptrs, const long long* st, int n, int d,
                   int per16) {
  if (d % per16 != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % per16 != 0) return false;
  }
  return true;
}

inline size_t align128(size_t bytes) { return (bytes + 127) & ~size_t(127); }

}  // namespace ofb
