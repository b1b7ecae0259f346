// Shared pieces of the hand-written attention kernels (attention_fwd.cu,
// attention_bwd.cu).
//
// Layout. q, k, v, o, do are (B, N, H, d) tensors read through element
// strides (batch, token, head); the head-dim stride is 1. On the search
// step q is a fresh (B, N, H, d) tensor (the scale was folded into it) and
// k, v are strided views into the qkv buffer (B, N, 3, H, d), token stride
// 3*H*d, so the kernels read them in place with no transpose.
//
// Tiling. A block owns a 64-row tile (of queries or of keys) of one
// (batch, head) and walks the other side in 64-row tiles. Every tile is
// staged in shared memory as fp32 with a row pitch of d + 1 (odd, so the
// 16 column-threads of a half-warp hit 16 different banks). The 256
// threads form a 16 x 16 grid: thread (ty, tx) owns rows 4*ty .. 4*ty + 3
// of the 64-row tile and columns tx, tx + 16, ... of the other axis, so a
// 64 x 64 score tile is 16 registers a thread and a 64 x d output tile at
// most 32 (d <= 128). That is the fp32 path, on the CUDA cores; the bf16
// path (below) stages bf16 tiles for the tensor cores instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace ofb {

constexpr int TILE = 64;         // rows of a query tile and of a key tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int TR = 4;            // tile rows a thread owns (16 * 4 = 64)
constexpr int TQ = 4;            // score-tile columns a thread owns
constexpr int DMAX = 128;        // largest head dim taken
constexpr int DC = DMAX / 16;    // head-dim columns a thread owns, at most

struct Strides {
  long long b, n, h;             // element strides; the head-dim stride is 1
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even, as .astype does
}

// x rounded through T, as `x.astype(T)` in the TPU kernels.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Stage rows r0 .. r0 + 63 of head h, batch b into dst (fp32, pitch ld);
// rows at or past N are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          Strides s, int b, int h, int r0,
                                          int N, int d) {
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    const int n = r0 + r;
    float x = 0.f;
    if (n < N) x = to_f<T>(src[b * s.b + n * s.n + h * s.h + c]);
    dst[r * ld + c] = x;
  }
}

// acc[r][j] = sum_c A[4ty + r][c] * B[tx + 16 j][c]: a 64 x 64 tile of
// A Bᵀ, A and B both 64 x d with pitch ld.
__device__ __forceinline__ void mm_abt(float acc[TR][TQ], const float* A,
                                       const float* B, int ld, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int j = 0; j < TQ; ++j) acc[r][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[TR], bv[TQ];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = A[(ty * TR + r) * ld + c];
#pragma unroll
    for (int j = 0; j < TQ; ++j) bv[j] = B[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TQ; ++j) acc[r][j] = fmaf(a[r], bv[j], acc[r][j]);
  }
}

// acc[r][j] += sum_i P[4ty + r][i] * X[i][tx + 16 j]: P (64 x 64, pitch
// ldp) times X (64 x d, pitch ld).
__device__ __forceinline__ void mm_ab_acc(float acc[TR][DC], const float* P,
                                          int ldp, const float* X, int ld,
                                          int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int i = 0; i < TILE; ++i) {
    float p[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) p[r] = P[(ty * TR + r) * ldp + i];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        const float x = X[i * ld + c];
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r][j] = fmaf(p[r], x, acc[r][j]);
      }
    }
  }
}

// acc[r][j] += sum_i P[i][4ty + r] * X[i][tx + 16 j]: Pᵀ X, with P
// (64 x 64, pitch ldp) and X (64 x d, pitch ld).
__device__ __forceinline__ void mm_atb_acc(float acc[TR][DC], const float* P,
                                           int ldp, const float* X, int ld,
                                           int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int i = 0; i < TILE; ++i) {
    float p[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) p[r] = P[i * ldp + ty * TR + r];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        const float x = X[i * ld + c];
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r][j] = fmaf(p[r], x, acc[r][j]);
      }
    }
  }
}

// Write a 64 x d register tile (rows 4ty + r, columns tx + 16 j) to rows
// r0 .. of a contiguous (B, N, H, d) tensor.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float acc[TR][DC],
                                           int b, int h, int r0, int N, int H,
                                           int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int n = r0 + ty * TR + r;
    if (n >= N) continue;
    T* row = dst + ((static_cast<long long>(b) * N + n) * H + h) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) row[c] = from_f<T>(acc[r][j]);
    }
  }
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
// zero-padded to dp); rows at or past N are zero. With vec, every row
// starts on 16 bytes and is copied 8 elements at a time.
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

// Whether every tensor can be staged 16 bytes at a time.
inline bool vec_ok(const void* const* ptrs, const long long* st, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 8 != 0) return false;
  }
  return true;
}

inline size_t align128(size_t bytes) { return (bytes + 127) & ~size_t(127); }

}  // namespace ofb
