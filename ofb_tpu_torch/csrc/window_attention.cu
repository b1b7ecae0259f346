// Swin's window attention, forward and backward (ops/window_attention.py).
//
// No TPU kernel is replaced: the JAX package computes window attention as
// plain jnp ops (ofb_tpu/models/swin.py `_window_attention`), which XLA
// fuses on the TPU. Written eagerly in PyTorch the same chain (q kᵀ, the
// scale, the gathered relative bias, the shift mask, an fp32 softmax, the
// cast, p v, and autograd's backward of each) writes and reads a full
// (windows, heads, N, N) score tensor at every step, fp32 and bf16 copies
// of it are kept for the backward, and it runs at a few percent of what
// the card allows. These kernels keep the scores in registers.
//
// What bounds them is the bytes: a (window, head) pair does 4 N² d FLOPs
// over 8 N d bytes of q, k, v and o (forward; about 24 FLOPs a byte at
// N 49, d 32, against the card's 295), so the only gain is to move fewer
// bytes. The forward reads q, k and v once and writes o and the row
// log-sum-exp once; the backward reads q, k, v, o, do and the log-sum-exp
// once and writes dq, dk and dv once, straight into the gradient of the
// packed qkv rows. The relative bias (gathered from its (T, H) table
// through the index) and the shift mask of a block's window position are
// read once a block, from L2, into registers.
//
// Design. A block of 4 warps walks the pairs of one head h and one window
// position w (the windows b nW + w of images b0 .. b1 - 1): the grid is
// (heads x positions x chunks of images), the chunks sized to whole waves of
// resident blocks, so the bias plus mask of its (h, w) stays in registers
// across all its pairs, and so does the backward's running sum of dS (the
// bias gradient: a (N, N) partial a block, summed over blocks by a second
// kernel in a fixed order and gathered into the table by a third; no atomics,
// the same inputs give the same bits). The tiles of a pair (64 rows, N <= 64
// of them live, rows at or past N and columns at or past d zero) are in
// shared memory with a row pitch of d' + 8 (d' = d rounded up to 16: ldmatrix
// and the 32-bit fragment reads hit 32 distinct banks); the next pair's tiles
// are on their way by cp.async (16, 8 or 4 bytes a copy, as the rows'
// alignment allows; 2-byte rows a plain copy) while the block works on this
// one. Warp m owns query rows 16 m .. 16 m + 15: bf16 products by mma.sync
// m16n8k16 with fp32 sums, S = q kᵀ in registers (16 x 64), the scale, bias
// and mask added there, the softmax over the whole row in registers (one
// 64-wide tile holds a row, so no online rescaling), P cast to bf16 and kept
// in registers as the A operand of P v. The backward recomputes S and P from
// the log-sum-exp, forms delta = rowsum(do o), dP = do vᵀ and dS = P (dP -
// delta) in registers, and writes P and scale dS (bf16) to shared memory
// once, where every warp reads them transposed (ldmatrix .trans) for dV = Pᵀ
// do and dK = scale dSᵀ q over all 64 query rows; dQ = scale dS k takes dS
// from registers. Results go through a warp's own rows of shared memory to
// coalesced stores (in the backward, dq through the o rows and dk, dv through
// the k, v rows after a barrier: no staging tiles, so three blocks fit an
// SM).
//
// fp32 inputs take an FMA body with the same work split and partials: the
// scores in shared memory (fp32 throughout, P not rounded), a block's
// threads over the (i, j) and (i, c) elements.
//
// Every entry launches on the stream it is given, never synchronises and
// allocates nothing; it returns -1 for a call it does not serve and else
// cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ofb_win {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;                 // warps a block; warp m: rows 16 m ..
constexpr int THREADS = 32 * WARPS;
constexpr int NP = 64;                   // rows of a tile: N <= 64
constexpr int NN_MAX = NP * NP;
constexpr int PSP = NP + 8;              // pitch of the P and dS tiles
constexpr int FP = NP + 1;               // pitch of the fp32 tiles (floats)
constexpr int SUM_THREADS = 256;
constexpr int TABLE_THREADS = 128;
// a block's set-up (zeroed tiles, the bias in registers, the first pair's
// load, its partial) in pairs' time, for the choice of chunks
constexpr int SETUP_PAIRS = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The pairs of block `cta`: head h, window position w, images b0 .. b1 - 1
// (windows b nW + w); blocks are (h, w, chunk) in that order.
struct Work {
  int H, nW, B, chunks, per;
  __device__ void of(int cta, int& h, int& w, int& b0, int& b1) const {
    const int c = cta % chunks, g = cta / chunks;
    h = g / nW;
    w = g % nW;
    b0 = c * per;
    b1 = min(B, b0 + per);
  }
};

// What a call reads and writes. qkv and dqkv: (Bw, N, 3 H d), q at column
// h d, k at H d + h d, v at 2 H d + h d; out and dout: (Bw, N, H d); lse:
// (Bw, H, N) fp32; table: (T, H) fp32; idx: (N N) int64 into the table;
// mask: (nW, N, N) fp32 or null; scale: *scale_ptr when not null.
struct Args {
  const void* qkv;
  const void* out;
  const void* dout;
  void* o;                     // the forward's out, the backward's dqkv
  float* lse;
  const float* table;
  const long long* idx;
  const float* mask;
  const float* scale_ptr;
  float* partial;                        // (blocks, N N) fp32
  float scale;
  int N, H, d, in_vec, out_vec;
  Work work;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of `rows` rows of `width` elements, row r from
// src + r stride to dst + r pitch (shared memory), in chunks of vec bytes:
// 16, 8, 4 by cp.async, 2 (bf16 rows on 2 bytes) by a plain copy. The
// threads tid, tid + n, .. share the chunks.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, const T* src,
                                          long long stride, int rows,
                                          int width, int vec, int tid,
                                          int n) {
  const int per_row = width * static_cast<int>(sizeof(T)) / vec;
  const int elems = vec / static_cast<int>(sizeof(T));
  for (int e = tid; e < rows * per_row; e += n) {
    const int r = e / per_row, c = (e - r * per_row) * elems;
    T* dp = dst + r * pitch + c;
    const T* sp = src + r * stride + c;
    switch (vec) {
      case 16: cp_async<16>(dp, sp); break;
      case 8: cp_async<8>(dp, sp); break;
      case 4: cp_async<4>(dp, sp); break;
      default: *dp = *sp;
    }
  }
}

// Stores `rows` rows of `width` elements from shared memory (row r at
// src + r pitch) to dst + r stride, vec bytes at a time.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long stride,
                                           const T* src, int pitch, int rows,
                                           int width, int vec, int tid,
                                           int n) {
  const int per_row = width * static_cast<int>(sizeof(T)) / vec;
  const int elems = vec / static_cast<int>(sizeof(T));
  for (int e = tid; e < rows * per_row; e += n) {
    const int r = e / per_row, c = (e - r * per_row) * elems;
    T* dp = dst + r * stride + c;
    const T* sp = src + r * pitch + c;
    switch (vec) {
      case 16:
        *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(sp);
        break;
      case 8:
        *reinterpret_cast<uint2*>(dp) = *reinterpret_cast<const uint2*>(sp);
        break;
      case 4:
        *reinterpret_cast<uint32_t*>(dp) =
            *reinterpret_cast<const uint32_t*>(sp);
        break;
      default: *dp = *sp;
    }
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory from p.
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The bias plus mask of (query i, key j) of head h at window position w:
// -inf for keys at or past N (they take no weight), 0 for query rows at or
// past N (their results are never written).
__device__ __forceinline__ float bias_mask(const Args& a, int h, int w, int i,
                                           int j) {
  if (j >= a.N) return -INFINITY;
  if (i >= a.N) return 0.f;
  const int ij = i * a.N + j;
  float v = a.table[a.idx[ij] * a.H + h];
  if (a.mask) v += a.mask[static_cast<long long>(w) * a.N * a.N + ij];
  return v;
}

__device__ __forceinline__ float scale_of(const Args& a) {
  return a.scale_ptr ? *a.scale_ptr : a.scale;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 with fp32 sums
//
// Lane l of a warp is (g, t) = (l / 4, l % 4). An m16n8 result tile c[4]
// holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns 2 t, 2 t + 1;
// a 16 x 64 score tile is s[8][4], its n-tile nt the columns 8 nt ... A
// 16 x 16 A operand a[4] holds rows g / g + 8 and columns 2 t, 2 t + 1 /
// 2 t + 8, 2 t + 9 (a[0] (g, lo), a[1] (g + 8, lo), a[2] (g, hi), a[3]
// (g + 8, hi)); so the score tile's n-tiles 2 k and 2 k + 1 are, packed to
// bf16 pairs, the A operand of keys 16 k .. 16 k + 15.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s (16 x 64) = rows a[0 .. 15] (DP deep, pitch DP + 8) times the 64 rows
// of tile b, transposed.
template <int DP>
__device__ __forceinline__ void rows_by_rows_t(float (&s)[8][4], const bf16* a,
                                               const bf16* b, int lane) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (lane & 15) * P + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                      ks * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * np], fa, fb[0], fb[1]);
      mma(s[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// o (16 x DP) = the A operands pa (16 x 64, keys 16 k .. in pa[k]) times
// the 64 rows of tile b (DP wide, pitch DP + 8).
template <int DP>
__device__ __forceinline__ void regs_by_rows(float (&o)[DP / 8][4],
                                             const uint32_t (&pa)[4][4],
                                             const bf16* b, int lane) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_t(fb, b + (ks * 16 + (lane & 15)) * P + dp * 16 +
                        (lane >> 4) * 8);
      mma(o[2 * dp], pa[ks], fb[0], fb[1]);
      mma(o[2 * dp + 1], pa[ks], fb[2], fb[3]);
    }
}

// o (16 x DP) = columns 16 m .. 16 m + 15 of the 64 x 64 tile a (pitch
// PSP), transposed, times the 64 rows of tile b: a sum over all 64 rows.
template <int DP>
__device__ __forceinline__ void cols_t_by_rows(float (&o)[DP / 8][4],
                                               const bf16* a, const bf16* b,
                                               int m, int lane) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t fa[4];
    ldsm_x4_t(fa, a + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * PSP +
                      m * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_t(fb, b + (ks * 16 + (lane & 15)) * P + dp * 16 +
                        (lane >> 4) * 8);
      mma(o[2 * dp], fa, fb[0], fb[1]);
      mma(o[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes a 16 x DP result tile (rows 16 m ..) as bf16 into the rows of
// dst (pitch DP + 8) that lie before N, columns before d.
template <int DP>
__device__ __forceinline__ void put_rows(bf16* dst, const float (&o)[DP / 8][4],
                                         int m, int N, int d, int lane) {
  constexpr int P = DP + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m * 16 + g + 8 * half;
    if (r >= N) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      bf16* p = dst + r * P + c;
      if (c + 1 < d) {
        *reinterpret_cast<uint32_t*>(p) =
            pack(o[nt][2 * half], o[nt][2 * half + 1]);
      } else if (c < d) {
        *p = __float2bfloat16_rn(o[nt][2 * half]);
      }
    }
  }
}

// The lane's bias plus mask, in the score tile's layout.
__device__ __forceinline__ void load_bias(float (&bm)[8][4], const Args& a,
                                          int h, int w, int m, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bm[nt][e] = bias_mask(a, h, w, m * 16 + g + 8 * (e >> 1),
                            nt * 8 + 2 * t + (e & 1));
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 3) window_attn_fwd(const Args a) {
  constexpr int P = DP + 8, TILE = NP * P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);   // [2 stages][q, k, v]
  const int tid = threadIdx.x, lane = tid & 31, m = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int h, w, b0, b1;
  a.work.of(blockIdx.x, h, w, b0, b1);
  const int N = a.N, d = a.d, HD = a.H * d;
  const long long rs = 3LL * HD;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  bf16* out = static_cast<bf16*>(a.o);
  const float sc = scale_of(a);

  zero_smem(tiles, 2 * 3 * TILE * 2);
  float bm[8][4];
  load_bias(bm, a, h, w, m, lane);
  __syncthreads();

  const int pairs = b1 - b0;
  auto load = [&](int n, int st) {
    const long long bw = static_cast<long long>(b0 + n) * a.work.nW + w;
    const bf16* src = qkv + bw * N * rs + h * d;
    bf16* dst = tiles + st * 3 * TILE;
#pragma unroll
    for (int part = 0; part < 3; ++part)
      copy_rows(dst + part * TILE, P, src + part * HD, rs, N, d, a.in_vec,
                tid, THREADS);
    cp_commit();
  };
  if (pairs > 0) load(0, 0);
  for (int n = 0; n < pairs; ++n) {
    const int st = n & 1;
    cp_wait_all();
    __syncthreads();
    if (n + 1 < pairs) load(n + 1, st ^ 1);
    bf16* Q = tiles + st * 3 * TILE;
    const bf16* K = Q + TILE;
    const bf16* V = K + TILE;
    const long long bw = static_cast<long long>(b0 + n) * a.work.nW + w;

    float s[8][4];
    rows_by_rows_t<DP>(s, Q + m * 16 * P, K, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = (s[nt][e] * sc + bm[nt][e]) * LOG2E;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m * 16 + g + 8 * r;
        if (row < N)
          a.lse[(bw * a.H + h) * N + row] = (mx[r] + log2f(sum[r])) / LOG2E;
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pa[k][0] = pack(s[2 * k][0] * inv[0], s[2 * k][1] * inv[0]);
      pa[k][1] = pack(s[2 * k][2] * inv[1], s[2 * k][3] * inv[1]);
      pa[k][2] = pack(s[2 * k + 1][0] * inv[0], s[2 * k + 1][1] * inv[0]);
      pa[k][3] = pack(s[2 * k + 1][2] * inv[1], s[2 * k + 1][3] * inv[1]);
    }
    float o[DP / 8][4];
    regs_by_rows<DP>(o, pa, V, lane);
    // the warp's own q rows take its o rows, then go out coalesced
    __syncwarp();
    put_rows<DP>(Q, o, m, N, d, lane);
    __syncwarp();
    const int rows = min(16, N - m * 16);
    if (rows > 0)
      store_rows(out + (bw * N + m * 16) * HD + h * d, HD, Q + m * 16 * P, P,
                 rows, d, a.out_vec, lane, 32);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 3) window_attn_bwd(const Args a) {
  constexpr int P = DP + 8, TILE = NP * P;
  extern __shared__ __align__(16) unsigned char smem[];
  // [2 stages][q, k, v, o, do], P, scale dS, [2 stages] lse
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* ps = tiles + 2 * 5 * TILE;
  bf16* dss = ps + NP * PSP;
  float* lses = reinterpret_cast<float*>(dss + NP * PSP);
  const int tid = threadIdx.x, lane = tid & 31, m = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int h, w, b0, b1;
  a.work.of(blockIdx.x, h, w, b0, b1);
  const int N = a.N, d = a.d, HD = a.H * d;
  const long long rs = 3LL * HD;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* out = static_cast<const bf16*>(a.out);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  bf16* dqkv = static_cast<bf16*>(a.o);
  const float sc = scale_of(a);

  zero_smem(smem, (2 * 5 * TILE + 2 * NP * PSP) * 2 + 2 * NP * 4);
  float bm[8][4], acc[8][4];
  load_bias(bm, a, h, w, m, lane);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  __syncthreads();

  const int pairs = b1 - b0;
  auto load = [&](int n, int st) {
    const long long bw = static_cast<long long>(b0 + n) * a.work.nW + w;
    const bf16* src = qkv + bw * N * rs + h * d;
    bf16* dst = tiles + st * 5 * TILE;
#pragma unroll
    for (int part = 0; part < 3; ++part)
      copy_rows(dst + part * TILE, P, src + part * HD, rs, N, d, a.in_vec,
                tid, THREADS);
    const long long off = bw * N * HD + h * d;
    copy_rows(dst + 3 * TILE, P, out + off, HD, N, d, a.out_vec, tid,
              THREADS);
    copy_rows(dst + 4 * TILE, P, dout + off, HD, N, d, a.out_vec, tid,
              THREADS);
    if (tid < N)
      cp_async<4>(lses + st * NP + tid, a.lse + (bw * a.H + h) * N + tid);
    cp_commit();
  };
  if (pairs > 0) load(0, 0);
  for (int n = 0; n < pairs; ++n) {
    const int st = n & 1;
    cp_wait_all();
    __syncthreads();
    if (n + 1 < pairs) load(n + 1, st ^ 1);
    bf16* Q = tiles + st * 5 * TILE;
    bf16* K = Q + TILE;
    bf16* V = K + TILE;
    bf16* O = V + TILE;
    const bf16* dO = O + TILE;
    const float* L = lses + st * NP;
    const long long bw = static_cast<long long>(b0 + n) * a.work.nW + w;
    const int r0 = m * 16 + g, r1 = r0 + 8;

    // delta = rowsum(do o) of rows r0, r1 over the quad's columns
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 2 * t; c < DP; c += 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
        const float2 ov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(O + row * P + c));
        const float2 dv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dO + row * P + c));
        delta[r] += ov.x * dv.x + ov.y * dv.y;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    const float lse2[2] = {L[r0] * LOG2E, L[r1] * LOG2E};
    const bool live[2] = {r0 < N, r1 < N};

    // P from the recomputed scores
    float p[8][4];
    rows_by_rows_t<DP>(p, Q + m * 16 * P, K, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = live[e >> 1]
                       ? exp2f((p[nt][e] * sc + bm[nt][e]) * LOG2E -
                               lse2[e >> 1])
                       : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + r0 * PSP + c) =
          pack(p[nt][0], p[nt][1]);
      *reinterpret_cast<uint32_t*>(ps + r1 * PSP + c) =
          pack(p[nt][2], p[nt][3]);
    }

    // dS = P (do vᵀ - delta): its sum for the bias, scale dS for q and k
    float ds[8][4];
    rows_by_rows_t<DP>(ds, dO + m * 16 * P, V, lane);
    uint32_t da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = p[nt][e] * (ds[nt][e] - delta[e >> 1]);
        acc[nt][e] += ds[nt][e];
        ds[nt][e] *= sc;
      }
      const int c = nt * 8 + 2 * t;
      const uint32_t lo = pack(ds[nt][0], ds[nt][1]);
      const uint32_t hi = pack(ds[nt][2], ds[nt][3]);
      *reinterpret_cast<uint32_t*>(dss + r0 * PSP + c) = lo;
      *reinterpret_cast<uint32_t*>(dss + r1 * PSP + c) = hi;
      da[nt >> 1][(nt & 1) * 2] = lo;
      da[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
    __syncthreads();

    // dq rows 16 m .. into the warp's own o rows (only it read them);
    // dk and dv rows 16 m .. into its own k and v rows once every warp
    // has read k and v
    float dq[DP / 8][4], dk[DP / 8][4], dv[DP / 8][4];
    regs_by_rows<DP>(dq, da, K, lane);
    put_rows<DP>(O, dq, m, N, d, lane);
    cols_t_by_rows<DP>(dk, dss, Q, m, lane);
    cols_t_by_rows<DP>(dv, ps, dO, m, lane);
    __syncthreads();
    put_rows<DP>(K, dk, m, N, d, lane);
    put_rows<DP>(V, dv, m, N, d, lane);
    __syncwarp();
    const int rows = min(16, N - m * 16);
    if (rows > 0) {
      bf16* dst = dqkv + (bw * N + m * 16) * rs + h * d;
      const bf16* from[3] = {O, K, V};
#pragma unroll
      for (int part = 0; part < 3; ++part)
        store_rows(dst + part * HD, rs, from[part] + m * 16 * P, P, rows, d,
                   a.in_vec, lane, 32);
    }
  }

  // the block's sum of dS, one (N, N) partial a block
  float* part = a.partial + static_cast<long long>(blockIdx.x) * N * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m * 16 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
      if (i < N && j < N) part[i * N + j] = acc[nt][e];
    }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores, scores in shared memory
// ---------------------------------------------------------------------------

// Loads rows < N, columns < d of one tile (fp32, pitch FP) from src (row
// stride `stride`); the caller syncs.
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int N, int d) {
  for (int e = threadIdx.x; e < N * d; e += THREADS) {
    const int i = e / d, c = e - i * d;
    dst[i * FP + c] = src[i * stride + c];
  }
}

// The bias plus mask of (h, w) into bms (N x N, pitch FP); the caller syncs.
__device__ __forceinline__ void load_bias_f32(float* bms, const Args& a, int h,
                                              int w) {
  for (int e = threadIdx.x; e < a.N * a.N; e += THREADS) {
    const int i = e / a.N, j = e - i * a.N;
    bms[i * FP + j] = bias_mask(a, h, w, i, j);
  }
}

__device__ __forceinline__ float dot_rows(const float* x, const float* y,
                                          int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(x[c], y[c], s);
  return s;
}

__global__ void __launch_bounds__(THREADS) window_attn_fwd_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  float* k = q + NP * FP;
  float* v = k + NP * FP;
  float* s = v + NP * FP;
  float* bms = s + NP * FP;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  int h, w, b0, b1;
  a.work.of(blockIdx.x, h, w, b0, b1);
  const int N = a.N, d = a.d, HD = a.H * d;
  const long long rs = 3LL * HD;
  const float* qkv = static_cast<const float*>(a.qkv);
  float* out = static_cast<float*>(a.o);
  const float sc = scale_of(a);
  load_bias_f32(bms, a, h, w);
  for (int b = b0; b < b1; ++b) {
    const long long bw = static_cast<long long>(b) * a.work.nW + w;
    const float* src = qkv + bw * N * rs + h * d;
    __syncthreads();
    load_f32(q, src, rs, N, d);
    load_f32(k, src + HD, rs, N, d);
    load_f32(v, src + 2 * HD, rs, N, d);
    __syncthreads();
    for (int e = tid; e < N * N; e += THREADS) {
      const int i = e / N, j = e - i * N;
      s[i * FP + j] =
          dot_rows(q + i * FP, k + j * FP, d) * sc + bms[i * FP + j];
    }
    __syncthreads();
    for (int i = wp; i < N; i += WARPS) {
      float x0 = lane < N ? s[i * FP + lane] : -INFINITY;
      float x1 = lane + 32 < N ? s[i * FP + lane + 32] : -INFINITY;
      const float mx = warp_max(fmaxf(x0, x1));
      x0 = expf(x0 - mx);
      x1 = expf(x1 - mx);
      const float l = warp_sum(x0 + x1);
      if (lane < N) s[i * FP + lane] = x0 / l;
      if (lane + 32 < N) s[i * FP + lane + 32] = x1 / l;
      if (lane == 0) a.lse[(bw * a.H + h) * N + i] = mx + logf(l);
    }
    __syncthreads();
    for (int e = tid; e < N * d; e += THREADS) {
      const int i = e / d, c = e - i * d;
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(s[i * FP + j], v[j * FP + c], o);
      out[(bw * N + i) * HD + h * d + c] = o;
    }
  }
}

__global__ void __launch_bounds__(THREADS) window_attn_bwd_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  float* k = q + NP * FP;
  float* v = k + NP * FP;
  float* dO = v + NP * FP;
  float* p = dO + NP * FP;
  float* ds = p + NP * FP;                 // o first, for delta
  float* bms = ds + NP * FP;
  float* lse = bms + NP * FP;
  float* delta = lse + NP;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  int h, w, b0, b1;
  a.work.of(blockIdx.x, h, w, b0, b1);
  const int N = a.N, NN = N * N, d = a.d, HD = a.H * d;
  const long long rs = 3LL * HD;
  const float* qkv = static_cast<const float*>(a.qkv);
  const float* out = static_cast<const float*>(a.out);
  const float* dout = static_cast<const float*>(a.dout);
  float* dqkv = static_cast<float*>(a.o);
  const float sc = scale_of(a);
  load_bias_f32(bms, a, h, w);
  float acc[NN_MAX / THREADS];
#pragma unroll
  for (int u = 0; u < NN_MAX / THREADS; ++u) acc[u] = 0.f;
  for (int b = b0; b < b1; ++b) {
    const long long bw = static_cast<long long>(b) * a.work.nW + w;
    const float* src = qkv + bw * N * rs + h * d;
    const long long off = bw * N * HD + h * d;
    __syncthreads();
    load_f32(q, src, rs, N, d);
    load_f32(k, src + HD, rs, N, d);
    load_f32(v, src + 2 * HD, rs, N, d);
    load_f32(dO, dout + off, HD, N, d);
    load_f32(ds, out + off, HD, N, d);
    if (tid < N) lse[tid] = a.lse[(bw * a.H + h) * N + tid];
    __syncthreads();
    for (int i = wp; i < N; i += WARPS) {
      float x = 0.f;
      for (int c = lane; c < d; c += 32)
        x = fmaf(dO[i * FP + c], ds[i * FP + c], x);
      x = warp_sum(x);
      if (lane == 0) delta[i] = x;
    }
    for (int e = tid; e < NN; e += THREADS) {
      const int i = e / N, j = e - i * N;
      p[i * FP + j] = expf(dot_rows(q + i * FP, k + j * FP, d) * sc +
                           bms[i * FP + j] - lse[i]);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NN_MAX / THREADS; ++u) {
      const int e = tid + u * THREADS;
      if (e < NN) {
        const int i = e / N, j = e - i * N;
        const float x = p[i * FP + j] *
                        (dot_rows(dO + i * FP, v + j * FP, d) - delta[i]);
        acc[u] += x;
        ds[i * FP + j] = x;
      }
    }
    __syncthreads();
    for (int e = tid; e < N * d; e += THREADS) {
      const int i = e / d, c = e - i * d;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < N; ++j) {
        dq = fmaf(ds[i * FP + j], k[j * FP + c], dq);
        dk = fmaf(ds[j * FP + i], q[j * FP + c], dk);
        dv = fmaf(p[j * FP + i], dO[j * FP + c], dv);
      }
      float* row = dqkv + (bw * N + i) * rs + h * d + c;
      row[0] = dq * sc;
      row[HD] = dk * sc;
      row[2 * HD] = dv;
    }
  }
  float* part = a.partial + static_cast<long long>(blockIdx.x) * NN;
#pragma unroll
  for (int u = 0; u < NN_MAX / THREADS; ++u) {
    const int e = tid + u * THREADS;
    if (e < NN) part[e] = acc[u];
  }
}

// ---------------------------------------------------------------------------
// the bias gradient: partials summed in a fixed order, then gathered
// ---------------------------------------------------------------------------

// dB[h][ij] = the sum over the `per_head` partials of head h, in order.
__global__ void __launch_bounds__(SUM_THREADS) window_attn_bias_sum(
    const float* partial, float* dB, int NN, int per_head) {
  const int h = blockIdx.y, ij = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (ij >= NN) return;
  const float* p = partial + static_cast<long long>(h) * per_head * NN + ij;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < per_head; ++k) s += p[static_cast<long long>(k) * NN];
  dB[h * NN + ij] = s;
}

// dtable[tb][h] = the sum of dB[h][ij] over the ij with idx[ij] == tb, in
// the order of ij: a block a table row; the block lists its ij (in order,
// by ballots) and a thread a head sums them.
__global__ void __launch_bounds__(TABLE_THREADS) window_attn_bias_table(
    const float* dB, const long long* idx, float* dtable, int NN, int H) {
  __shared__ int list[NN_MAX];
  __shared__ int hits[TABLE_THREADS / 32];
  const int tb = blockIdx.x, lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  int count = 0;
  for (int base = 0; base < NN; base += TABLE_THREADS) {
    const int ij = base + threadIdx.x;
    const bool hit = ij < NN && idx[ij] == tb;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) hits[wp] = __popc(ballot);
    __syncthreads();
    int off = count, round = 0;
    for (int u = 0; u < TABLE_THREADS / 32; ++u) {
      if (u < wp) off += hits[u];
      round += hits[u];
    }
    if (hit) list[off + __popc(ballot & ((1u << lane) - 1u))] = ij;
    count += round;
    __syncthreads();
  }
  for (int h = threadIdx.x; h < H; h += TABLE_THREADS) {
    float s = 0.f;
    for (int u = 0; u < count; ++u)
      s += dB[static_cast<long long>(h) * NN + list[u]];
    dtable[static_cast<long long>(tb) * H + h] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr int tile_bytes(int dp) { return NP * (dp + 8) * 2; }

int fwd_smem(int bf16, int dp) {
  return bf16 ? 2 * 3 * tile_bytes(dp) : 5 * NP * FP * 4;
}

int bwd_smem(int bf16, int dp) {
  return bf16 ? 2 * 5 * tile_bytes(dp) + 2 * NP * PSP * 2 + 2 * NP * 4
              : 7 * NP * FP * 4 + 2 * NP * 4;
}

const void* kernel(int which, int bf16, int dp) {
  if (!bf16)
    return which ? reinterpret_cast<const void*>(&window_attn_bwd_f32)
                 : reinterpret_cast<const void*>(&window_attn_fwd_f32);
  switch (dp) {
    case 16:
      return which ? reinterpret_cast<const void*>(&window_attn_bwd<16>)
                   : reinterpret_cast<const void*>(&window_attn_fwd<16>);
    case 32:
      return which ? reinterpret_cast<const void*>(&window_attn_bwd<32>)
                   : reinterpret_cast<const void*>(&window_attn_fwd<32>);
    case 48:
      return which ? reinterpret_cast<const void*>(&window_attn_bwd<48>)
                   : reinterpret_cast<const void*>(&window_attn_fwd<48>);
    case 64:
      return which ? reinterpret_cast<const void*>(&window_attn_bwd<64>)
                   : reinterpret_cast<const void*>(&window_attn_fwd<64>);
  }
  return nullptr;
}

int launch(const void* fn, int grid, int smem, Args a, cudaStream_t s) {
  void* args[] = {&a};
  const cudaError_t rc = cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args,
                                          static_cast<size_t>(smem), s);
  return rc != cudaSuccess ? static_cast<int>(rc)
                           : static_cast<int>(cudaGetLastError());
}

bool valid(int N, int H, int d, int nW, int Bw) {
  return N >= 1 && N <= NP && H >= 1 && d >= 1 && d <= 64 && nW >= 1 &&
         Bw >= 1 && Bw % nW == 0;
}

bool vec_ok(int vec, int bf16) {
  return vec == 16 || vec == 8 || vec == 4 || (bf16 && vec == 2);
}

Args make_args(const void* qkv, const void* out, const void* dout, void* o,
               float* lse, const float* table, const long long* idx,
               const float* mask, const float* scale_ptr, float* partial,
               float scale, int Bw, int N, int H, int d, int nW, int chunks,
               int in_vec, int out_vec) {
  Args a;
  a.qkv = qkv;
  a.out = out;
  a.dout = dout;
  a.o = o;
  a.lse = lse;
  a.table = table;
  a.idx = idx;
  a.mask = mask;
  a.scale_ptr = scale_ptr;
  a.partial = partial;
  a.scale = scale;
  a.N = N;
  a.H = H;
  a.d = d;
  a.in_vec = in_vec;
  a.out_vec = out_vec;
  const int B = Bw / nW;
  a.work.H = H;
  a.work.nW = nW;
  a.work.B = B;
  a.work.chunks = chunks;
  a.work.per = (B + chunks - 1) / chunks;
  return a;
}

}  // namespace ofb_win

using namespace ofb_win;

// The chunks of images a (head, window position) pair of the call takes
// (which: 0 the forward, 1 the backward): the c in 1 .. B with the least
// waves x (pairs a block + SETUP_PAIRS), waves = ceil(heads x positions x
// c / resident blocks), the smallest such c (fewest partials); a wave ends
// with its slowest block. On an H100 at Swin-T's four stages this picks
// the fastest of 1 to 44 chunks in each kernel and stage. Sets the
// kernel's shared memory limit first. -1 for a call no kernel serves or a
// CUDA error.
extern "C" int ofb_window_attn_grid(int which, int bf16, int dp, int H,
                                    int nW, int B) {
  const void* fn = kernel(which, bf16, dp);
  if (!fn || H < 1 || nW < 1 || B < 1) return -1;
  const int smem = which ? bwd_smem(bf16, dp) : fwd_smem(bf16, dp);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long groups = static_cast<long long>(H) * nW,
                  slots = static_cast<long long>(sms) * per_sm;
  long long best = 1, cost = -1;
  for (long long c = 1; c <= B; ++c) {
    const long long waves = (groups * c + slots - 1) / slots;
    const long long k = waves * ((B + c - 1) / c + SETUP_PAIRS);
    if (cost < 0 || k < cost) {
      best = c;
      cost = k;
    }
  }
  return static_cast<int>(best);
}

// out (Bw, N, H d) and lse (Bw, H, N) fp32 of the window attention of qkv
// (Bw, N, 3 H d), both contiguous, of qkv's type (bf16: bf16 = 1; fp32).
// dp: d rounded up to 16 (bf16). in_vec / out_vec: the bytes a copy of
// qkv / out rows moves.
extern "C" int ofb_window_attn_fwd(const void* qkv, void* out, float* lse,
                                   const float* table, const long long* idx,
                                   const float* mask, const float* scale_ptr,
                                   float scale, int Bw, int N, int H, int d,
                                   int nW, int chunks, int in_vec,
                                   int out_vec, int bf16, int dp,
                                   void* stream) {
  const void* fn = kernel(0, bf16, dp);
  if (!fn || !valid(N, H, d, nW, Bw) || chunks < 1 ||
      !vec_ok(in_vec, bf16) || !vec_ok(out_vec, bf16) ||
      (bf16 && (dp < d || dp % 16)))
    return -1;
  const Args a = make_args(qkv, nullptr, nullptr, out, lse, table, idx, mask,
                           scale_ptr, nullptr, scale, Bw, N, H, d, nW, chunks,
                           in_vec, out_vec);
  return launch(fn, H * nW * chunks, fwd_smem(bf16, dp), a,
                static_cast<cudaStream_t>(stream));
}

// dqkv (Bw, N, 3 H d) of qkv's type and dtable (T, H) fp32 from qkv, the
// forward's out and lse, and dout (Bw, N, H d, contiguous). partial: fp32
// (H nW chunks, N N) scratch; dB: fp32 (H, N N) scratch.
extern "C" int ofb_window_attn_bwd(const void* qkv, const void* out,
                                   const void* dout, const float* lse,
                                   const float* table, const long long* idx,
                                   const float* mask, const float* scale_ptr,
                                   float scale, void* dqkv, float* partial,
                                   float* dB, float* dtable, int Bw, int N,
                                   int H, int d, int nW, int T, int chunks,
                                   int in_vec, int out_vec, int bf16, int dp,
                                   void* stream) {
  const void* fn = kernel(1, bf16, dp);
  if (!fn || !valid(N, H, d, nW, Bw) || chunks < 1 || T < 1 ||
      !vec_ok(in_vec, bf16) || !vec_ok(out_vec, bf16) ||
      (bf16 && (dp < d || dp % 16)))
    return -1;
  const Args a = make_args(qkv, out, dout, dqkv, const_cast<float*>(lse),
                           table, idx, mask, scale_ptr, partial, scale, Bw, N,
                           H, d, nW, chunks, in_vec, out_vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NN = N * N;
  const int rc = launch(fn, H * nW * chunks, bwd_smem(bf16, dp), a, s);
  if (rc != cudaSuccess) return rc;
  const dim3 sums((NN + SUM_THREADS - 1) / SUM_THREADS, H);
  window_attn_bias_sum<<<sums, SUM_THREADS, 0, s>>>(partial, dB, NN,
                                                    nW * chunks);
  window_attn_bias_table<<<T, TABLE_THREADS, 0, s>>>(dB, idx, dtable, NN, H);
  return cudaGetLastError();
}
