// Hopper (sm_90a) building blocks of the resident, the streaming and the
// unaligned attention kernels (attention_{fwd,bwd}_{resident,streaming,
// unaligned}.cu): copies into swizzled shared-memory tiles (from 16-byte
// aligned rows, and from rows of any alignment), `wgmma` matrix
// descriptors and instructions, and the stores of an accumulator tile.
//
// Tiles. A tile of R rows x DP head-dim columns of bf16 (DP = 64 or 128) is
// kept as DP / 64 panels, R rows of 128 bytes each, panel after panel. Inside
// a panel the 16-byte chunk c of row r sits at chunk position c ^ (r % 8):
// the 128-byte swizzle that `wgmma` reads without bank conflicts. Every tile
// starts on a 1024-byte boundary (8 rows), so the swizzle phase of a row is
// its index mod 8. One tile serves both ways `wgmma` can read an operand:
//   * K-major ("rows x head dim", the head dim is summed over): q, k in
//     q kᵀ; do, v in do vᵀ. A k-step of 16 columns is 32 bytes along the row.
//   * MN-major B ("summed rows x head dim"): v in p v, k in ds k, do in
//     pᵀ do, q in dsᵀ q. A k-step is 16 rows = 2048 bytes; the instruction's
//     N is DP, its two 64-column halves one panel apart.
// The head dim d is a multiple of 8 (any d in [1, 128] in the unaligned
// body); K-major products run ceil(d / 16) k-steps, so they read columns
// up to d16 = 16 ceil(d / 16). Columns d .. d16 - 1 are written as zeros at
// every tile load, in both operands of a K-major product: stale shared
// memory may hold Inf or NaN bits, and 0 * NaN = NaN. Columns at or past
// d16 are never loaded: no K-major product reads them, and MN-major
// products only spill them into output columns that are never stored.
//
// Fragments (m64nNk16, fp32 sums, warpgroup of 128 threads): thread t holds
// rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8; of the 8-column block j
// it holds columns 8 j + 2 (t % 4) and the next, as acc[4 j + 0 .. 1] for
// row r0 and acc[4 j + 2 .. 3] for row r0 + 8. A register A operand of one
// k-step (16 columns = blocks 2 kk and 2 kk + 1) is those eight values
// rounded to bf16 in the same order, so a score tile turns into the A
// operand of the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ofb {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int WG = 128;               // threads of a warpgroup and of a block
constexpr int ROWS = 64;              // rows of a wgmma tile
constexpr int ROW_BYTES = 128;        // one panel row: 64 bf16
constexpr int MAX_SMEM = 232448;      // bytes a block may ask for
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, n, h;                  // element strides; the head-dim stride is 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary of the dynamic shared memory.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of chunk c (8 columns) of row r in a tile of `rows` rows.
__device__ __forceinline__ uint32_t chunk_offset(int rows, int r, int c) {
  return static_cast<uint32_t>((c >> 3) * rows * ROW_BYTES + r * ROW_BYTES +
                               (((c & 7) ^ (r & 7)) << 4));
}

// ---------------------------------------------------------------------------
// asynchronous copies, device memory -> shared memory
// ---------------------------------------------------------------------------

// 16 bytes; with bytes = 0 nothing is read and the 16 bytes become zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// 8 bytes; with bytes < 8 the rest become zeros.
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes (one fp32 row term); with bytes = 0 the 4 bytes become zeros.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's newest groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

// Make what this thread wrote or copied into shared memory visible to the
// tensor cores' reads (the async proxy); a block barrier follows it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the copy of rows row0 .. row0 + nrows - 1 of one (batch, head)
// (src points at its row 0, stride_n elements a row, d a multiple of 8, or
// with RAGGED any d in [1, DP]) into rows dst_row0 .. of the tile at shared
// address `tile`. Rows at or past N, and the chunks of columns d .. d16 - 1,
// become zeros (a copy of 0 bytes from the row's first chunk); with RAGGED
// the chunk that holds column d - 1 takes only the bytes up to it and
// zero-fills the rest. Needs 16-byte aligned rows: src % 16 bytes == 0,
// stride_n % 8 == 0. All threads of the block take part, dealt out over
// DP / 8 chunks a row (a power of two), those at or past d16 idle. With
// RAGGED the block is one warpgroup and the rows a whole 64-row tile
// (rows = nrows = ROWS, dst_row0 = 0), so each thread's copies are a fixed
// run, unrolled (as a runtime loop it cost the unaligned forward at
// KS = 4 registers enough to drop from four blocks an SM to three, and 15%
// of its time on an H100: probe_kernels' unaligned_ragged_runtime_loop).
template <int DP, bool RAGGED = false>
__device__ __forceinline__ void load_rows_async(uint32_t tile, int rows,
                                                int dst_row0, const bf16* src,
                                                long long stride_n, int row0,
                                                int nrows, int N, int d) {
  constexpr int CPR = DP / 8;
  const int c = threadIdx.x % CPR;
  if (c * 8 >= ((d + 15) & ~15)) return;
  const bool in_row = c * 8 < d;
  const int bytes = RAGGED ? 2 * min(d - 8 * c, 8) : 16;
  auto copy = [&](int r) {
    const int n = row0 + r;
    const bf16* g = src + static_cast<long long>(n < N ? n : N - 1) * stride_n
        + (in_row ? c * 8 : 0);
    cp_async_16(tile + chunk_offset(rows, dst_row0 + r, c), g,
                n < N && in_row ? bytes : 0);
  };
  if constexpr (RAGGED) {
#pragma unroll
    for (int i = 0; i < ROWS * CPR / WG; ++i)
      copy(threadIdx.x / CPR + i * (WG / CPR));
  } else {
    for (int r = threadIdx.x / CPR; r < nrows; r += blockDim.x / CPR)
      copy(r);
  }
}

// ---------------------------------------------------------------------------
// rows at any alignment (the unaligned body, attention_*_unaligned.cu)
// ---------------------------------------------------------------------------

// The widest copy that every row of a (B, N, H, d) bf16 view allows, in
// bytes, from its first element and its three element strides (batch,
// token, head): 16, 8 or 4 when it starts on that many bytes and every
// stride is a multiple of as many bytes, else 2.
inline int row_width(const void* p, const long long* st) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  for (int w = 16; w > 2; w /= 2) {
    bool ok = a % w == 0;
    for (int j = 0; j < 3; ++j) ok = ok && (2 * st[j]) % w == 0;
    if (ok) return w;
  }
  return 2;
}

__device__ __forceinline__ void st_shared_16(uint32_t dst, const uint4& x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// Bytes o .. o + 15 (o even) of the 32 bytes lo, hi.
__device__ __forceinline__ uint4 shift_chunks(const uint4& lo, const uint4& hi,
                                              int o) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = o >> 2, sh = (o & 2) * 8;
  uint32_t s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    s[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(s[0], s[1], sh),
                    __funnelshift_r(s[1], s[2], sh),
                    __funnelshift_r(s[2], s[3], sh),
                    __funnelshift_r(s[3], s[4], sh));
}

// The first `keep` (at most 7; none if keep <= 0) bf16 values of a chunk,
// the rest zeros.
__device__ __forceinline__ uint4 keep_values(const uint4& x, int keep) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = 2 * i >= keep ? 0u : 2 * i + 1 >= keep ? (w[i] & 0xFFFFu) : w[i];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy rows row0 .. row0 + 63 of one (batch, head) into the 64-row tile at
// shared address `tile` (the layout above), from rows that do not start on
// 16 bytes: src points at its row 0, stride_n elements a row, any d in
// [1, DP]; W is `row_width` of the view (rows on 16 bytes take
// load_rows_async<DP, true>). Rows at or past N and columns d .. d16 - 1
// become zeros; columns at or past d16 are not written (as
// load_rows_async). All WG threads of the block take part.
//   W = 8, 4: cp.async of W bytes, W / 2 columns a copy; the copy that
//     holds column d - 1 takes only the bytes up to it and zero-fills the
//     rest.
//   W = 2: the rows start on 2 bytes only. A thread reads, through the
//     read-only cache, the one or two aligned 16-byte chunks that hold its 8
//     columns (never a chunk that holds no byte of the row, so nothing past
//     the tensor is touched), shifts them into place in registers and
//     stores 16 bytes: lanes take neighbouring chunks of a row, so a warp's
//     reads are coalesced; four rows' reads are in flight at once, and the
//     tile is written when the call returns. (Tiles that are streamed are
//     staged instead, below, so that their copies stay asynchronous.)
// W = 8 and 4 start copies of the calling thread's current cp.async
// group.
template <int DP, int W>
__device__ __forceinline__ void load_rows_any(uint32_t tile, const bf16* src,
                                              long long stride_n, int row0,
                                              int N, int d) {
  const int d16 = (d + 15) & ~15;
  if constexpr (W == 4 || W == 8) {
    constexpr int E = W / 2, UPR = DP / E;   // values a copy; copies a row
    const int u = threadIdx.x % UPR;
    if (u * E >= d16) return;
    const int bytes = u * E < d ? min(W, 2 * (d - E * u)) : 0;
#pragma unroll 4
    for (int i = 0; i < ROWS * UPR / WG; ++i) {
      const int r = threadIdx.x / UPR + i * (WG / UPR), n = row0 + r;
      const bf16* g = src
          + static_cast<long long>(n < N ? n : N - 1) * stride_n
          + (bytes ? E * u : 0);
      const uint32_t dst = tile + chunk_offset(ROWS, r, u * E >> 3)
          + (u * E & 7) * 2;
      if constexpr (W == 8)
        cp_async_8(dst, g, n < N ? bytes : 0);
      else
        cp_async_4(dst, g, n < N ? bytes : 0);
    }
  } else {
    constexpr int CPR = DP / 8, PASS = WG / CPR;
    constexpr int BATCH = 4;                 // rows whose reads are in flight
    const int c = threadIdx.x % CPR;
    if (c * 8 >= d16) return;
    const int keep = d - 8 * c;
#pragma unroll
    for (int i0 = 0; i0 < ROWS / PASS; i0 += BATCH) {
      uint4 lo[BATCH], hi[BATCH];
      int o[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int n = row0 + threadIdx.x / CPR + (i0 + i) * PASS;
        lo[i] = hi[i] = make_uint4(0u, 0u, 0u, 0u);
        o[i] = 0;
        if (n < N && keep > 0) {
          const bf16* row = src + static_cast<long long>(n) * stride_n;
          const unsigned long long a =
              reinterpret_cast<unsigned long long>(row + 8 * c);
          const unsigned long long end =
              reinterpret_cast<unsigned long long>(row + d);
          const uint4* p = reinterpret_cast<const uint4*>(a & ~15ull);
          o[i] = static_cast<int>(a & 15ull);
          lo[i] = __ldg(p);
          if (o[i] != 0 && a - o[i] + 16 < end) hi[i] = __ldg(p + 1);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        uint4 x = shift_chunks(lo[i], hi[i], o[i]);
        if (keep < 8) x = keep_values(x, keep);
        st_shared_16(tile + chunk_offset(ROWS, threadIdx.x / CPR
                                               + (i0 + i) * PASS, c), x);
      }
    }
  }
}

// Rows row0 .. row0 + 63 into a 64-row tile by cp.async at the width `w`
// (16, 8 or 4; `row_width`) of the view, any d in [1, DP].
template <int DP>
__device__ __forceinline__ void load_rows_async_width(int w, uint32_t tile,
                                                      const bf16* src,
                                                      long long stride_n,
                                                      int row0, int N, int d) {
  if (w == 16)
    load_rows_async<DP, true>(tile, ROWS, 0, src, stride_n, row0, ROWS, N, d);
  else if (w == 8)
    load_rows_any<DP, 8>(tile, src, stride_n, row0, N, d);
  else
    load_rows_any<DP, 4>(tile, src, stride_n, row0, N, d);
}

// Columns of a tile of the unaligned body at KS = ceil(d / 16) k-steps:
// one 64-column panel up to d16 = 64, else two.
__host__ __device__ constexpr int panel_cols(int ks) {
  return ks <= 4 ? 64 : 128;
}

// Rows row0 .. row0 + 63 into a 64-row tile at the width `w` (16, 8, 4 or
// 2; `row_width`) of the view, any d in [1, DP].
template <int DP>
__device__ __forceinline__ void load_rows_width(int w, uint32_t tile,
                                                const bf16* src,
                                                long long stride_n, int row0,
                                                int N, int d) {
  if (w == 2)
    load_rows_any<DP, 2>(tile, src, stride_n, row0, N, d);
  else
    load_rows_async_width<DP>(w, tile, src, stride_n, row0, N, d);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(Pending)
               : "memory");
}

// Matrix descriptor: start address, leading and stride byte offsets (all in
// units of 16 bytes), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// K-major operand: rows r0 .. (r0 % 8 == 0) of the tile, head-dim columns
// 16 kk .. 16 kk + 15. Groups of 8 rows are 1024 bytes apart; the leading
// offset is not used by a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int r0, int kk) {
  return make_desc(tile + (kk >> 2) * rows * ROW_BYTES + r0 * ROW_BYTES +
                       (kk & 3) * 32,
                   16, 8 * ROW_BYTES);
}

// MN-major B operand: summed rows r0 .. r0 + 15 (r0 % 8 == 0) of the tile,
// all head-dim columns. Groups of 8 summed rows are 1024 bytes apart (the
// stride offset); 64-column panels are rows * 128 bytes apart (the leading
// offset).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int r0) {
  return make_desc(tile + r0 * ROW_BYTES, rows * ROW_BYTES, 8 * ROW_BYTES);
}

#define OFB_ACC8(o)                                                          \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),                \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 16) = or += A (64 x 16, shared) B (16 x 16, shared), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : OFB_ACC8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) = or += A (64 x 16, shared) B (16 x 32, shared), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 48) = or += A (64 x 16, shared) B (16 x 48, shared), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23},"
      " %24, %25, p, 1, 1, 0, 0;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8), OFB_ACC8(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = or += A (64 x 16, shared) B (16 x 64, shared), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8), OFB_ACC8(16), OFB_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 104) = or += A (64 x 16, shared) B (16 x 104, shared), K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[52], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51},"
      " %52, %53, p, 1, 1, 0, 0;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8), OFB_ACC8(16), OFB_ACC8(24), OFB_ACC8(32),
        OFB_ACC8(40), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = or += A (64 x 16, registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8), OFB_ACC8(16), OFB_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128) = or += A (64 x 16, registers) B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : OFB_ACC8(0), OFB_ACC8(8), OFB_ACC8(16), OFB_ACC8(24), OFB_ACC8(32),
        OFB_ACC8(40), OFB_ACC8(48), OFB_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef OFB_ACC8

// Pin registers that an asynchronous `wgmma` reads or writes at this point
// of the program: the compiler sees them read and written here, so it moves
// no access to them across the fence. Put one after the `wgmma_wait` that
// retires a product, before its accumulator is read or rescaled (the wait
// itself names no register).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Registers an asynchronous `wgmma` reads as its A operand stay allocated to
// it until this point (put after the wait that retires the product): the
// compiler sees them read and written here.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// ---------------------------------------------------------------------------
// registers
// ---------------------------------------------------------------------------

// 2^x on the special-function unit in one instruction (relative error
// 2^-22; results below the normal range flush to 0, which a softmax term
// that small may do); ex2(-inf) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sum of the products of the eight bf16 pairs in two 16-byte chunks.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x[i]), yf = __bfloat1622float2(y[i]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// Barrier of the 128 threads of one warpgroup; BAR is the hardware barrier
// they own (0 is __syncthreads' own: for blocks of one warpgroup).
template <int BAR>
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(BAR), "n"(WG) : "memory");
}

// Write the warpgroup's 64 x DP accumulator tile, rounded to bf16, to rows
// 0 .. rows_valid - 1 at `dst` (row stride dst_stride elements, d columns).
// The tile passes through the 64-row tile at `stage`, which nobody reads or
// fills any more, so that each thread stores 16 bytes and a row's chunks
// fall to neighbouring threads. A warpgroup barrier inside; the caller
// places another before `stage` is filled again.
// Write the warpgroup's 64 x DP accumulator tile, rounded to bf16, into the
// 64-row tile at `stage` (the layout above), each thread its own fragment.
template <int DP>
__device__ __forceinline__ void stage_acc_tile(const float (&acc)[DP / 2],
                                               unsigned char* stage) {
  const int tid = threadIdx.x % WG, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int q4 = (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + chunk_offset(ROWS, r0, j) + q4) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(stage + chunk_offset(ROWS, r0 + 8, j) + q4) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int DP, int BAR = 0>
__device__ __forceinline__ void store_acc_tile(const float (&acc)[DP / 2],
                                               unsigned char* stage,
                                               bf16* dst,
                                               long long dst_stride,
                                               int rows_valid, int d) {
  stage_acc_tile<DP>(acc, stage);
  warpgroup_sync<BAR>();
  const int tid = threadIdx.x % WG;
  constexpr int CPR = DP / 8;
  const int c = tid % CPR;
  if (c * 8 >= d) return;
  if (rows_valid > ROWS) rows_valid = ROWS;
  for (int r = tid / CPR; r < rows_valid; r += WG / CPR)
    *reinterpret_cast<uint4*>(dst + r * dst_stride + c * 8) =
        *reinterpret_cast<const uint4*>(stage + chunk_offset(ROWS, r, c));
}

// Write rows 0 .. rows_valid - 1 (at most 64) of the tile at `stage` (the
// layout above) to dst (row stride dst_stride elements, d columns) in units
// of W bytes: 16 (d a multiple of 8, rows on 16 bytes), 8 (d a multiple of
// 4, rows on 8), 4 (d even, rows on 4) or 2. The units of all rows are
// dealt out to the WG threads in order, so neighbouring threads write
// neighbouring units of a row.
template <int W>
__device__ __forceinline__ void store_rows_any(const unsigned char* stage,
                                               bf16* dst, long long dst_stride,
                                               int rows_valid, int d) {
  constexpr int E = W / 2;                   // values a unit
  const int upr = d / E, total = min(rows_valid, ROWS) * upr;
  // r = i / upr, exact: i < 8192 and (i + 0.5) / upr is at least 0.5 / 128
  // away from an integer, far beyond the float product's error
  const float inv = 1.f / upr;
  for (int i = threadIdx.x % WG; i < total; i += WG) {
    const int r = __float2int_rz((i + 0.5f) * inv), col = (i - r * upr) * E;
    const unsigned char* s = stage + chunk_offset(ROWS, r, col >> 3)
        + (col & 7) * 2;
    bf16* g = dst + r * dst_stride + col;
    if constexpr (W == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else if constexpr (W == 8)
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    else if constexpr (W == 4)
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
    else
      *reinterpret_cast<uint16_t*>(g) = *reinterpret_cast<const uint16_t*>(s);
  }
}

// store_rows_any at the width `w` (16, 8, 4 or 2) of the rows at dst.
__device__ __forceinline__ void store_rows_width(int w,
                                                 const unsigned char* stage,
                                                 bf16* dst,
                                                 long long dst_stride,
                                                 int rows_valid, int d) {
  if (w == 16)
    store_rows_any<16>(stage, dst, dst_stride, rows_valid, d);
  else if (w == 8)
    store_rows_any<8>(stage, dst, dst_stride, rows_valid, d);
  else if (w == 4)
    store_rows_any<4>(stage, dst, dst_stride, rows_valid, d);
  else
    store_rows_any<2>(stage, dst, dst_stride, rows_valid, d);
}

// Whether every pointer and stride allows 16-byte row copies.
inline bool aligned_16(const void* const* ptrs, const long long* st, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 8 != 0) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// streamed tiles of rows that do not start on 16 bytes
//
// A streamed tile of such rows (the unaligned body's next k, v or q, do
// tile) arrives in two steps, so that its copy stays asynchronous: the
// aligned 16-byte chunks that hold each row go into a staging area by
// 16-byte cp.async (`stage_rows_async`), and once they are in, the block
// shifts each row into place into the operand tile (`unstage_rows`). Row r
// of the staging area holds the aligned chunks from the one that holds its
// first value on, RC = DP / 8 + 1 slots of 16 bytes.
// ---------------------------------------------------------------------------

template <int DP>
__host__ __device__ constexpr int staged_bytes() {
  return ROWS * (DP / 8 + 1) * 16;
}

// Start the copies of rows row0 .. row0 + 63 (those below N) of one (batch,
// head) into the staging area at shared address `raw`: slot j of row r is
// the aligned chunk 16 j bytes on from the one that holds the row's first
// value, copied when it holds a byte of the row's d values (so nothing
// past the tensor is read). Lane c of a row takes slot c, lane 0 also slot
// DP / 8. Starts copies of the calling thread's current cp.async group.
template <int DP>
__device__ __forceinline__ void stage_rows_async(uint32_t raw,
                                                 const bf16* src,
                                                 long long stride_n, int row0,
                                                 int N, int d) {
  constexpr int CPR = DP / 8, RS = (CPR + 1) * 16;
  const int c = threadIdx.x % CPR;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / WG; ++i) {
    const int r = threadIdx.x / CPR + i * (WG / CPR), n = row0 + r;
    if (n >= N) continue;
    const unsigned long long a = reinterpret_cast<unsigned long long>(
        src + static_cast<long long>(n) * stride_n);
    const unsigned long long base = a & ~15ull, end = a + 2ull * d;
    for (int j = c; j <= CPR; j += CPR)
      if (base + 16 * j < end)
        cp_async_16(raw + r * RS + 16 * j,
                    reinterpret_cast<const void*>(base + 16 * j), 16);
  }
}

// Shift the staged rows row0 .. row0 + 63 into the 64-row tile at `tile`
// (the layout above), after their copies are in and a block barrier:
// chunk c of row r is bytes o .. o + 15 of slots c and c + 1, o the row's
// offset in its first slot, read as 4-byte words (o is even) and shifted
// by o % 4; values past d (from slots that were not copied too) and rows
// at or past N become zeros. Plain shared-memory stores: fence and barrier
// before a product reads the tile.
template <int DP>
__device__ __forceinline__ void unstage_rows(uint32_t tile,
                                             const unsigned char* raw,
                                             const bf16* src,
                                             long long stride_n, int row0,
                                             int N, int d) {
  constexpr int CPR = DP / 8, RS = (CPR + 1) * 16;
  const int c = threadIdx.x % CPR;
  if (c * 8 >= ((d + 15) & ~15)) return;
  const int keep = d - 8 * c;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / WG; ++i) {
    const int r = threadIdx.x / CPR + i * (WG / CPR), n = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && keep > 0) {
      const int o = static_cast<int>(reinterpret_cast<unsigned long long>(
          src + static_cast<long long>(n) * stride_n) & 15ull);
      // five words from the one that holds byte o, shifted by o % 4
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
          raw + r * RS + 16 * c + (o & ~3));
      const int sh = (o & 2) * 8;
      x = make_uint4(__funnelshift_r(w[0], w[1], sh),
                     __funnelshift_r(w[1], w[2], sh),
                     __funnelshift_r(w[2], w[3], sh),
                     __funnelshift_r(w[3], w[4], sh));
      if (keep < 8) x = keep_values(x, keep);
    }
    st_shared_16(tile + chunk_offset(ROWS, r, c), x);
  }
}

// Bytes of a streamed tile's second slot: the second buffer of a tile
// copied straight in, or the staging area of one that is staged.
template <int DP>
__host__ __device__ constexpr int slot_bytes() {
  return staged_bytes<DP>() > ROWS * DP * 2 ? staged_bytes<DP>()
                                            : ROWS * DP * 2;
}

// Allow `kernel` the block's full shared memory, once per device.
template <typename Kernel>
inline cudaError_t allow_full_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

}  // namespace sm90
}  // namespace ofb
