// Hopper (sm_90a) building blocks of the resident and the streaming
// attention kernels (attention_{fwd,bwd}_{resident,streaming}.cu):
// asynchronous copies into swizzled shared-memory tiles, `wgmma` matrix
// descriptors and instructions, and the store of an accumulator tile.
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
// The head dim d is a multiple of 8; K-major products run ceil(d / 16)
// k-steps, so they read columns up to d16 = 16 ceil(d / 16). Columns d ..
// d16 - 1 (8 of them when d = 8 * odd) are written as zeros at every tile
// load, in both operands of a K-major product: stale shared memory may hold
// Inf or NaN bits, and 0 * NaN = NaN. Columns at or past d16 are never
// loaded: no K-major product reads them, and MN-major products only spill
// them into output columns that are never stored.
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
// (src points at its row 0, stride_n elements a row, d a multiple of 8)
// into rows dst_row0 .. of the tile at shared address `tile`. Rows at or
// past N, and the chunks of columns d .. d16 - 1, become zeros (a copy of 0
// bytes from the row's first chunk). Needs 16-byte aligned rows: src % 16
// bytes == 0, stride_n % 8 == 0. All threads of the block take part, dealt
// out over DP / 8 chunks a row (a power of two), those at or past d16 idle.
template <int DP>
__device__ __forceinline__ void load_rows_async(uint32_t tile, int rows,
                                                int dst_row0, const bf16* src,
                                                long long stride_n, int row0,
                                                int nrows, int N, int d) {
  constexpr int CPR = DP / 8;
  const int c = threadIdx.x % CPR;
  if (c * 8 >= ((d + 15) & ~15)) return;
  const bool in_row = c * 8 < d;
  for (int r = threadIdx.x / CPR; r < nrows; r += blockDim.x / CPR) {
    const int n = row0 + r;
    const bf16* g = src + static_cast<long long>(n < N ? n : N - 1) * stride_n
        + (in_row ? c * 8 : 0);
    cp_async_16(tile + chunk_offset(rows, dst_row0 + r, c), g,
                n < N && in_row ? 16 : 0);
  }
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
template <int DP, int BAR = 0>
__device__ __forceinline__ void store_acc_tile(const float (&acc)[DP / 2],
                                               unsigned char* stage,
                                               bf16* dst,
                                               long long dst_stride,
                                               int rows_valid, int d) {
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
  warpgroup_sync<BAR>();
  constexpr int CPR = DP / 8;
  const int c = tid % CPR;
  if (c * 8 >= d) return;
  if (rows_valid > ROWS) rows_valid = ROWS;
  for (int r = tid / CPR; r < rows_valid; r += WG / CPR)
    *reinterpret_cast<uint4*>(dst + r * dst_stride + c * 8) =
        *reinterpret_cast<const uint4*>(stage + chunk_offset(ROWS, r, c));
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
