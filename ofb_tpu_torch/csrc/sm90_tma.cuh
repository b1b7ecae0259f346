// Hopper (sm_90a) building blocks of the streaming attention kernels
// (attention_{fwd,bwd}_streaming.cu): tensor maps and TMA copies, mbarrier
// rings, named barriers between warpgroups, register rebalancing, and the
// tiles that TMA writes and `wgmma` reads.
//
// Tiles. A tile holds R rows (64; the forward's K and V tiles 128) of
// DP = 64 + TW bf16 columns as TMA writes it:
// a panel of 64 columns (128-byte rows, the 128-byte swizzle of sm90.cuh:
// chunk c of row r at c ^ (r % 8)), then, when TW > 0, a tail panel of TW
// columns (2 TW-byte rows with the 2 TW-byte swizzle: chunk c of row r at
// c ^ ((r * 2 TW / 128) % (2 TW / 16))). TW is 0 (d <= 64), 16 (d16 = 80:
// ViT-H/14), 32 (d16 = 96) or 64 (d16 = 112, 128: a second 128-byte panel).
// Every tile starts on 1024 bytes, so the swizzle phase of a row is fixed
// by its index. TMA fills what lies past the tensor (rows past N, columns
// past d) with zeros: stale shared memory may hold NaN bits, and 0 * NaN is
// NaN.
//
// Tensor maps are encoded on the host at every call from that call's own
// pointers and strides (a CUDA graph keeps the maps of the call it
// captured), through the driver's cuTensorMapEncodeTiled, which the runtime
// hands out (cudaGetDriverEntryPoint): the libraries keep their plain C
// interface and link no driver library. A failed encode returns
// ENCODE_FAILED + the driver's code.
#pragma once

#include <cuda.h>

#include "sm90.cuh"

namespace ofb {
namespace sm90 {

// Return codes of the C entries beyond cudaError_t (all below 1000): the
// driver refused a map (1000 plus its CUresult, also below 1000), or it has
// no encoder.
constexpr int ENCODE_FAILED = 1000;
constexpr int NO_ENCODER = 2000;

template <int TW, int R = ROWS>
struct Tile {
  static_assert(TW == 0 || TW == 16 || TW == 32 || TW == 64, "tail width");
  static constexpr int DP = 64 + TW;               // columns a row
  static constexpr int TAIL = R * ROW_BYTES;       // offset of the tail panel
  static constexpr int TAIL_ROW = 2 * TW;          // bytes of a tail row
  static constexpr int BYTES = R * 2 * DP;         // the whole tile
  // wgmma descriptor layout of the tail: 1 = 128-byte, 2 = 64, 3 = 32 swizzle
  static constexpr int LAYOUT = TW == 16 ? 3 : TW == 32 ? 2 : 1;
};

// The tail width of KS k-steps of 16 head-dim columns (KS = ceil(d / 16)):
// d16 = 16 KS columns in all. The kernels take KS as a template argument,
// so that every product is a fixed run of `wgmma`s with no branch between
// them (ptxas serialises products around a branch).
__host__ __device__ constexpr int tail_of(int ks) {
  return ks <= 4 ? 0 : ks == 5 ? 16 : ks == 6 ? 32 : 64;
}

// ---------------------------------------------------------------------------
// descriptors of tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc_layout(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo,
                                                     int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major operand: rows r0 .. (r0 % 8 == 0) of the R-row tile at `t`,
// head-dim columns 16 kk .. 16 kk + 15 (the panel for kk < 4, else the
// tail).
template <int TW, int R = ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int r0, int kk) {
  using T = Tile<TW, R>;
  if (TW == 0 || kk < 4)
    return make_desc_layout(t + r0 * ROW_BYTES + kk * 32, 16, 8 * ROW_BYTES,
                            1);
  return make_desc_layout(t + T::TAIL + r0 * T::TAIL_ROW + (kk - 4) * 32, 16,
                          8 * T::TAIL_ROW, T::LAYOUT);
}

// MN-major B operand: summed rows r0 .. r0 + 15 of the tile at `t`; the
// panel's 64 columns, or the tail's TW.
__device__ __forceinline__ uint64_t desc_mn_panel(uint32_t t, int r0) {
  return make_desc_layout(t + r0 * ROW_BYTES, ROWS * ROW_BYTES,
                          8 * ROW_BYTES, 1);
}

template <int TW, int R = ROWS>
__device__ __forceinline__ uint64_t desc_mn_tail(uint32_t t, int r0) {
  using T = Tile<TW, R>;
  return make_desc_layout(t + T::TAIL + r0 * T::TAIL_ROW, R * T::TAIL_ROW,
                          8 * T::TAIL_ROW, T::LAYOUT);
}

// d (64 x 80) = or += A (64 x 16, shared) B (16 x 80, shared), both
// K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39},"
      " %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = or += A (64 x 16, shared) B (16 x 128, shared), both
// K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16) = or += A (64 x 16, registers) B (16 x 16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32) = or += A (64 x 16, registers) B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// An accumulator of 64 x DP: the panel's 64 columns and the tail's TW.
template <int TW>
struct Acc {
  float p[32];
  float t[TW > 0 ? TW / 2 : 1];

  __device__ __forceinline__ void fence() {
    fence_regs(p);
    fence_regs(t);
  }
  __device__ __forceinline__ void scale(float a0, float a1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[4 * j] *= a0;
      p[4 * j + 1] *= a0;
      p[4 * j + 2] *= a1;
      p[4 * j + 3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < TW / 8; ++j) {
      t[4 * j] *= a0;
      t[4 * j + 1] *= a0;
      t[4 * j + 2] *= a1;
      t[4 * j + 3] *= a1;
    }
  }
  // += (or =) A (64 x 16 summed rows) times rows r0 .. r0 + 15 of the
  // R-row tile at `b`, MN-major
  template <int R = ROWS>
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint32_t b,
                                      int r0, int accumulate) {
    wgmma_rs(p, a, desc_mn_panel(b, r0), accumulate);
    if constexpr (TW == 64)
      wgmma_rs(t, a, desc_mn_panel(b + Tile<TW, R>::TAIL, r0), accumulate);
    else if constexpr (TW > 0)
      wgmma_rs(t, a, desc_mn_tail<TW, R>(b, r0), accumulate);
  }
  // Rounded to bf16 into the tile at `tile` (generic address), rows r0 and
  // r0 + 8 of this thread, as TMA reads it for a store.
  __device__ __forceinline__ void write(unsigned char* tile, int r0,
                                        int lane) const {
    using T = Tile<TW>;
    const int q4 = (lane & 3) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + r * ROW_BYTES +
                                     ((j ^ (r & 7)) << 4) + q4) =
            pack_bf16(p[4 * j + 2 * h], p[4 * j + 2 * h + 1]);
      if constexpr (TW > 0) {
        const int ph = (r * T::TAIL_ROW >> 7) & (T::TAIL_ROW / 16 - 1);
#pragma unroll
        for (int j = 0; j < TW / 8; ++j)
          *reinterpret_cast<uint32_t*>(tile + T::TAIL + r * T::TAIL_ROW +
                                       ((j ^ ph) << 4) + q4) =
              pack_bf16(t[4 * j + 2 * h], t[4 * j + 2 * h + 1]);
      }
    }
  }
};

// The eight bf16 of chunk c (columns 8 c ..) of row r of a tile, for
// reading a tile with the threads (generic address).
template <int TW>
__device__ __forceinline__ uint4 tile_chunk(const unsigned char* tile, int r,
                                            int c) {
  using T = Tile<TW>;
  if (TW == 0 || c < 8)
    return *reinterpret_cast<const uint4*>(tile + r * ROW_BYTES +
                                           ((c ^ (r & 7)) << 4));
  const int ph = (r * T::TAIL_ROW >> 7) & (T::TAIL_ROW / 16 - 1);
  return *reinterpret_cast<const uint4*>(tile + T::TAIL + r * T::TAIL_ROW +
                                         (((c - 8) ^ ph) << 4));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers, register counts
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

// Makes the initialised barriers visible to TMA (the async proxy).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// Arrive, and expect `bytes` from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `phase` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  } while (!done);
}

// The barrier counts one arrival once this thread's earlier cp.async
// copies have landed (its initial count includes that arrival).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// Rows of a (B, N, H, d) operand: the box at column c0, row n0 of head h,
// batch b into shared memory at `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int n0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(n0), "r"(h), "r"(b)
      : "memory");
}

// The box at `src` in shared memory to the operand; rows past N and columns
// past d are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int n0,
                                          int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(n0),
         "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's stores have read their shared memory (it may be refilled).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Named barriers: `threads` threads of the block, barrier `id` (0 is
// __syncthreads' own).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// the block's roles
// ---------------------------------------------------------------------------

// A block is a producer warpgroup (its first thread drives TMA; it keeps
// PRODUCER_REGS registers a thread) and two consumer warpgroups on `wgmma`
// (CONSUMER_REGS), one block an SM, persistent over work items.
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * WG;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// named barriers: consumer w's turn at the tensor cores is barrier
// SCHED + w (both consumers, 256 threads); its own warpgroup's is
// WG_BAR + w (128)
constexpr int SCHED = 1, WG_BAR = 3;

// Ping-pong: consumer w waits for its turn to issue products, and hands the
// turn to the other once they are issued, so that one warpgroup's
// exponentials run under the other's products. Consumer 1 hands consumer 0
// the first turn (`turn_start`); both take the same number of turns, and
// consumer 1 skips its last hand-over, so every barrier phase completes.
__device__ __forceinline__ void turn_start(int w) {
  if (w == 1) bar_arrive(SCHED, 2 * WG);
}
__device__ __forceinline__ void turn_take(int w) {
  bar_sync(SCHED + w, 2 * WG);
}
__device__ __forceinline__ void turn_give(int w, bool last) {
  if (!(w == 1 && last)) bar_arrive(SCHED + (w ^ 1), 2 * WG);
}

// ---------------------------------------------------------------------------
// host: tensor maps, SM count
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 (B, N, H, d) operand at `ptr` with element strides
// st = (batch, token, head), boxes of `cols` columns x `rows` rows of one
// head, swizzled by the box's row bytes (2 cols). 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* ptr, int B, int N,
                       int H, int d, const long long* st, int cols,
                       int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return NO_ENCODER;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(N), cuuint64_t(H),
                              cuuint64_t(B)};
  // a dimension of extent 1 is never stepped along; TMA takes no stride 0
  auto bytes = [](long long s, int n) {
    return cuuint64_t(s == 0 && n == 1 ? 16 : 2 * s);
  };
  const cuuint64_t strides[3] = {bytes(st[1], N), bytes(st[2], H),
                                 bytes(st[0], B)};
  const cuuint32_t box[4] = {cuuint32_t(cols), cuuint32_t(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// The panel map (64 columns) and the tail map (TW columns from column 64)
// of one operand, boxes of `rows` rows.
template <int TW>
inline int encode_operand(CUtensorMap* panel, CUtensorMap* tail,
                          const void* ptr, int B, int N, int H, int d,
                          const long long* st, int rows = ROWS) {
  int rc = encode_rows(panel, ptr, B, N, H, d, st, 64, rows);
  if (rc == 0 && TW > 0) rc = encode_rows(tail, ptr, B, N, H, d, st, TW, rows);
  return rc;
}

// Streaming multiprocessors of the current device.
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  return count[dev];
}

}  // namespace sm90
}  // namespace ofb
