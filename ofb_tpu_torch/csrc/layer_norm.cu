// Layer norm over the last dim of (rows, D), masked or plain, forward and
// backward (ops/layer_norm.py).
//
// No TPU kernel is replaced: the JAX package writes the norm as jnp ops
// (ofb_tpu/ops/gates.py masked_layer_norm, layer_norm) and XLA fuses the
// chain on the TPU. Written eagerly in PyTorch the chain is ten to fourteen
// fp32 passes over the activations and autograd keeps three fp32 copies of
// them for the backward; these kernels read x once and write y once
// (forward), read x and dy once and write dx once (backward).
//
// What bounds them is the bytes: a few flops an element against 4 (bf16
// forward) or 6 (bf16 backward) bytes. So the design keeps everything but x,
// dy and the outputs off device memory, and keeps enough of those bytes in
// flight. A group of L lanes (8, 16 or 32) takes a row at a time, so a warp
// takes 32 / L rows (a grid-stride loop over rows); each lane owns NV chunks
// of VEC elements (8 or 16 bytes) of its group's row. The warp's next rows
// are on their way into a ring of slots in shared memory (cp.async, a lane
// copying its own chunks, so no lane waits for another), so the loads in
// flight cost no registers; a lane reads its chunks of the current row into
// registers and forms the moments in fp32 in two passes (mean, then centred
// variance: the same arithmetic as the plain twin). Small groups serve
// short rows: there a row's fixed work (the shuffle reductions, the
// moments' stores) and not its bytes sets the pace, and a group of 8 lanes
// does it in 3 shuffle steps for 4 rows at once. gamma and beta wait in
// shared memory, the mask's live bits in registers. The per-row mean and
// rstd (fp32) are the only thing the forward saves for the backward. The
// backward forms dx from x, dy and the saved moments, and sums dgamma and
// dbeta in registers over the lane's rows; the groups of a warp add theirs
// by shuffles, the warps of a block in turn in shared memory, each block
// writes one partial row, and a second kernel sums the partials column by
// column in a fixed order. No atomics: the same inputs give the same bits.
//
// The mask (fp32, D) marks live channels (> 0); mode 0 is the plain norm
// (every channel live), 1 writes 0 on dropped channels, 2 passes them
// through (y = x, dx = dy). cnt = max(live channels, 1). Rows wider than a
// lane's registers hold (VEC NV > 32), and rows whose chunks would be under
// 8 bytes (D, a row stride or a pointer not a multiple of 2 elements in
// fp32, of 4 in bf16), take the looped kernels, which read the row from
// memory once per pass and sum dgamma and dbeta in a column kernel.
//
// Every entry launches on the stream it is given, never synchronises and
// allocates nothing; it returns -1 for a combination it does not serve and
// else cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ofb_ln {

constexpr int WARPS = 8;                 // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int SLICES = 32;               // row slices of the column kernels
constexpr int LOOP_CHUNK = 64;           // rows a looped column block sums
constexpr int LOOP_PARTS = 1024;         // most partial rows (looped path)
constexpr int IN_FLIGHT = 4096;          // bytes a warp keeps coming
enum { PLAIN = 0, ZERO = 1, IDENTITY = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool is_live(const float* mask, int c, int mode) {
  return mode == PLAIN || mask[c] > 0.f;
}

// The rows path of (T, L, VEC, NV): a group of L lanes takes a row, so a
// warp takes G = 32 / L rows at a time; a lane owns the columns
// (L k + l) VEC + e of its group's row, k < NV, e < VEC (l: its lane in the
// group). Rows of up to W = L VEC NV elements; a ring of S slots of G rows
// a warp (S - 1 slots in flight, about IN_FLIGHT bytes); the dynamic shared
// memory of a block: gamma (and beta in the forward) and the warps' rings
// of x (and dy in the backward).
template <typename T, int L, int VEC, int NV>
struct Rows {
  static constexpr int G = 32 / L, W = L * VEC * NV;
  __host__ __device__ static constexpr int stages(int tensors) {
    const int s =
        IN_FLIGHT / (G * W * static_cast<int>(sizeof(T)) * tensors) + 1;
    return s < 2 ? 2 : s > 8 ? 8 : s;
  }
  __host__ __device__ static constexpr int smem(int tensors) {
    return (3 - tensors) * W * 4 + WARPS * stages(tensors) * tensors * G * W *
                                       static_cast<int>(sizeof(T));
  }
};

// The sum of v over the L lanes of a group (every lane of it gets it).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's live bits (bit VEC k + e); the row's live count (at least 1)
// over its group.
template <int L, int VEC, int NV>
__device__ __forceinline__ unsigned live_columns(const float* mask, int D,
                                                 int mode, int l,
                                                 float& cnt) {
  unsigned live = 0;
  float n = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (L * k + l) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (c0 < D && is_live(mask, c0 + e, mode)) {
        live |= 1u << (k * VEC + e);
        n += 1.f;
      }
  }
  n = group_sum<L>(n);
  cnt = n > 0.f ? n : 1.f;
  return live;
}

// v = p[0 .. VEC - 1] from shared memory, as 16- or 8-byte reads where VEC
// allows (p is then on as many bytes: a multiple of VEC into an aligned
// array).
template <int VEC>
__device__ __forceinline__ void smem_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

// Copies src (D floats) into the block's shared dst; the caller syncs.
__device__ __forceinline__ void stage(float* dst, const float* src, int D) {
  for (int i = threadIdx.x; i < D; i += THREADS) dst[i] = src[i];
}

// Starts the copy of the lane's chunks of row `row` into its row of a ring
// slot (nothing past the last row); the caller commits the group.
template <typename T, int L, int VEC, int NV>
__device__ __forceinline__ void fetch_row(T* slot, const T* base,
                                          long long stride, long long row,
                                          int rows, int D, int l) {
  if (row < rows) {
    const T* src = base + row * stride;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (L * k + l) * VEC;
      if (c0 < D)
        __pipeline_memcpy_async(slot + c0, src + c0, VEC * sizeof(T));
    }
  }
}

// The lane's chunks of its row of a ring slot, as floats (0 past D).
template <typename T, int L, int VEC, int NV>
__device__ __forceinline__ void read_row(const T* slot, int D, int l,
                                         float (&v)[NV][VEC]) {
  using P = Pack<T, VEC>;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (L * k + l) * VEC;
    if (c0 < D) {
      const P p = *reinterpret_cast<const P*>(slot + c0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = to_f(p.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// rows path: a row in a group's registers (VEC NV <= 32), the next ones in
// flight
// ---------------------------------------------------------------------------

template <typename T, int L, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_rows(const void* x_, long long xs, const float* mask,
                    const float* gamma, const float* beta, void* y_,
                    float* mean_out, float* rstd_out, int rows, int D,
                    float eps, int mode) {
  using RW = Rows<T, L, VEC, NV>;
  constexpr int G = RW::G, W = RW::W, S = RW::stages(1);
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) float smem[];
  float* g = smem;
  float* b = smem + W;
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / L, l = lane % L;
  // the warp's ring: S slots of G rows; this lane's row in each
  T* ring = reinterpret_cast<T*>(smem + 2 * W) + (warp * S * G + sub) * W;
  const long long step = static_cast<long long>(gridDim.x) * WARPS * G;
  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + warp) * G;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    fetch_row<T, L, VEC, NV>(ring + s * G * W, x, xs, first + s * step + sub,
                             rows, D, l);
    __pipeline_commit();
  }
  stage(g, gamma, D);
  stage(b, beta, D);
  __syncthreads();
  float cnt;
  const unsigned live = live_columns<L, VEC, NV>(mask, D, mode, l, cnt);
  int slot = 0;
  for (long long base = first; base < rows; base += step) {
    const long long row = base + sub;
    const int next = slot == 0 ? S - 1 : slot - 1;   // (slot + S - 1) % S
    fetch_row<T, L, VEC, NV>(ring + next * G * W, x, xs,
                             row + (S - 1) * step, rows, D, l);
    __pipeline_commit();
    __pipeline_wait_prior(S - 1);
    float v[NV][VEC];
    read_row<T, L, VEC, NV>(ring + slot * G * W, D, l, v);
    slot = slot == S - 1 ? 0 : slot + 1;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (live >> (k * VEC + e) & 1u) s += v[k][e];
    const float mu = group_sum<L>(s) / cnt;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (live >> (k * VEC + e) & 1u) {
          const float d = v[k][e] - mu;
          q += d * d;
        }
    const float rs = 1.f / sqrtf(group_sum<L>(q) / cnt + eps);
    if (row >= rows) continue;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (L * k + l) * VEC;
      if (c0 >= D) continue;
      P p;
      float gv[VEC], bv[VEC];
      smem_vec<VEC>(g + c0, gv);
      smem_vec<VEC>(b + c0, bv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = v[k][e];
        p.v[e] = from_f<T>(live >> (k * VEC + e) & 1u
                               ? (xv - mu) * rs * gv[e] + bv[e]
                               : (mode == IDENTITY ? xv : 0.f));
      }
      *reinterpret_cast<P*>(y + row * D + c0) = p;
    }
    if (l == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rs;
    }
  }
}

template <typename T, int L, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_rows(const void* x_, long long xs, const void* dy_,
                    long long dys, const float* mask, const float* gamma,
                    const float* mean, const float* rstd, void* dx_,
                    float* partial, int rows, int D, int mode) {
  using RW = Rows<T, L, VEC, NV>;
  constexpr int G = RW::G, W = RW::W, S = RW::stages(2);
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float acc[2][W];
  float* g = smem;
  const T* x = static_cast<const T*>(x_);
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / L, l = lane % L;
  // the warp's ring: S slots of G rows of x, then G rows of dy
  T* ring = reinterpret_cast<T*>(smem + W) + (warp * S * 2 * G + sub) * W;
  const long long step = static_cast<long long>(gridDim.x) * WARPS * G;
  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + warp) * G;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const long long row = first + s * step + sub;
    fetch_row<T, L, VEC, NV>(ring + 2 * s * G * W, x, xs, row, rows, D, l);
    fetch_row<T, L, VEC, NV>(ring + (2 * s + 1) * G * W, dy, dys, row, rows,
                             D, l);
    __pipeline_commit();
  }
  stage(g, gamma, D);
  __syncthreads();
  float cnt;
  const unsigned live = live_columns<L, VEC, NV>(mask, D, mode, l, cnt);
  float dg[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dg[k][e] = db[k][e] = 0.f;
  // the row moments come one row ahead, in registers
  float pm = first + sub < rows ? mean[first + sub] : 0.f;
  float pr = first + sub < rows ? rstd[first + sub] : 0.f;
  int slot = 0;
  for (long long base = first; base < rows; base += step) {
    const long long row = base + sub;
    const int next = slot == 0 ? S - 1 : slot - 1;
    const long long ahead = row + (S - 1) * step;
    fetch_row<T, L, VEC, NV>(ring + 2 * next * G * W, x, xs, ahead, rows, D,
                             l);
    fetch_row<T, L, VEC, NV>(ring + (2 * next + 1) * G * W, dy, dys, ahead,
                             rows, D, l);
    __pipeline_commit();
    const float mu = pm, rs = pr;
    if (row + step < rows) {
      pm = mean[row + step];
      pr = rstd[row + step];
    }
    __pipeline_wait_prior(S - 1);
    // two passes over the row in shared memory, a chunk at a time: the row
    // sums, then dx and the sums of dgamma and dbeta
    const T* xr = ring + 2 * slot * G * W;
    const T* dr = ring + (2 * slot + 1) * G * W;
    slot = slot == S - 1 ? 0 : slot + 1;
    float sa = 0.f, sc = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (L * k + l) * VEC;
      if (c0 >= D) continue;
      const P px = *reinterpret_cast<const P*>(xr + c0);
      const P pd = *reinterpret_cast<const P*>(dr + c0);
      float gv[VEC];
      smem_vec<VEC>(g + c0, gv);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (live >> (k * VEC + e) & 1u) {
          const float gy = to_f(pd.v[e]) * gv[e];
          sa += gy;
          sc += gy * ((to_f(px.v[e]) - mu) * rs);
        }
    }
    const float a = group_sum<L>(sa) / cnt, c = group_sum<L>(sc) / cnt;
    if (row >= rows) continue;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (L * k + l) * VEC;
      if (c0 >= D) continue;
      const P px = *reinterpret_cast<const P*>(xr + c0);
      const P pd = *reinterpret_cast<const P*>(dr + c0);
      P p;
      float gv[VEC];
      smem_vec<VEC>(g + c0, gv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float dyv = to_f(pd.v[e]), xhv = (to_f(px.v[e]) - mu) * rs;
        if (live >> (k * VEC + e) & 1u) {
          p.v[e] = from_f<T>(rs * (dyv * gv[e] - a - xhv * c));
          dg[k][e] += dyv * xhv;
          db[k][e] += dyv;
        } else {
          p.v[e] = from_f<T>(mode == IDENTITY ? dyv : 0.f);
        }
      }
      *reinterpret_cast<P*>(dx + row * D + c0) = p;
    }
  }
  // the block's sums: the groups of a warp add theirs (shuffles in a fixed
  // order), then the warps add theirs in turn; one partial row a block
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        dg[k][e] += __shfl_xor_sync(0xffffffffu, dg[k][e], o);
        db[k][e] += __shfl_xor_sync(0xffffffffu, db[k][e], o);
      }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && sub == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c0 = (L * k + l) * VEC;
        if (c0 >= D) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[0][c0 + e] = (w ? acc[0][c0 + e] : 0.f) + dg[k][e];
          acc[1][c0 + e] = (w ? acc[1][c0 + e] : 0.f) + db[k][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    out[i] = acc[0][i];
    out[D + i] = acc[1][i];
  }
}

// out[c] = sum over p < parts of partial[p][c], c < n, in the order of p.
__global__ void __launch_bounds__(32 * SLICES)
layer_norm_sum_partials(const float* partial, int parts, int n, float* out) {
  __shared__ float s[SLICES][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (col < n)
    for (int p = threadIdx.y; p < parts; p += SLICES)
      v += partial[static_cast<long long>(p) * n + col];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = s[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < SLICES; ++j) t += s[j][threadIdx.x];
    out[col] = t;
  }
}

// ---------------------------------------------------------------------------
// looped: rows wider than registers hold, or read element by element
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_loop(const void* x_, long long xs, const float* mask,
                    const float* gamma, const float* beta, void* y_,
                    float* mean_out, float* rstd_out, int rows, int D,
                    float eps, int mode) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int c = lane; c < D; c += 32) n += is_live(mask, c, mode);
  n = __reduce_add_sync(0xffffffffu, n);
  const float cnt = static_cast<float>(n > 0 ? n : 1);
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
       row < rows; row += step) {
    const T* xr = x + row * xs;
    float s = 0.f;
    for (int c = lane; c < D; c += 32)
      if (is_live(mask, c, mode)) s += to_f(xr[c]);
    const float mu = warp_sum(s) / cnt;
    float q = 0.f;
    for (int c = lane; c < D; c += 32)
      if (is_live(mask, c, mode)) {
        const float d = to_f(xr[c]) - mu;
        q += d * d;
      }
    const float rs = 1.f / sqrtf(warp_sum(q) / cnt + eps);
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f(xr[c]);
      y[row * D + c] = from_f<T>(
          is_live(mask, c, mode) ? (xv - mu) * rs * gamma[c] + beta[c]
                                 : (mode == IDENTITY ? xv : 0.f));
    }
    if (lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rs;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_loop(const void* x_, long long xs, const void* dy_,
                    long long dys, const float* mask, const float* gamma,
                    const float* mean, const float* rstd, void* dx_, int rows,
                    int D, int mode) {
  const T* x = static_cast<const T*>(x_);
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int c = lane; c < D; c += 32) n += is_live(mask, c, mode);
  n = __reduce_add_sync(0xffffffffu, n);
  const float cnt = static_cast<float>(n > 0 ? n : 1);
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
       row < rows; row += step) {
    const T* xr = x + row * xs;
    const T* dr = dy + row * dys;
    const float mu = mean[row], rs = rstd[row];
    float sa = 0.f, sc = 0.f;
    for (int c = lane; c < D; c += 32)
      if (is_live(mask, c, mode)) {
        const float gy = to_f(dr[c]) * gamma[c];
        sa += gy;
        sc += gy * (to_f(xr[c]) - mu) * rs;
      }
    const float a = warp_sum(sa) / cnt, cc = warp_sum(sc) / cnt;
    for (int c = lane; c < D; c += 32) {
      const float dyv = to_f(dr[c]);
      dx[row * D + c] = from_f<T>(
          is_live(mask, c, mode)
              ? rs * (dyv * gamma[c] - a - (to_f(xr[c]) - mu) * rs * cc)
              : (mode == IDENTITY ? dyv : 0.f));
    }
  }
}

// Partial row p: dgamma (columns 0 .. D - 1) and dbeta (D .. 2D - 1) over
// the rows p chunk .. (p + 1) chunk - 1; a block takes 32 columns.
template <typename T>
__global__ void __launch_bounds__(32 * SLICES)
layer_norm_bwd_cols(const void* x_, long long xs, const void* dy_,
                    long long dys, const float* mask, const float* mean,
                    const float* rstd, float* partial, int rows, int D,
                    int chunk, int mode) {
  __shared__ float s[2][SLICES][32];
  const T* x = static_cast<const T*>(x_);
  const T* dy = static_cast<const T*>(dy_);
  const int col = blockIdx.x * 32 + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long r1 = min(r0 + chunk, static_cast<long long>(rows));
  float dg = 0.f, db = 0.f;
  if (col < D && is_live(mask, col, mode))
    for (long long row = r0 + threadIdx.y; row < r1; row += SLICES) {
      const float dyv = to_f(dy[row * dys + col]);
      dg += dyv * (to_f(x[row * xs + col]) - mean[row]) * rstd[row];
      db += dyv;
    }
  s[0][threadIdx.y][threadIdx.x] = dg;
  s[1][threadIdx.y][threadIdx.x] = db;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float tg = s[0][0][threadIdx.x], tb = s[1][0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < SLICES; ++j) {
      tg += s[0][j][threadIdx.x];
      tb += s[1][j][threadIdx.x];
    }
    float* out = partial + static_cast<long long>(blockIdx.y) * 2 * D;
    out[col] = tg;
    out[D + col] = tb;
  }
}

// ---------------------------------------------------------------------------
// the instances and their selection
// ---------------------------------------------------------------------------

using FwdFn = void (*)(const void*, long long, const float*, const float*,
                       const float*, void*, float*, float*, int, int, float,
                       int);
using BwdFn = void (*)(const void*, long long, const void*, long long,
                       const float*, const float*, const float*, const float*,
                       void*, float*, int, int, int);

struct Instance {
  int bf16, lanes, vec, nv;  // nv 0: the looped kernels
  FwdFn fwd;
  BwdFn bwd;                 // rows path only
  int smem_fwd, smem_bwd;    // dynamic shared memory (bytes), rows path
};

#define OFB_LN_ROWS(T, B, L, V, N)                                   \
  {B, L, V, N, &layer_norm_fwd_rows<T, L, V, N>,                     \
   &layer_norm_bwd_rows<T, L, V, N>, Rows<T, L, V, N>::smem(1),      \
   Rows<T, L, V, N>::smem(2)},
#define OFB_LN_TIERS(T, B, L, V)                                  \
  OFB_LN_ROWS(T, B, L, V, 1) OFB_LN_ROWS(T, B, L, V, 2)           \
  OFB_LN_ROWS(T, B, L, V, 3) OFB_LN_ROWS(T, B, L, V, 4)
#define OFB_LN_WIDE(T, B, L, V) \
  OFB_LN_TIERS(T, B, L, V) OFB_LN_ROWS(T, B, L, V, 6) OFB_LN_ROWS(T, B, L, V, 8)

// rows path: chunks of 8 or 16 bytes, NV in {1, 2, 3, 4, 6, 8}, VEC NV <=
// 32; groups of 16 and 8 lanes with 16-byte chunks
const Instance kInstances[] = {
    OFB_LN_TIERS(__nv_bfloat16, 1, 32, 8)
    OFB_LN_TIERS(__nv_bfloat16, 1, 16, 8)
    OFB_LN_TIERS(__nv_bfloat16, 1, 8, 8)
    OFB_LN_WIDE(__nv_bfloat16, 1, 32, 4)
    OFB_LN_WIDE(float, 0, 32, 4)
    OFB_LN_WIDE(float, 0, 16, 4)
    OFB_LN_WIDE(float, 0, 8, 4)
    OFB_LN_WIDE(float, 0, 32, 2)
    {1, 32, 1, 0, &layer_norm_fwd_loop<__nv_bfloat16>, nullptr, 0, 0},
    {0, 32, 1, 0, &layer_norm_fwd_loop<float>, nullptr, 0, 0},
};

const Instance* find(int bf16, int lanes, int vec, int nv) {
  for (const Instance& i : kInstances)
    if (i.bf16 == bf16 && i.nv == nv &&
        (nv == 0 || (i.vec == vec && i.lanes == lanes)))
      return &i;
  return nullptr;
}

// Blocks that fill the card with `fn` (THREADS threads, `smem` bytes of
// dynamic shared memory, which it is allowed first), no more than `needed`.
int fill_grid(const void* fn, int smem, long long needed) {
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
  const long long full = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(needed < full ? (needed > 0 ? needed : 1) : full);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Rows a partial row of the looped backward sums: LOOP_CHUNK, or more
// where that would give more than LOOP_PARTS partial rows.
long long loop_chunk(int rows) {
  const long long c = ceil_div(rows, LOOP_PARTS);
  return c > LOOP_CHUNK ? c : LOOP_CHUNK;
}

}  // namespace ofb_ln

using namespace ofb_ln;

// What the wrapper allocates and hands back: which = 0, the forward's grid;
// 1, the backward's grid; 2, the backward's partial rows (the length of the
// first dim of `partial`). -1 for a combination with no instance or a CUDA
// error.
extern "C" int ofb_layer_norm_grid(int which, int bf16, int lanes, int vec,
                                   int nv, int rows, int D) {
  const Instance* inst = find(bf16, lanes, vec, nv);
  if (!inst || rows < 1 || D < 1) return -1;
  if (nv == 0) {
    if (which == 2) return static_cast<int>(ceil_div(rows, loop_chunk(rows)));
    const void* fn = which == 0
        ? reinterpret_cast<const void*>(inst->fwd)
        : (bf16 ? reinterpret_cast<const void*>(
                      &layer_norm_bwd_loop<__nv_bfloat16>)
                : reinterpret_cast<const void*>(&layer_norm_bwd_loop<float>));
    return fill_grid(fn, 0, ceil_div(rows, WARPS));
  }
  const long long needed = ceil_div(rows, WARPS * (32 / lanes));
  if (which == 0)
    return fill_grid(reinterpret_cast<const void*>(inst->fwd), inst->smem_fwd,
                     needed);
  return fill_grid(reinterpret_cast<const void*>(inst->bwd), inst->smem_bwd,
                   needed);
}

// y = the norm of x (rows, D; row stride xs elements, the last dim
// contiguous), mean and rstd (rows,) fp32. mask: fp32 (D,), or null for
// mode 0. gamma, beta: fp32 (D,). y: contiguous (rows, D).
extern "C" int ofb_layer_norm_fwd(const void* x, long long xs,
                                  const float* mask, const float* gamma,
                                  const float* beta, void* y, float* mean,
                                  float* rstd, int rows, int D, float eps,
                                  int mode, int bf16, int lanes, int vec,
                                  int nv, int grid, void* stream) {
  const Instance* inst = find(bf16, lanes, vec, nv);
  if (!inst || grid < 1 || mode < PLAIN || mode > IDENTITY ||
      (mode != PLAIN && !mask) || (nv && D > lanes * vec * nv))
    return -1;
  inst->fwd<<<grid, THREADS, inst->smem_fwd,
              static_cast<cudaStream_t>(stream)>>>(
      x, xs, mask, gamma, beta, y, mean, rstd, rows, D, eps, mode);
  return cudaGetLastError();
}

// dx (contiguous (rows, D)), and dgb (fp32 (2D,): dgamma then dbeta) of
// the norm, from x, dy (row strides xs, dys), the forward's mean and rstd.
// partial: fp32 (parts, 2D) scratch, parts = ofb_layer_norm_grid(2, ..).
extern "C" int ofb_layer_norm_bwd(const void* x, long long xs, const void* dy,
                                  long long dys, const float* mask,
                                  const float* gamma, const float* mean,
                                  const float* rstd, void* dx, float* partial,
                                  float* dgb, int rows, int D, int mode,
                                  int bf16, int lanes, int vec, int nv,
                                  int grid, int parts, void* stream) {
  const Instance* inst = find(bf16, lanes, vec, nv);
  if (!inst || grid < 1 || parts < 1 || mode < PLAIN || mode > IDENTITY ||
      (mode != PLAIN && !mask) || (nv && D > lanes * vec * nv))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv) {
    if (parts != grid) return -1;
    inst->bwd<<<grid, THREADS, inst->smem_bwd, s>>>(
        x, xs, dy, dys, mask, gamma, mean, rstd, dx, partial, rows, D, mode);
  } else {
    const int chunk = static_cast<int>(loop_chunk(rows));
    if (ceil_div(rows, chunk) != parts) return -1;
    const dim3 cols(static_cast<unsigned>(ceil_div(D, 32)),
                    static_cast<unsigned>(parts));
    const dim3 block(32, SLICES);
    if (bf16) {
      layer_norm_bwd_loop<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          x, xs, dy, dys, mask, gamma, mean, rstd, dx, rows, D, mode);
      layer_norm_bwd_cols<__nv_bfloat16><<<cols, block, 0, s>>>(
          x, xs, dy, dys, mask, mean, rstd, partial, rows, D, chunk, mode);
    } else {
      layer_norm_bwd_loop<float><<<grid, THREADS, 0, s>>>(
          x, xs, dy, dys, mask, gamma, mean, rstd, dx, rows, D, mode);
      layer_norm_bwd_cols<float><<<cols, block, 0, s>>>(
          x, xs, dy, dys, mask, mean, rstd, partial, rows, D, chunk, mode);
    }
  }
  layer_norm_sum_partials<<<static_cast<unsigned>(ceil_div(2LL * D, 32)),
                            dim3(32, SLICES), 0, s>>>(partial, parts, 2 * D,
                                                      dgb);
  return cudaGetLastError();
}
