// Fused BatchNorm(train) -> ReLU -> MaxPool2x2, forward and backward,
// hand-written for Hopper (sm_90a).  Built by ops/_build.py with nvcc into
// a shared library with a plain C interface and loaded through ctypes
// (ops/bnpool.py).
//
// The forward replaces no TPU kernel: the reference package's
// bnpool_pallas._fwd_impl is plain JAX, which XLA fuses.  Its PyTorch form
// (ops/bnpool.py::batch_stats, normalize_relu_pool) is some fifteen
// elementwise and reduction passes over the pre-pool activation, so the
// port runs two kernels in its place:
//   bnpool_stats_{f32,bf16}      per-channel mean, biased var and
//       inv = rsqrt(var + eps) over N*H*W, accumulated in f32: the centered
//       two-pass variance for f32 x, the one-pass E[x^2] - mean^2
//       (clamped at 0) for bf16 x, as batch_stats computes them;
//   bnpool_norm_pool_{f32,bf16}  xhat = (x - mean) * inv, stored in x's
//       dtype, and the 2x2 max pool of max(act(act(xhat)*gamma + beta), 0),
//       rounded exactly as normalize_relu_pool rounds, so that the
//       backward's routing sees the values the pool compared.
// Bound: bytes.  The least a step moves is x read once and xhat and the
// pooled output written (4.5 bytes an element in bf16, 9 in f32); the two
// kernels read x twice (three times for the f32 statistics), the later
// reads of the smaller blocks from the L2.
//
// What each backward function replaces (cs744_ddp_tpu/ops/bnpool_pallas.py):
//   bnpool_sums_{f32,bf16}  <- _sums_kernel (phase 1): per-channel
//       sum(dy) and sum(dy * xhat) over N*H*W, with dy the pool-output
//       gradient dP routed to the first maximal element of each 2x2 window
//       (order 00, 01, 10, 11) and gated by the ReLU input z > 0.
//   bnpool_dx_{f32,bf16}    <- _dx_kernel (phase 2):
//       dx = (gamma*inv/n) * (n*dy - sum_dy - xhat*sum_dy_xhat), n = N*H*W,
//       through the same routing, stored in the residual's dtype.
//
// Bound: both are memory-bound passes (about 6-12 f32 operations per
// element against 4-8 bytes moved).  Phase 1 reads xhat and dP once
// (1.25 elements per element of xhat), phase 2 reads them again and writes
// dx.
//
// Shared by both phases:
//   * Layout is channels_last (NHWC in memory): C is contiguous.  The TPU
//     kernel's lane-merged [.., W/2, 2C] view was a vector-register trick
//     and is not carried over.
//   * The routing compares values rounded to the activation dtype and
//     rebuilds z = act(xhat * gamma + beta) with a separately rounded
//     product and sum (__fmul_rn, __fadd_rn: no fused multiply-add), which
//     is how the port's PyTorch forward computed the z its pool compared.
//   * Arithmetic is f32 for both residual dtypes (float, __nv_bfloat16).
//
// Phase 1 (bnpool_sums), one launch:
//   * A thread owns one 16-byte vector of channels (4 in f32, 8 in bf16)
//     and a stride of pool windows in (pooled row, wo) order, advanced by
//     adds, never recomputed by division; it issues a window's five 16-byte
//     loads (four of xhat, one of dP) straight into registers before the
//     window's arithmetic.  The sums need only the first maximal element
//     and the gate of each window (accumulate), about half the
//     instructions of the dx routing.
//   * The grid comes from the shape alone (ops/bnpool.py::sums_partition),
//     never from the card, so the summation order is the same on every
//     card.  Windows are taken grid-stride, so the blocks resident at one
//     time read neighbouring rows.  Blocks are capped at 64 registers a
//     thread so that four fit on an SM.
//   * The cross-block reduction is deterministic and in the same launch
//     (finish_block): each block writes its [2, C] partial, the grid meets
//     at a grid-wide barrier, then the first kFinishers blocks each add
//     their share of the columns over all partials, in block order.  No
//     float atomics, so the sums are bitwise reproducible run to run.
//   * The barrier needs every block of the grid resident at once.  The
//     kernel is launched cooperatively: the launch fails (and the wrapper
//     raises) rather than start a grid the card cannot hold, and the
//     barrier's state belongs to the launch, so concurrent launches, other
//     streams and CUDA-graph replays share nothing.
//   * A shared-memory ring fed by 1-D bulk copies (cp.async.bulk on an
//     mbarrier) was also written and timed: it was slower at every VGG-11
//     pool shape and was removed (PERF.md).
// Phase 2 (bnpool_dx), one launch, no reduction across threads:
//   * Bound: bytes (2.25 elements moved per element of xhat, about 12 f32
//     operations).  What keeps a kernel from it on this card is
//     instructions and loads in flight: with one thread per (window,
//     channel), 2- or 4-byte accesses, divisions per element to find the
//     window and five per-channel values reloaded per element, the bf16
//     variant does the f32 variant's work for half the bytes.
//   * A thread owns one 16-byte vector of channels (4 in f32, 8 in bf16)
//     and `per` windows of its block's tile, G apart in (pooled row, wo)
//     order, with G the block's groups of channel-vector lanes.  It issues
//     the five 16-byte loads (four of xhat, one of dP) of kDxWindows
//     windows before their arithmetic and writes four 16-byte stores a
//     window.  In a warp each quadrant's load covers whole 128-byte lines.
//   * The loads are evict-first (xhat and dP are read for the last time):
//     in the step, the sums kernel has just read the same tensors, and
//     lines that dx brings in then give way before the ones it has yet to
//     read.  The stores are plain: the convolution backward reads dx next.
//   * gamma, beta, scale = gamma*inv/n and the two sums of its vector are
//     loaded once into registers; (row, wo) advances by adds, so the only
//     division of a thread is its first window's row.
//   * The grid comes from the shape alone (ops/bnpool.py::dx_partition):
//     up to 2 (f32) or 8 (bf16) windows a thread, fewer at the small
//     shapes, in blocks of up to 256 threads, smaller where that leaves
//     fewer blocks than the card's 132 SMs.  The launch derives the lanes,
//     groups and tiles from (threads, blocks); any partition gives the
//     same dx.
//   * The per-element arithmetic keeps the scalar kernel's operations and
//     their order, so dx keeps its bits (chip_smoke.py prints a digest of
//     dx to compare two checkouts).  No shared memory: nothing is reused.
//   * Tried and slower (PERF.md): a 128- or 168-register cap (the bf16
//     variant takes 207, one 256-thread block an SM), one window's loads
//     in flight instead of two.
//
// Forward statistics (bnpool_stats), one cooperative launch:
//   * A thread owns one 16-byte channel vector and rows grid-stride (the
//     sums kernel's lanes), kStatsUnroll loads in flight, f32 sums.  Each
//     block adds its threads' sums in f64 into a [2, C] partial; after a
//     grid barrier the first kStatsFinishers blocks add the partials of
//     their channels in block order, in f64, and write the statistics.
//     The f32 variant's second pass (the centered squares, after a second
//     barrier that publishes the mean) runs each thread's rows back to
//     front.  The grid comes from the shape alone
//     (ops/bnpool.py::stats_partition), no float atomics: the statistics
//     are bitwise reproducible run to run, and the launch fails rather than
//     start a grid the card cannot hold.
// Forward normalize -> ReLU -> pool (bnpool_norm_pool), one launch: the dx
//   kernel's partition and walk (its own windows a thread,
//   ops/bnpool.py::norm_pool_partition); a thread loads its channels' mean,
//   inv, gamma and beta once and the four x vectors of kPoolWindows windows
//   before their arithmetic, and stores four xhat vectors and one pooled
//   vector a window.
//
// Each kernel adds one to a device counter (`executed`, a u64 of the
// wrapper's) when it runs: thread 0 of block 0, one atomic a launch.  A
// launch that a CUDA graph replays is counted on every replay, where the
// host sees only the capture.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kFinalUnroll = 4;   // partials in flight per finishing thread
constexpr int kSumMinBlocks = 4;  // resident sums blocks per SM to aim for
constexpr int kFinishers = 32;    // sums blocks that add up the partials
constexpr int kDxMaxThreads = 256;
constexpr int kDxWindows = 2;     // windows a dx thread loads, then computes
constexpr int kStatsThreads = kSumThreads;  // the sums kernel's lanes
constexpr int kStatsMinBlocks = 4;   // resident stats blocks per SM to aim for
constexpr int kStatsUnroll = 4;      // row vectors a stats thread has in flight
constexpr int kStatsFinishers = 128; // stats blocks that add up the partials
constexpr int kStatsChunk = 32;      // channels a finisher adds at a time
constexpr int kPoolWindows = 2;      // windows a norm_pool thread loads first
constexpr float kBnEps = 1e-5f;      // ops/bnpool.py BN_EPS

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of the residual dtype, unpacked to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // A bf16 is the top half of an f32; the lower address is the low half.
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // Rounded to nearest even, as from_f32.
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             (static_cast<unsigned>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// A last read: the line is allocated evict-first in L1 and L2 (ld.global.cs).
__device__ __forceinline__ uint4 load16_last(const void* p) {
  return __ldcs(static_cast<const uint4*>(p));
}

// ---------------------------------------------------------------------------
// Phase 1
// ---------------------------------------------------------------------------

// Routes one window of a thread's channel vector and adds it to the sums.
// The window's p goes to one element only, k = the first maximal y, and
// only if z_k > 0; as y_k = max(z_k, 0) is the window's maximum, that gate
// is wmax > 0.  So the sums need x_k and the gate, not the four dy that
// window_dx() builds: the same routing in about half the instructions.
template <typename T>
__device__ __forceinline__ void accumulate(const uint4 (&xv)[4],
                                           const uint4& pv, const float* gm,
                                           const float* bt, float* s_dy,
                                           float* s_dyx) {
  constexpr int V = Vec<T>::kN;
  float x[4][V], p[V];
#pragma unroll
  for (int q = 0; q < 4; ++q) Vec<T>::unpack(xv[q], x[q]);
  Vec<T>::unpack(pv, p);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      y[q] = fmaxf(
          to_f32<T>(from_f32<T>(__fadd_rn(__fmul_rn(x[q][j], gm[j]), bt[j]))),
          0.0f);
    const float wmax = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
    const float xk = y[0] == wmax   ? x[0][j]
                     : y[1] == wmax ? x[1][j]
                     : y[2] == wmax ? x[2][j]
                                    : x[3][j];
    const float dy = wmax > 0.0f ? p[j] : 0.0f;
    s_dy[j] += dy;
    s_dyx[j] += dy * xk;
  }
}

// Adds the windows this thread takes from `nr` consecutive pooled rows to
// its sums.  x and d point at the first xhat row and dP row, offset by the
// thread's channel vector.  The thread takes windows g, g + G, g + 2G, ...
// in (row, wo) order, advancing (row, wo) by adds, and issues a window's
// five 16-byte loads before its arithmetic.
template <typename T>
__device__ __forceinline__ void sweep(const T* __restrict__ x,
                                      const T* __restrict__ d, int nr, int W,
                                      int C, int G, int g, const float* gm,
                                      const float* bt, float* s_dy,
                                      float* s_dyx) {
  const int Wo = W / 2;
  const int step_r = G / Wo, step_w = G - (G / Wo) * Wo;
  int r = g / Wo, wo = g - (g / Wo) * Wo;
  while (r < nr) {
    const T* xq = x + (2 * r * W + 2 * wo) * C;
    const uint4 xv[4] = {load16(xq), load16(xq + C), load16(xq + W * C),
                         load16(xq + W * C + C)};
    accumulate<T>(xv, load16(d + (r * Wo + wo) * C), gm, bt, s_dy, s_dyx);
    r += step_r;
    wo += step_w;
    if (wo >= Wo) {
      wo -= Wo;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sum over partials p = p0, p0 + stride, ... < P of float4 column q, in
// that order, up to kFinalUnroll loads in flight (a short tail too: loads
// one at a time would cost a round trip each).  Read through L2 (__ldcg):
// the partials were written by other SMs.
__device__ __forceinline__ float4 column_sum(const float4* part, int q, int p0,
                                             int stride, int P, int Q) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int p = p0; p < P; p += kFinalUnroll * stride) {
    float4 v[kFinalUnroll];
#pragma unroll
    for (int u = 0; u < kFinalUnroll; ++u)
      if (p + u * stride < P)
        v[u] = __ldcg(part + static_cast<size_t>(p + u * stride) * Q + q);
#pragma unroll
    for (int u = 0; u < kFinalUnroll; ++u)
      if (p + u * stride < P) a = add4(a, v[u]);
  }
  return a;
}

// out[q0 .. q0 + n) = sum over the P partials (P rows of Q float4) of those
// float4 columns, in partial order, by the whole block: L lanes per column
// each add every L-th partial, then a fixed pairwise tree adds the lanes.
// `lanes` is shared scratch of kSumThreads float4.
__device__ __forceinline__ void reduce_columns(const float4* part, int P,
                                               int Q, int q0, int n,
                                               float4* out, float4* lanes) {
  const int t = threadIdx.x;
  // Lanes: a power of two, at most kSumThreads / n, and no more than keep
  // each lane on kFinalUnroll partials.
  int L = min(kSumThreads / n, (P + kFinalUnroll - 1) / kFinalUnroll);
  L = 1 << (31 - __clz(max(L, 1)));
  const int c = t % n, lane = t / n;
  if (lane < L) lanes[t] = column_sum(part, q0 + c, lane, L, P, Q);
  __syncthreads();
  for (int s = L / 2; s > 0; s /= 2) {
    if (t < s * n) lanes[t] = add4(lanes[t], lanes[t + s * n]);
    __syncthreads();
  }
  if (t < n) out[q0 + t] = lanes[t];
}

// The end of every sums block.  Its threads' sums become partial[b] ([2, C],
// b = blockIdx.x); after the grid barrier, block f < kFinishers adds its
// share of the float4 columns over all P partials, in block order, into
// sums.
template <int V>
__device__ __forceinline__ void finish_block(const float* s_dy,
                                             const float* s_dyx, int C, int G,
                                             int g, int cv,
                                             float* __restrict__ partial,
                                             float* __restrict__ sums) {
  __shared__ __align__(16) float red[2 * kSumThreads * V];  // [2][G][C]
  const int t = threadIdx.x;
  if (g < G) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[g * C + cv * V + j] = s_dy[j];
      red[(G + g) * C + cv * V + j] = s_dyx[j];
    }
  }
  __syncthreads();
  float* mine = partial + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int j = t; j < 2 * C; j += kSumThreads) {
    const int k = j >= C ? 1 : 0;
    const float* col = red + k * G * C + (j - k * C);
    float acc = 0.0f;
    for (int i = 0; i < G; ++i) acc += col[i * C];
    mine[j] = acc;
  }
  // Orders every block's partial before any finisher reads it (the
  // barrier is also a __syncthreads, so `red` is free again after it).
  cooperative_groups::this_grid().sync();
  const int P = gridDim.x, K = min(kFinishers, P);
  if (static_cast<int>(blockIdx.x) >= K) return;
  const int Q = C / 2;  // float4 columns of one [2, C] partial
  const int n = (Q + K - 1) / K;
  const int q0 = blockIdx.x * n;
  if (q0 < Q)
    reduce_columns(reinterpret_cast<const float4*>(partial), P, Q, q0,
                   min(n, Q - q0), reinterpret_cast<float4*>(sums),
                   reinterpret_cast<float4*>(red));
}

// The thread's channel vector: cv of CV = C / V, group g of G = 256 / CV.
struct Lane {
  int G, g, cv;
};

template <int V>
__device__ __forceinline__ Lane lane_of(int C) {
  const int CV = C / V;
  Lane l;
  l.G = kSumThreads / CV;
  l.g = threadIdx.x / CV;
  l.cv = threadIdx.x - l.g * CV;
  return l;
}

template <int V>
__device__ __forceinline__ void load_channels(const float* __restrict__ v,
                                              float* out) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(v) + i);
    out[4 * i] = f.x;
    out[4 * i + 1] = f.y;
    out[4 * i + 2] = f.z;
    out[4 * i + 3] = f.w;
  }
}

// Grid (P blocks, launched cooperatively), block 256.  Thread g of block b
// takes windows b*G + g, (b + P)*G + g, ... of all N*H/2 pooled rows in
// (row, wo) order.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, kSumMinBlocks)
    sums_kernel(const T* __restrict__ xhat, const T* __restrict__ dp,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ partial,
                float* __restrict__ sums, int rows, int W, int C,
                unsigned long long* __restrict__ executed) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(executed, 1ull);
  constexpr int V = Vec<T>::kN;
  const Lane l = lane_of<V>(C);
  float s_dy[V], s_dyx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s_dy[j] = s_dyx[j] = 0.0f;
  if (l.g < l.G) {
    float gm[V], bt[V];
    load_channels<V>(gamma + l.cv * V, gm);
    load_channels<V>(beta + l.cv * V, bt);
    sweep<T>(xhat + l.cv * V, dp + l.cv * V, rows, W, C, gridDim.x * l.G,
             blockIdx.x * l.G + l.g, gm, bt, s_dy, s_dyx);
  }
  finish_block<V>(s_dy, s_dyx, C, l.G, l.g, l.cv, partial, sums);
}

// ---------------------------------------------------------------------------
// Phase 2
// ---------------------------------------------------------------------------

// Per-channel values of a thread's channel vector, held in registers.
template <int V>
struct Channels {
  float gm[V], bt[V], scale[V], s_dy[V], s_dyx[V];
};

template <int V>
__device__ __forceinline__ Channels<V> load_dx_channels(
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ inv, const float* __restrict__ sums, int C,
    int c0, float n) {
  Channels<V> k;
  float iv[V];
  load_channels<V>(gamma + c0, k.gm);
  load_channels<V>(beta + c0, k.bt);
  load_channels<V>(inv + c0, iv);
  load_channels<V>(sums + c0, k.s_dy);
  load_channels<V>(sums + C + c0, k.s_dyx);
#pragma unroll
  for (int j = 0; j < V; ++j) k.scale[j] = k.gm[j] * iv[j] * (1.0f / n);
  return k;
}

// dx of one window of a thread's channel vector, from its four xhat
// vectors (order 00, 01, 10, 11) and its dP vector: dP routed to the first
// maximal y = max(z, 0), gated by z > 0, with z = act(xhat*gamma + beta)
// (product and sum rounded apart), then
// dx = scale * (n*dy - sum_dy - xhat*sum_dy_xhat) in f32.
template <typename T>
__device__ __forceinline__ void window_dx(const uint4 (&xv)[4],
                                          const uint4& pv,
                                          const Channels<Vec<T>::kN>& k,
                                          float n, uint4 (&out)[4]) {
  constexpr int V = Vec<T>::kN;
  float x[4][V], p[V], d[4][V];
#pragma unroll
  for (int q = 0; q < 4; ++q) Vec<T>::unpack(xv[q], x[q]);
  Vec<T>::unpack(pv, p);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float z[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[q] = to_f32<T>(
          from_f32<T>(__fadd_rn(__fmul_rn(x[q][j], k.gm[j]), k.bt[j])));
      y[q] = fmaxf(z[q], 0.0f);
    }
    const float wmax = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
    bool taken = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool hit = (y[q] == wmax) && !taken;
      taken = taken || hit;
      const float dy = (hit && z[q] > 0.0f) ? p[j] : 0.0f;
      d[q][j] = k.scale[j] * (n * dy - k.s_dy[j] - x[q][j] * k.s_dyx[j]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = Vec<T>::pack(d[q]);
}

// The launch's shape, worked out once on the host (launch_dx).
struct DxGrid {
  int W, C;
  int windows;         // N * H/2 * W/2, in (pooled row, wo) order
  int per;             // windows of a thread (fewer in the last tile)
  int step_r, step_w;  // G windows as (pooled rows, wo)
  float n;             // N * H * W
};

// Grid (tiles, chunks), block (L lanes, G groups).  Lane l of block
// (t, k) owns channel vector k*L + l; group g takes windows
// t*per*G + g + i*G, i < per, of the tile's per*G.
template <typename T>
__global__ void __launch_bounds__(kDxMaxThreads)
    dx_kernel(const T* __restrict__ xhat, const T* __restrict__ dp,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ inv, const float* __restrict__ sums,
              T* __restrict__ dx, DxGrid d,
              unsigned long long* __restrict__ executed) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0)
    atomicAdd(executed, 1ull);
  constexpr int V = Vec<T>::kN;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= d.C) return;
  const int G = blockDim.y, Wo = d.W / 2;
  const int first = blockIdx.x * d.per * G;
  const int end = min(d.windows, first + d.per * G);
  const Channels<V> k = load_dx_channels<V>(gamma, beta, inv, sums, d.C, c0,
                                            d.n);
  int w = first + threadIdx.y;
  int r = w / Wo, wo = w - r * Wo;
  while (w < end) {
    uint4 xv[kDxWindows][4], pv[kDxWindows];
    int xo[kDxWindows];
    bool live[kDxWindows];
#pragma unroll
    for (int u = 0; u < kDxWindows; ++u) {
      xo[u] = (2 * r * d.W + 2 * wo) * d.C + c0;
      live[u] = w < end;
      if (live[u]) {
        const T* xq = xhat + xo[u];
        xv[u][0] = load16_last(xq);
        xv[u][1] = load16_last(xq + d.C);
        xv[u][2] = load16_last(xq + d.W * d.C);
        xv[u][3] = load16_last(xq + d.W * d.C + d.C);
        pv[u] = load16_last(dp + w * d.C + c0);
      }
      w += G;
      r += d.step_r;
      wo += d.step_w;
      if (wo >= Wo) {
        wo -= Wo;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kDxWindows; ++u) {
      if (!live[u]) break;
      uint4 out[4];
      window_dx<T>(xv[u], pv[u], k, d.n, out);
      T* o = dx + xo[u];
      *reinterpret_cast<uint4*>(o) = out[0];
      *reinterpret_cast<uint4*>(o + d.C) = out[1];
      *reinterpret_cast<uint4*>(o + d.W * d.C) = out[2];
      *reinterpret_cast<uint4*>(o + d.W * d.C + d.C) = out[3];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: statistics
// ---------------------------------------------------------------------------

// The thread's f32 sums become one f64 partial a block: columns
// [k0 * C, k1 * C) of partial[b] ([2, C]: sum x, then sum x^2 or the
// centered squares), each summed over the block's G groups in group order.
// `red` is shared scratch of 2 * kStatsThreads * V floats.
template <int V>
__device__ __forceinline__ void stats_block_partial(const float* s1,
                                                    const float* s2,
                                                    const Lane& l, int C,
                                                    int k0, int k1,
                                                    double* __restrict__ mine,
                                                    float* red) {
  if (l.g < l.G) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[l.g * C + l.cv * V + j] = s1[j];
      red[(l.G + l.g) * C + l.cv * V + j] = s2[j];
    }
  }
  __syncthreads();
  for (int j = k0 * C + threadIdx.x; j < k1 * C; j += kStatsThreads) {
    const int k = j >= C ? 1 : 0;
    const float* col = red + k * l.G * C + (j - k * C);
    double acc = 0.0;
    for (int i = 0; i < l.G; ++i) acc += col[i * C];
    mine[j] = acc;
  }
}

// Column sums of the P f64 partials ([P][2][C]) for channels [c0, c0 + n)
// and halves [k0, k1), in partial order, into lanes[0 .. (k1 - k0) * n):
// L lanes a column each add every L-th partial, then a fixed pairwise tree
// adds the lanes.  Read through L2: other SMs wrote the partials.
__device__ __forceinline__ void stats_columns(const double* partial, int P,
                                              int C, int c0, int n, int k0,
                                              int k1, double* lanes) {
  const int t = threadIdx.x;
  const int cols = (k1 - k0) * n;
  int L = min(kStatsThreads / cols, (P + kFinalUnroll - 1) / kFinalUnroll);
  L = 1 << (31 - __clz(max(L, 1)));
  const int col = t % cols, lane = t / cols;
  if (lane < L) {
    const int k = k0 + col / n, c = c0 + col % n;
    const double* p = partial + k * C + c;
    double acc = 0.0;
#pragma unroll 4
    for (int b = lane; b < P; b += L)
      acc += __ldcg(p + static_cast<size_t>(b) * 2 * C);
    lanes[t] = acc;
  }
  __syncthreads();
  for (int s = L / 2; s > 0; s /= 2) {
    if (t < s * cols) lanes[t] += lanes[t + s * cols];
    __syncthreads();
  }
}

// The finishing blocks, after a grid barrier: block f < K of the grid owns
// channels [f * per, (f + 1) * per) and works through them kStatsChunk at a
// time, calling done(c, sum_of_half_k0, sum_of_half_k0+1) for each.
template <typename F>
__device__ __forceinline__ void stats_finish(const double* partial, int C,
                                             int k0, int k1, double* lanes,
                                             F done) {
  const int P = gridDim.x, K = min(kStatsFinishers, P);
  if (static_cast<int>(blockIdx.x) >= K) return;
  const int per = (C + K - 1) / K;
  const int end = min(C, (static_cast<int>(blockIdx.x) + 1) * per);
  for (int c0 = blockIdx.x * per; c0 < end; c0 += kStatsChunk) {
    const int n = min(kStatsChunk, end - c0);
    stats_columns(partial, P, C, c0, n, k0, k1, lanes);
    if (static_cast<int>(threadIdx.x) < n)
      done(c0 + threadIdx.x, lanes[threadIdx.x],
           k1 - k0 > 1 ? lanes[n + threadIdx.x] : 0.0);
    __syncthreads();
  }
}

// Adds f(v) for each 16-byte channel vector v at rows first, first + step,
// ... (`count` of them) of the [rows, C] matrix x, kStatsUnroll loads in
// flight before their arithmetic.
template <typename T, typename F>
__device__ __forceinline__ void stats_rows(const T* __restrict__ x, int first,
                                           int count, int step, int C, F f) {
  int i = 0, r = first;
  for (; i + kStatsUnroll <= count;
       i += kStatsUnroll, r += kStatsUnroll * step) {
    uint4 v[kStatsUnroll];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u)
      v[u] = load16(x + (r + u * step) * C);
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) f(v[u]);
  }
  for (; i < count; ++i, r += step) f(load16(x + r * C));
}

// The inverse standard deviation rsqrt(var + eps), var + eps rounded to
// f32 as the plain version adds them, the root taken in f64.
__device__ __forceinline__ float inv_std(float var) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(var + kBnEps)));
}

// Grid (P blocks, launched cooperatively), block 256.  Thread g of block b
// owns channel vector cv and rows b*G + g, (b + P)*G + g, ... of the
// N*H*W rows; it sums them in f32.  f32 x: the centered two-pass variance
// (sum x; barrier; the finishers write mean; barrier; sum (x - mean)^2
// over the same rows in reverse, so the second pass starts on the rows
// the first read last, which the L2 still holds; barrier; the finishers
// write var and inv).  bf16 x: one pass of sum x and sum x^2, then
// var = max(E[x^2] - mean^2, 0), NaN kept.  stats is f32 [3, C]: mean,
// biased var, inv.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads, kStatsMinBlocks)
    stats_kernel(const T* __restrict__ x, double* __restrict__ partial,
                 float* __restrict__ stats, int rows, int C,
                 unsigned long long* __restrict__ executed) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(executed, 1ull);
  constexpr int V = Vec<T>::kN;
  constexpr bool kTwoPass = sizeof(T) == 4;
  __shared__ __align__(16) float red[2 * kStatsThreads * V];
  __shared__ double lanes[kStatsThreads];
  const Lane l = lane_of<V>(C);
  const int step = gridDim.x * l.G, first = blockIdx.x * l.G + l.g;
  const int count = l.g < l.G && first < rows ? (rows - 1 - first) / step + 1
                                              : 0;
  const T* xc = x + l.cv * V;
  double* mine = partial + static_cast<size_t>(blockIdx.x) * 2 * C;
  float* mean = stats;
  float* var = stats + C;
  float* inv = stats + 2 * C;
  const double n = static_cast<double>(rows);
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  stats_rows<T>(xc, first, count, step, C, [&](const uint4& v) {
    float f[V];
    Vec<T>::unpack(v, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[j] += f[j];
      if constexpr (!kTwoPass) s2[j] = fmaf(f[j], f[j], s2[j]);
    }
  });
  stats_block_partial<V>(s1, s2, l, C, 0, kTwoPass ? 1 : 2, mine, red);
  cooperative_groups::this_grid().sync();
  if constexpr (!kTwoPass) {
    stats_finish(partial, C, 0, 2, lanes, [&](int c, double a, double b) {
      const double m = a / n;
      double v = b / n - m * m;
      v = v < 0.0 ? 0.0 : v;
      const float vf = static_cast<float>(v);
      mean[c] = static_cast<float>(m);
      var[c] = vf;
      inv[c] = inv_std(vf);
    });
  } else {
    stats_finish(partial, C, 0, 1, lanes, [&](int c, double a, double) {
      mean[c] = static_cast<float>(a / n);
    });
    cooperative_groups::this_grid().sync();
    float mu[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = l.g < l.G ? __ldcg(mean + l.cv * V + j) : 0.0f;
      s2[j] = 0.0f;
    }
    const auto squares = [&](const uint4& v) {
      float f[V];
      Vec<T>::unpack(v, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(f[j], mu[j]);
        s2[j] = fmaf(d, d, s2[j]);
      }
    };
    stats_rows<T>(xc, first + (count - 1) * step, count, -step, C, squares);
    stats_block_partial<V>(s1, s2, l, C, 1, 2, mine, red);
    cooperative_groups::this_grid().sync();
    stats_finish(partial, C, 1, 2, lanes, [&](int c, double a, double) {
      const float vf = static_cast<float>(a / n);
      var[c] = vf;
      inv[c] = inv_std(vf);
    });
  }
}

// ---------------------------------------------------------------------------
// Forward: normalize -> ReLU -> 2x2 max pool
// ---------------------------------------------------------------------------

template <int V>
struct PoolChannels {
  float mean[V], inv[V], gm[V], bt[V];
};

// One window of a thread's channel vector, from its four x vectors (order
// 00, 01, 10, 11): the residual xhat = (x - mean) * inv and
// z = act(act(xhat) * gamma + beta), each product and sum rounded apart (no
// fused multiply-add, as the plain version's separate operators round
// them), y = max(z, 0) with NaN kept (clamp_min), and the window's maximum
// taken as max_pool2d takes it: the first strictly greater y, or a NaN.
template <typename T>
__device__ __forceinline__ void window_norm_pool(
    const uint4 (&xv)[4], const PoolChannels<Vec<T>::kN>& k,
    uint4 (&xhat)[4], uint4& pooled) {
  constexpr int V = Vec<T>::kN;
  float x[4][V], h[4][V], p[V];
#pragma unroll
  for (int q = 0; q < 4; ++q) Vec<T>::unpack(xv[q], x[q]);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float m = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[q][j] = __fmul_rn(__fsub_rn(x[q][j], k.mean[j]), k.inv[j]);
      const float xa = to_f32<T>(from_f32<T>(h[q][j]));
      const float z =
          to_f32<T>(from_f32<T>(__fadd_rn(__fmul_rn(xa, k.gm[j]), k.bt[j])));
      const float y = isnan(z) ? z : fmaxf(z, 0.0f);
      if (y > m || isnan(y)) m = y;
    }
    p[j] = m;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) xhat[q] = Vec<T>::pack(h[q]);
  pooled = Vec<T>::pack(p);
}

// The dx kernel's grid and walk (DxGrid, launch_norm_pool): lane l of
// block (t, k) owns channel vector k*L + l, group g takes windows
// t*per*G + g + i*G of tile t.  bf16 tiles run last to first: the
// statistics' one pass read x front to back, so the L2 holds its end; the
// f32 statistics' second pass ran back to front, so tiles run in order.
// x is read for the last time (evict-first); xhat is stored evict-first
// (the backward reads it long after), the pooled output plainly (the next
// convolution reads it).
template <typename T>
__global__ void __launch_bounds__(kDxMaxThreads)
    norm_pool_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ xhat,
                     T* __restrict__ pooled, DxGrid d,
                     unsigned long long* __restrict__ executed) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0)
    atomicAdd(executed, 1ull);
  constexpr int V = Vec<T>::kN;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= d.C) return;
  const int G = blockDim.y, Wo = d.W / 2;
  const int tile = sizeof(T) == 4 ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int first = tile * d.per * G;
  const int end = min(d.windows, first + d.per * G);
  PoolChannels<V> k;
  load_channels<V>(mean + c0, k.mean);
  load_channels<V>(inv + c0, k.inv);
  load_channels<V>(gamma + c0, k.gm);
  load_channels<V>(beta + c0, k.bt);
  int w = first + threadIdx.y;
  int r = w / Wo, wo = w - r * Wo;
  while (w < end) {
    uint4 xv[kPoolWindows][4];
    int xo[kPoolWindows], po[kPoolWindows];
    bool live[kPoolWindows];
#pragma unroll
    for (int u = 0; u < kPoolWindows; ++u) {
      xo[u] = (2 * r * d.W + 2 * wo) * d.C + c0;
      po[u] = w * d.C + c0;
      live[u] = w < end;
      if (live[u]) {
        const T* xq = x + xo[u];
        xv[u][0] = load16_last(xq);
        xv[u][1] = load16_last(xq + d.C);
        xv[u][2] = load16_last(xq + d.W * d.C);
        xv[u][3] = load16_last(xq + d.W * d.C + d.C);
      }
      w += G;
      r += d.step_r;
      wo += d.step_w;
      if (wo >= Wo) {
        wo -= Wo;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kPoolWindows; ++u) {
      if (!live[u]) break;
      uint4 h[4], p;
      window_norm_pool<T>(xv[u], k, h, p);
      T* o = xhat + xo[u];
      __stcs(reinterpret_cast<uint4*>(o), h[0]);
      __stcs(reinterpret_cast<uint4*>(o + d.C), h[1]);
      __stcs(reinterpret_cast<uint4*>(o + d.W * d.C), h[2]);
      __stcs(reinterpret_cast<uint4*>(o + d.W * d.C + d.C), h[3]);
      *reinterpret_cast<uint4*>(pooled + po[u]) = p;
    }
  }
}

template <typename T>
int launch_sums(const void* xhat, const void* dp, const void* gamma,
                const void* beta, void* partial, void* sums, int N, int H,
                int W, int C, int blocks, void* executed, void* stream) {
  const T* x = static_cast<const T*>(xhat);
  const T* d = static_cast<const T*>(dp);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(sums);
  int rows = N * (H / 2);
  unsigned long long* ran = static_cast<unsigned long long*>(executed);
  void* args[] = {&x, &d, &g, &b, &part, &out, &rows, &W, &C, &ran};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sums_kernel<T>), dim3(blocks),
      dim3(kSumThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The grid of the dx and norm_pool kernels from their partition
// (ops/bnpool.py::dx_partition, norm_pool_partition): blocks of `threads`
// threads, L = min(C/V, threads) lanes by G = threads/L groups, and
// `blocks` = tiles * chunks, chunks = ceil(C/V / L).  False where
// (threads, blocks) is no such partition.
template <typename T>
bool window_grid(int N, int H, int W, int C, int threads, int blocks,
                 DxGrid* d, dim3* grid, dim3* block) {
  const int CV = C / Vec<T>::kN;
  if (threads < 1 || threads > kDxMaxThreads || CV < 1) return false;
  const int L = min(CV, threads), G = threads / L;
  const int chunks = (CV + L - 1) / L;
  if (blocks < chunks || blocks % chunks) return false;
  const int tiles = blocks / chunks;
  d->W = W;
  d->C = C;
  d->windows = N * (H / 2) * (W / 2);
  d->per = (d->windows + G * tiles - 1) / (G * tiles);
  d->step_r = G / (W / 2);
  d->step_w = G % (W / 2);
  d->n = static_cast<float>(N * H * W);
  *grid = dim3(tiles, chunks);
  *block = dim3(L, G);
  return true;
}

template <typename T>
int launch_dx(const void* xhat, const void* dp, const void* gamma,
              const void* beta, const void* inv, const void* sums, void* dx,
              int N, int H, int W, int C, int threads, int blocks,
              void* executed, void* stream) {
  DxGrid d;
  dim3 grid, block;
  if (!window_grid<T>(N, H, W, C, threads, blocks, &d, &grid, &block))
    return static_cast<int>(cudaErrorInvalidValue);
  dx_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xhat), static_cast<const T*>(dp),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(inv), static_cast<const float*>(sums),
      static_cast<T*>(dx), d, static_cast<unsigned long long*>(executed));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stats(const void* x, void* partial, void* stats, int N, int H,
                 int W, int C, int blocks, void* executed, void* stream) {
  const T* xp = static_cast<const T*>(x);
  double* part = static_cast<double*>(partial);
  float* out = static_cast<float*>(stats);
  int rows = N * H * W;
  unsigned long long* ran = static_cast<unsigned long long*>(executed);
  void* args[] = {&xp, &part, &out, &rows, &C, &ran};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stats_kernel<T>), dim3(blocks),
      dim3(kStatsThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_norm_pool(const void* x, const void* mean, const void* inv,
                     const void* gamma, const void* beta, void* xhat,
                     void* pooled, int N, int H, int W, int C, int threads,
                     int blocks, void* executed, void* stream) {
  DxGrid d;
  dim3 grid, block;
  if (!window_grid<T>(N, H, W, C, threads, blocks, &d, &grid, &block))
    return static_cast<int>(cudaErrorInvalidValue);
  norm_pool_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(xhat),
      static_cast<T*>(pooled), d,
      static_cast<unsigned long long*>(executed));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Pointers are device pointers of channels_last (NHWC)
// tensors; gamma, beta, mean, inv are f32 [C]; sums is f32 [2, C]; stats
// is f32 [3, C] (mean, biased var, inv).  Every kernel needs C a multiple of 16
// bytes' worth of channels and every pointer 16-byte aligned.  The sums
// kernel also takes partial, f32 [blocks, 2, C] scratch, and the stats
// kernel f64 [blocks, 2, C]; both take the grid (`blocks`, no more than
// the card holds at once) and need at most 256 channel vectors.  The dx
// and norm_pool kernels take their partition (`threads`, `blocks`; an
// invalid one returns cudaErrorInvalidValue).  `executed` points to a
// device u64 that the kernel increments once a run.  Each returns the
// launch's error, else cudaGetLastError() after it (0 on success);
// cuda_error_string names a nonzero code.
extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bnpool_sums_f32(const void* xhat, const void* dp, const void* gamma,
                    const void* beta, void* partial, void* sums, int N, int H,
                    int W, int C, int blocks, void* executed, void* stream) {
  return launch_sums<float>(xhat, dp, gamma, beta, partial, sums, N, H, W, C,
                            blocks, executed, stream);
}

int bnpool_sums_bf16(const void* xhat, const void* dp, const void* gamma,
                     const void* beta, void* partial, void* sums, int N,
                     int H, int W, int C, int blocks, void* executed,
                     void* stream) {
  return launch_sums<__nv_bfloat16>(xhat, dp, gamma, beta, partial, sums, N,
                                    H, W, C, blocks, executed, stream);
}

int bnpool_dx_f32(const void* xhat, const void* dp, const void* gamma,
                  const void* beta, const void* inv, const void* sums,
                  void* dx, int N, int H, int W, int C, int threads,
                  int blocks, void* executed, void* stream) {
  return launch_dx<float>(xhat, dp, gamma, beta, inv, sums, dx, N, H, W, C,
                          threads, blocks, executed, stream);
}

int bnpool_dx_bf16(const void* xhat, const void* dp, const void* gamma,
                   const void* beta, const void* inv, const void* sums,
                   void* dx, int N, int H, int W, int C, int threads,
                   int blocks, void* executed, void* stream) {
  return launch_dx<__nv_bfloat16>(xhat, dp, gamma, beta, inv, sums, dx, N, H,
                                  W, C, threads, blocks, executed, stream);
}

int bnpool_stats_f32(const void* x, void* partial, void* stats, int N, int H,
                     int W, int C, int blocks, void* executed, void* stream) {
  return launch_stats<float>(x, partial, stats, N, H, W, C, blocks, executed,
                             stream);
}

int bnpool_stats_bf16(const void* x, void* partial, void* stats, int N, int H,
                      int W, int C, int blocks, void* executed, void* stream) {
  return launch_stats<__nv_bfloat16>(x, partial, stats, N, H, W, C, blocks,
                                     executed, stream);
}

int bnpool_norm_pool_f32(const void* x, const void* mean, const void* inv,
                         const void* gamma, const void* beta, void* xhat,
                         void* pooled, int N, int H, int W, int C, int threads,
                         int blocks, void* executed, void* stream) {
  return launch_norm_pool<float>(x, mean, inv, gamma, beta, xhat, pooled, N, H,
                                 W, C, threads, blocks, executed, stream);
}

int bnpool_norm_pool_bf16(const void* x, const void* mean, const void* inv,
                          const void* gamma, const void* beta, void* xhat,
                          void* pooled, int N, int H, int W, int C,
                          int threads, int blocks, void* executed,
                          void* stream) {
  return launch_norm_pool<__nv_bfloat16>(x, mean, inv, gamma, beta, xhat,
                                         pooled, N, H, W, C, threads, blocks,
                                         executed, stream);
}

}  // extern "C"
