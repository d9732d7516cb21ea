// Fused BatchNorm -> ReLU -> MaxPool2x2 backward, hand-written for Hopper
// (sm_90a).  Built by ops/_build.py with nvcc into a shared library with a
// plain C interface and loaded through ctypes (ops/bnpool.py).
//
// What each function replaces (cs744_ddp_tpu/ops/bnpool_pallas.py):
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
// Phase 2 (bnpool_dx): one thread per (window, channel), scalar loads.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kFinalUnroll = 4;   // partials in flight per finishing thread
constexpr int kSumMinBlocks = 4;  // resident sums blocks per SM to aim for
constexpr int kFinishers = 32;    // sums blocks that add up the partials
constexpr int kDxThreads = 256;

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
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// One pool window of one channel: the four xhat values (f32) and the routed,
// gated gradients, in window order 00, 01, 10, 11.
struct Window {
  float x[4];
  float dy[4];
};

// Element offsets of the window's four inputs in an NHWC tensor.
struct Offsets {
  int q[4];
};

__device__ __forceinline__ Offsets window_offsets(int wi, int c, int H, int W,
                                                  int C) {
  const int Ho = H / 2, Wo = W / 2;
  const int n = wi / (Ho * Wo);
  const int r = wi - n * (Ho * Wo);
  const int ho = r / Wo, wo = r - (r / Wo) * Wo;
  Offsets o;
  o.q[0] = ((n * H + 2 * ho) * W + 2 * wo) * C + c;
  o.q[1] = o.q[0] + C;
  o.q[2] = o.q[0] + W * C;
  o.q[3] = o.q[2] + C;
  return o;
}

template <typename T>
__device__ __forceinline__ Window route(const T* __restrict__ xhat,
                                        const T* __restrict__ dp,
                                        const Offsets& o, int wi, int c, int C,
                                        float g, float b) {
  Window w;
  float z[4], y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w.x[q] = to_f32<T>(xhat[o.q[q]]);
    z[q] = to_f32<T>(from_f32<T>(__fadd_rn(__fmul_rn(w.x[q], g), b)));
    y[q] = fmaxf(z[q], 0.0f);
  }
  const float wmax = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
  const float p = to_f32<T>(dp[wi * C + c]);
  bool taken = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool hit = (y[q] == wmax) && !taken;
    taken = taken || hit;
    w.dy[q] = (hit && z[q] > 0.0f) ? p : 0.0f;
  }
  return w;
}

// ---------------------------------------------------------------------------
// Phase 1
// ---------------------------------------------------------------------------

// Routes one window of a thread's channel vector and adds it to the sums.
// The window's p goes to one element only, k = the first maximal y, and
// only if z_k > 0; as y_k = max(z_k, 0) is the window's maximum, that gate
// is wmax > 0.  So the sums need x_k and the gate, not the four dy that
// route() builds for dx: the same routing in about half the instructions.
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
                float* __restrict__ sums, int rows, int W, int C) {
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
// Phase 2: one thread per (window, channel), channel fastest.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
    dx_kernel(const T* __restrict__ xhat, const T* __restrict__ dp,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ inv, const float* __restrict__ sums,
              T* __restrict__ dx, int N, int H, int W, int C) {
  const int total = N * (H / 2) * (W / 2) * C;
  const float n = static_cast<float>(N * H * W);
  for (int e = blockIdx.x * kDxThreads + threadIdx.x; e < total;
       e += gridDim.x * kDxThreads) {
    const int wi = e / C, c = e - (e / C) * C;
    const Offsets o = window_offsets(wi, c, H, W, C);
    const Window w = route<T>(xhat, dp, o, wi, c, C, gamma[c], beta[c]);
    const float scale = gamma[c] * inv[c] * (1.0f / n);
    const float s_dy = sums[c], s_dyx = sums[C + c];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dx[o.q[q]] = from_f32<T>(scale * (n * w.dy[q] - s_dy - w.x[q] * s_dyx));
  }
}

template <typename T>
int launch_sums(const void* xhat, const void* dp, const void* gamma,
                const void* beta, void* partial, void* sums, int N, int H,
                int W, int C, int blocks, void* stream) {
  const T* x = static_cast<const T*>(xhat);
  const T* d = static_cast<const T*>(dp);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(sums);
  int rows = N * (H / 2);
  void* args[] = {&x, &d, &g, &b, &part, &out, &rows, &W, &C};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sums_kernel<T>), dim3(blocks),
      dim3(kSumThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_dx(const void* xhat, const void* dp, const void* gamma,
              const void* beta, const void* inv, const void* sums, void* dx,
              int N, int H, int W, int C, void* stream) {
  const int total = N * (H / 2) * (W / 2) * C;
  const int blocks = (total + kDxThreads - 1) / kDxThreads;
  dx_kernel<T><<<blocks, kDxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xhat), static_cast<const T*>(dp),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(inv), static_cast<const float*>(sums),
      static_cast<T*>(dx), N, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Pointers are device pointers of channels_last (NHWC)
// tensors; gamma, beta, inv are f32 [C]; sums is f32 [2, C].  The sums
// kernel also takes partial, f32 [blocks, 2, C] scratch, and the grid
// (`blocks`, no more than the card holds at once).  It needs C a multiple
// of 16 bytes' worth of channels, at most 256 such vectors, and 16-byte
// aligned xhat, dp, gamma, beta, partial and sums.  Each returns the launch's
// error, else cudaGetLastError() after it (0 on success);
// cuda_error_string names a nonzero code.
extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bnpool_sums_f32(const void* xhat, const void* dp, const void* gamma,
                    const void* beta, void* partial, void* sums, int N, int H,
                    int W, int C, int blocks, void* stream) {
  return launch_sums<float>(xhat, dp, gamma, beta, partial, sums, N, H, W, C,
                            blocks, stream);
}

int bnpool_sums_bf16(const void* xhat, const void* dp, const void* gamma,
                     const void* beta, void* partial, void* sums, int N,
                     int H, int W, int C, int blocks, void* stream) {
  return launch_sums<__nv_bfloat16>(xhat, dp, gamma, beta, partial, sums, N,
                                    H, W, C, blocks, stream);
}

int bnpool_dx_f32(const void* xhat, const void* dp, const void* gamma,
                  const void* beta, const void* inv, const void* sums,
                  void* dx, int N, int H, int W, int C, void* stream) {
  return launch_dx<float>(xhat, dp, gamma, beta, inv, sums, dx, N, H, W, C,
                          stream);
}

int bnpool_dx_bf16(const void* xhat, const void* dp, const void* gamma,
                   const void* beta, const void* inv, const void* sums,
                   void* dx, int N, int H, int W, int C, void* stream) {
  return launch_dx<__nv_bfloat16>(xhat, dp, gamma, beta, inv, sums, dx, N, H,
                                  W, C, stream);
}

}  // extern "C"
