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
// Bound: both are memory-bound elementwise passes (about 15 f32 operations
// per element against 4-8 bytes moved).  Per element of xhat [N,H,W,C] at
// f32, phase 1 reads xhat and dP (4 * 1.25 bytes), phase 2 reads them again
// and writes dx (4 * 2.25 bytes): 14 bytes per element for the pair, about
// 448 MB per VGG-11 step at batch 256, or 134 us at 3.35 TB/s.
//
// Design, and what it does about the bound:
//   * Layout is channels_last (NHWC in memory): C is contiguous, so one
//     thread owns one (n, h/2, w/2, c) pool window and neighbouring threads
//     take neighbouring channels — every load and store of a warp is one
//     contiguous 128-byte (f32) run.  The TPU kernel's lane-merged
//     [.., W/2, 2C] view was a vector-register trick and is not carried over.
//   * Phase 1 cannot carry a running sum across blocks as the TPU's
//     sequential grid did: blocks run in parallel and in no order.  Pass A
//     writes one [2, C] partial per block row into a scratch buffer, pass B
//     reduces the partials in a fixed order.  No float atomics, so the sums
//     are bitwise reproducible from run to run.
//   * The routing compares values rounded to the activation dtype and
//     rebuilds z = act(xhat * gamma + beta) with a separately rounded
//     product and sum (__fmul_rn, __fadd_rn: no fused multiply-add), which
//     is how the port's PyTorch forward computed the z its pool compared.
//   * Arithmetic is f32 for both residual dtypes (float, __nv_bfloat16).
// Simple and right first: no shared-memory staging, no vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChanTile = 32;   // threads along C in a sums block
constexpr int kWinRows = 8;     // windows per sums block row
constexpr int kFinalThreads = 128;
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

// Pass A: grid (ceil(C/32), nparts), block (32, 8).  Block row `blockIdx.y`
// strides over the windows; its per-channel sums land in
// partial[blockIdx.y][k][c] (k = 0: sum dy, k = 1: sum dy*xhat).
template <typename T>
__global__ void __launch_bounds__(kChanTile* kWinRows)
    sums_partial_kernel(const T* __restrict__ xhat, const T* __restrict__ dp,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        float* __restrict__ partial, int N, int H, int W,
                        int C) {
  __shared__ float red[2][kWinRows][kChanTile];
  const int c = blockIdx.x * kChanTile + threadIdx.x;
  const int nwin = N * (H / 2) * (W / 2);
  float s_dy = 0.0f, s_dyx = 0.0f;
  if (c < C) {
    const float g = gamma[c], b = beta[c];
    for (int wi = blockIdx.y * kWinRows + threadIdx.y; wi < nwin;
         wi += gridDim.y * kWinRows) {
      const Offsets o = window_offsets(wi, c, H, W, C);
      const Window w = route<T>(xhat, dp, o, wi, c, C, g, b);
      s_dy += ((w.dy[0] + w.dy[1]) + w.dy[2]) + w.dy[3];
      s_dyx += w.dy[0] * w.x[0] + w.dy[1] * w.x[1] + w.dy[2] * w.x[2] +
               w.dy[3] * w.x[3];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s_dy;
  red[1][threadIdx.y][threadIdx.x] = s_dyx;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.0f, s = 0.0f;
    for (int k = 0; k < kWinRows; ++k) {
      a += red[0][k][threadIdx.x];
      s += red[1][k][threadIdx.x];
    }
    partial[(blockIdx.y * 2 + 0) * C + c] = a;
    partial[(blockIdx.y * 2 + 1) * C + c] = s;
  }
}

// Pass B: one block per output (k, c); a fixed strided split over the
// partials and a fixed tree, so the result does not depend on timing.
__global__ void __launch_bounds__(kFinalThreads)
    sums_final_kernel(const float* __restrict__ partial,
                      float* __restrict__ sums, int nparts, int C) {
  __shared__ float red[kFinalThreads];
  const int k = blockIdx.x / C, c = blockIdx.x - (blockIdx.x / C) * C;
  float acc = 0.0f;
  for (int p = threadIdx.x; p < nparts; p += kFinalThreads)
    acc += partial[(p * 2 + k) * C + c];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[k * C + c] = red[0];
}

// Phase 2: one thread per (window, channel), channel fastest.
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
                int W, int C, int nparts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kChanTile, kWinRows);
  const dim3 grid((C + kChanTile - 1) / kChanTile, nparts);
  sums_partial_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(xhat), static_cast<const T*>(dp),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(partial), N, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sums_final_kernel<<<2 * C, kFinalThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), nparts,
      C);
  return static_cast<int>(cudaGetLastError());
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
// tensors; gamma, beta, inv are f32 [C]; sums is f32 [2, C]; partial is f32
// [nparts, 2, C] scratch.  Each returns cudaGetLastError() after its
// launches (0 on success); cuda_error_string names a nonzero code.
extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bnpool_sums_f32(const void* xhat, const void* dp, const void* gamma,
                    const void* beta, void* partial, void* sums, int N, int H,
                    int W, int C, int nparts, void* stream) {
  return launch_sums<float>(xhat, dp, gamma, beta, partial, sums, N, H, W, C,
                            nparts, stream);
}

int bnpool_sums_bf16(const void* xhat, const void* dp, const void* gamma,
                     const void* beta, void* partial, void* sums, int N, int H,
                     int W, int C, int nparts, void* stream) {
  return launch_sums<__nv_bfloat16>(xhat, dp, gamma, beta, partial, sums, N,
                                    H, W, C, nparts, stream);
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
