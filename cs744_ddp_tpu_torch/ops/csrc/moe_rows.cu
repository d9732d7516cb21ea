// The expert layer's row-wise work (ops/moe.py RoutedExperts), hand-written
// for Hopper (sm_90a).  Built by ops/_build.py with nvcc into a shared
// library with a plain C interface and loaded through ctypes (ops/moe.py).
//
// No TPU kernel corresponds: the JAX package runs no expert layer.  The
// kernels exist because the windowed train path replays one captured CUDA
// graph of the step, so the host never learns how many rows the router
// gave the held experts.  Every row buffer has the static worst case's
// R = tokens x top-k rows (294,912 at the Moonlight cell), of which only
// the first offsets[groups] are held (3-15% there).  The plain PyTorch
// version of this work (gathers, SwiGLU, f32-promoted products, casts and
// f32 index_add_ scatters) runs over all R rows whatever the load; each
// kernel here reads the held count offsets[groups] on the device and does
// nothing for the rows past it, and fuses the passes that touch the same
// rows so that no f32 copy of a row is written out:
//   moe_gather_rows_{bf16,f32}  dst[p] = bf16(src[token[p]]), p < held
//       (the forward's and the backward's x rows, and the backward's
//       dout rows, read in f32 and rounded once);
//   moe_swiglu_rows             h = bf16(bf16(silu(g)) * u) of gu = [g | u];
//   moe_combine_tokens          out[t] = sum_j w[p] * f32(ys[p]) in f32,
//       over token t's slots j in order, p = inv[t*k + j], held p only;
//   moe_combine_token_grads     dx[t] = bf16(sum_j f32(dxs[p])), the same
//       walk unweighted;
//   moe_rows_backward           from gu, the rows' gradient before the
//       router weight (dh_unit) and the weight w: d_weight = sum of
//       f32(dh_unit) * f32(h) (zero for every row past the held ones),
//       hw = bf16(h * w), dgu = [silu_backward(bf16(dh * u), g) |
//       bf16(dh * s)] with dh = bf16(dh_unit * w), s = bf16(silu(g)).
// Every rounding to bf16 is where the plain version rounds (a bf16 by f32
// product rounded in f32, then to bf16; silu and silu_backward in f32 with
// PyTorch's formulas), every sum is f32.  The combines write each token
// row once, in slot order, with no atomics: the result is the same run to
// run.  Rows past the held count are neither read nor written, except
// d_weight's, which are zeroed.
//
// Bound: bytes.  Each held row moves about 61 KB over the seven launches
// of a layer's forward and backward (bf16 rows of 2048 and 2 x 1408), and
// the combines write the tokens' rows (f32 forward, bf16 backward).  What
// keeps a row kernel from the bound is loads in flight: a warp owns a row
// (or a token) and each lane issues 16-byte loads of up to kUnroll vectors
// (the combines: one vector of each of the token's rows) before any
// arithmetic or store.  The grid is static (from the buffer's shape, so a
// graph replays it) and walks the held rows grid-stride: a warp past the
// held count stops after one load of offsets[groups].
//
// Each launch adds, from thread 0 of block 0, the held rows and the
// buffer's static rows to two adjacent u64 device counters (`counter`,
// ops/moe.py's row_rows and row_capacity), so a graph's replays count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarp = 32;
constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / kWarp;
constexpr int kVec = 8;                  // bf16 elements in 16 bytes
constexpr int kUnroll = 4;               // vectors a lane has in flight
constexpr int kMaxTopK = 8;              // slots a token, at most

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's silu and its backward in f32 (ActivationSiluKernel.cu).
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float silu_backward(float dy, float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return dy * s * (1.0f + x * (1.0f - s));
}

// Eight elements of a row as bf16: a bf16 row is copied bit for bit, an
// f32 row rounded once.
__device__ __forceinline__ uint4 load_bf16x8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 load_bf16x8(const float* p) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  const float f[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return pack(f);
}

__device__ __forceinline__ void store_vec(bf16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void count_rows(unsigned long long* counter,
                                           int held, int rows) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(counter, static_cast<unsigned long long>(held));
    atomicAdd(counter + 1, static_cast<unsigned long long>(rows));
  }
}

__device__ __forceinline__ int first_warp() {
  return blockIdx.x * kWarps + threadIdx.x / kWarp;
}

__device__ __forceinline__ int all_warps() { return gridDim.x * kWarps; }

template <typename Src>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const Src* __restrict__ src,
                       const int64_t* __restrict__ token,
                       const int* __restrict__ offsets, int groups,
                       bf16* __restrict__ dst, int rows, int width,
                       unsigned long long* counter) {
  const int held = offsets[groups];
  count_rows(counter, held, rows);
  const int vecs = width / kVec;
  const int lane = threadIdx.x % kWarp;
  for (int r = first_warp(); r < held; r += all_warps()) {
    const Src* from = src + token[r] * static_cast<int64_t>(width);
    bf16* to = dst + static_cast<int64_t>(r) * width;
    for (int c0 = lane; c0 < vecs; c0 += kWarp * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c < vecs) v[u] = load_bf16x8(from + c * kVec);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c < vecs) store_vec(to + c * kVec, v[u]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    swiglu_rows_kernel(const bf16* __restrict__ gu,
                       const int* __restrict__ offsets, int groups,
                       bf16* __restrict__ h, int rows, int width,
                       unsigned long long* counter) {
  const int held = offsets[groups];
  count_rows(counter, held, rows);
  const int vecs = width / kVec;
  const int lane = threadIdx.x % kWarp;
  for (int r = first_warp(); r < held; r += all_warps()) {
    const bf16* g_row = gu + static_cast<int64_t>(r) * 2 * width;
    const bf16* u_row = g_row + width;
    bf16* h_row = h + static_cast<int64_t>(r) * width;
    for (int c0 = lane; c0 < vecs; c0 += kWarp * kUnroll) {
      uint4 gv[kUnroll], uv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c < vecs) {
          gv[u] = load_bf16x8(g_row + c * kVec);
          uv[u] = load_bf16x8(u_row + c * kVec);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c >= vecs) continue;
        float g[kVec], up[kVec], out[kVec];
        unpack(gv[u], g);
        unpack(uv[u], up);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          out[e] = __fmul_rn(round_bf16(silu(g[e])), up[e]);
        store_vec(h_row + c * kVec, pack(out));
      }
    }
  }
}

// The combines: one warp a token, its slots' sorted positions loaded once,
// then for each 8-element vector of the row one load from each held slot's
// row before the f32 sum in slot order.  kForward: weighted by the rows'
// router weights, written in f32; else unweighted, rounded to bf16.
template <bool kForward>
__global__ void __launch_bounds__(kThreads)
    combine_tokens_kernel(const bf16* __restrict__ rows_in,
                          const float* __restrict__ weight,
                          const int* __restrict__ inv,
                          const int* __restrict__ offsets, int groups,
                          void* __restrict__ out, int tokens, int k,
                          int width, unsigned long long* counter) {
  const int held = offsets[groups];
  count_rows(counter, held, tokens * k);
  const int vecs = width / kVec;
  const int lane = threadIdx.x % kWarp;
  for (int t = first_warp(); t < tokens; t += all_warps()) {
    int pos[kMaxTopK];
    float w[kMaxTopK];
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      pos[j] = j < k ? inv[static_cast<int64_t>(t) * k + j] : held;
      w[j] = kForward && pos[j] < held ? weight[pos[j]] : 1.0f;
    }
    for (int c = lane; c < vecs; c += kWarp) {
      uint4 v[kMaxTopK];
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j)
        if (pos[j] < held)
          v[j] = load_bf16x8(rows_in + static_cast<int64_t>(pos[j]) * width +
                             c * kVec);
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j) {
        if (pos[j] >= held) continue;
        float f[kVec];
        unpack(v[j], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] = __fadd_rn(acc[e], kForward ? __fmul_rn(f[e], w[j]) : f[e]);
      }
      const int64_t at = static_cast<int64_t>(t) * width + c * kVec;
      if (kForward) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        store_vec(static_cast<bf16*>(out) + at, pack(acc));
      }
    }
  }
}

constexpr int kBackwardUnroll = 2;

__global__ void __launch_bounds__(kThreads)
    rows_backward_kernel(const bf16* __restrict__ gu,
                         const bf16* __restrict__ dh_unit,
                         const float* __restrict__ weight,
                         const int* __restrict__ offsets, int groups,
                         float* __restrict__ d_weight,
                         bf16* __restrict__ hw, bf16* __restrict__ dgu,
                         int rows, int width,
                         unsigned long long* counter) {
  const int held = offsets[groups];
  count_rows(counter, held, rows);
  const int vecs = width / kVec;
  const int lane = threadIdx.x % kWarp;
  for (int r = first_warp(); r < held; r += all_warps()) {
    const int64_t row = static_cast<int64_t>(r);
    const bf16* g_row = gu + row * 2 * width;
    const bf16* u_row = g_row + width;
    const bf16* d_row = dh_unit + row * width;
    bf16* hw_row = hw + row * width;
    bf16* dg_row = dgu + row * 2 * width;
    bf16* du_row = dg_row + width;
    const float w = weight[r];
    float dot = 0.0f;
    for (int c0 = lane; c0 < vecs; c0 += kWarp * kBackwardUnroll) {
      uint4 gv[kBackwardUnroll], uv[kBackwardUnroll], dv[kBackwardUnroll];
#pragma unroll
      for (int u = 0; u < kBackwardUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c < vecs) {
          gv[u] = load_bf16x8(g_row + c * kVec);
          uv[u] = load_bf16x8(u_row + c * kVec);
          dv[u] = load_bf16x8(d_row + c * kVec);
        }
      }
#pragma unroll
      for (int u = 0; u < kBackwardUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c >= vecs) continue;
        float g[kVec], up[kVec], d[kVec], hw_v[kVec], dg[kVec], du[kVec];
        unpack(gv[u], g);
        unpack(uv[u], up);
        unpack(dv[u], d);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float s = round_bf16(silu(g[e]));
          const float h = round_bf16(__fmul_rn(s, up[e]));
          dot = __fadd_rn(dot, __fmul_rn(d[e], h));
          hw_v[e] = __fmul_rn(h, w);
          const float dh = round_bf16(__fmul_rn(d[e], w));
          du[e] = __fmul_rn(dh, s);
          dg[e] = silu_backward(round_bf16(__fmul_rn(dh, up[e])), g[e]);
        }
        store_vec(hw_row + c * kVec, pack(hw_v));
        store_vec(dg_row + c * kVec, pack(dg));
        store_vec(du_row + c * kVec, pack(du));
      }
    }
#pragma unroll
    for (int step = kWarp / 2; step > 0; step /= 2)
      dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, step));
    if (lane == 0) d_weight[r] = dot;
  }
  for (int p = held + blockIdx.x * kThreads + threadIdx.x; p < rows;
       p += gridDim.x * kThreads)
    d_weight[p] = 0.0f;
}

bool bad_launch(int rows, int width, int blocks) {
  return rows < 0 || width <= 0 || width % kVec != 0 || blocks <= 0;
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

unsigned long long* as_counter(void* counter) {
  return static_cast<unsigned long long*>(counter);
}

template <typename Src>
int launch_gather(const void* src, const void* token, const void* offsets,
                  int groups, void* dst, int rows, int width, int blocks,
                  void* counter, void* stream) {
  if (bad_launch(rows, width, blocks)) return cudaErrorInvalidValue;
  gather_rows_kernel<Src><<<blocks, kThreads, 0, as_stream(stream)>>>(
      static_cast<const Src*>(src), static_cast<const int64_t*>(token),
      static_cast<const int*>(offsets), groups, static_cast<bf16*>(dst),
      rows, width, as_counter(counter));
  return cudaGetLastError();
}

template <bool kForward>
int launch_combine(const void* rows_in, const void* weight, const void* inv,
                   const void* offsets, int groups, void* out, int tokens,
                   int k, int width, int blocks, void* counter,
                   void* stream) {
  if (bad_launch(tokens, width, blocks) || k <= 0 || k > kMaxTopK)
    return cudaErrorInvalidValue;
  combine_tokens_kernel<kForward><<<blocks, kThreads, 0, as_stream(stream)>>>(
      static_cast<const bf16*>(rows_in), static_cast<const float*>(weight),
      static_cast<const int*>(inv), static_cast<const int*>(offsets), groups,
      out, tokens, k, width, as_counter(counter));
  return cudaGetLastError();
}

}  // namespace

// C interface.  Pointers are device pointers of contiguous tensors, each
// 16-byte aligned: src [tokens, width] (bf16 or f32), token int64 [rows],
// offsets int32 [groups + 1] (offsets[groups] the held rows), every row
// buffer bf16 [rows, width] (gu and dgu [rows, 2 x width]), weight and
// d_weight f32 [rows], inv int32 [tokens x k] (the sorted position of flat
// row t*k + j), the forward combine's out f32 and the backward's dx bf16
// [tokens, width].  width is a multiple of 8, k at most 8, `blocks` the
// grid (256 threads a block, one row or token a warp).  `counter` points to
// two device u64s (held rows, static rows).  Each returns the launch's
// error, else cudaGetLastError() after it (0 on success);
// cuda_error_string names a nonzero code.
extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int moe_gather_rows_bf16(const void* src, const void* token,
                         const void* offsets, int groups, void* dst, int rows,
                         int width, int blocks, void* counter, void* stream) {
  return launch_gather<bf16>(src, token, offsets, groups, dst, rows, width,
                             blocks, counter, stream);
}

int moe_gather_rows_f32(const void* src, const void* token,
                        const void* offsets, int groups, void* dst, int rows,
                        int width, int blocks, void* counter, void* stream) {
  return launch_gather<float>(src, token, offsets, groups, dst, rows, width,
                              blocks, counter, stream);
}

int moe_swiglu_rows(const void* gu, const void* offsets, int groups, void* h,
                    int rows, int width, int blocks, void* counter,
                    void* stream) {
  if (bad_launch(rows, width, blocks)) return cudaErrorInvalidValue;
  swiglu_rows_kernel<<<blocks, kThreads, 0, as_stream(stream)>>>(
      static_cast<const bf16*>(gu), static_cast<const int*>(offsets), groups,
      static_cast<bf16*>(h), rows, width, as_counter(counter));
  return cudaGetLastError();
}

int moe_combine_tokens(const void* ys, const void* weight, const void* inv,
                       const void* offsets, int groups, void* out, int tokens,
                       int k, int width, int blocks, void* counter,
                       void* stream) {
  return launch_combine<true>(ys, weight, inv, offsets, groups, out, tokens,
                              k, width, blocks, counter, stream);
}

int moe_combine_token_grads(const void* dxs, const void* inv,
                            const void* offsets, int groups, void* dx,
                            int tokens, int k, int width, int blocks,
                            void* counter, void* stream) {
  return launch_combine<false>(dxs, nullptr, inv, offsets, groups, dx,
                               tokens, k, width, blocks, counter, stream);
}

int moe_rows_backward(const void* gu, const void* dh_unit, const void* weight,
                      const void* offsets, int groups, void* d_weight,
                      void* hw, void* dgu, int rows, int width, int blocks,
                      void* counter, void* stream) {
  if (bad_launch(rows, width, blocks)) return cudaErrorInvalidValue;
  rows_backward_kernel<<<blocks, kThreads, 0, as_stream(stream)>>>(
      static_cast<const bf16*>(gu), static_cast<const bf16*>(dh_unit),
      static_cast<const float*>(weight), static_cast<const int*>(offsets),
      groups, static_cast<float*>(d_weight), static_cast<bf16*>(hw),
      static_cast<bf16*>(dgu), rows, width, as_counter(counter));
  return cudaGetLastError();
}

}  // extern "C"
