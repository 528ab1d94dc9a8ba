// Fused CANNet context tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel can_tpu/ops/pallas_context.py::_kernel
// (launched by _fused_forward through pl.pallas_call).  For every pixel n
// of the flattened (B, H, W) grid and every output channel d:
//
//   for k in scales {1, 2, 3, 6}:
//     sm_k[n, c]   = sum_s uh[h(n), off_k + s] * avew[b(n), off_k + s, w(n), c]
//     gate_k[n, d] = sigmoid(sum_c (sm_k[n, c] - fv[n, c]) * W_k[c, d])
//     num[n, d]   += gate_k[n, d] * sm_k[n, d]
//     den[n, d]   += gate_k[n, d]
//   out[n, d] = num / (den + 1e-12)
//
// avew packs the four scales' width-interpolated pooled maps into one
// (B, 12, W, C) f32 buffer and uh their row-interpolation matrices into one
// (H, 12) f32 buffer, at row offsets 0, 1, 3, 6 (built in torch by
// ops/cuda_context.py::precompute, as _precompute does for the TPU).
//
// What bounds it on the card: the four (P x C) @ (C x C) products, 2*4*C*C
// FLOP per pixel (~206 GFLOP for an 8 x 96 x 128 x 512 feature map) against
// ~400 MB of compulsory traffic (fv in, out out): about 500 FLOP per byte,
// so operations, not bytes, bound it.  This first version runs the products
// as f32 FMAs on CUDA cores (the f32 peak is the bound it is held to);
// tensor cores (wgmma) are later work.  What the design does about the
// bound: each block keeps a 64-pixel x 64-channel tile of logits, num and
// den in registers (4 x 4 per thread) for all four scales, so neither the
// per-scale sm, contrast and gate maps nor the partial sums ever reach
// device memory; contrast chunks are rebuilt in shared memory from
// uh/avew/fv instead of being stored, trading ~5% extra FMAs for bytes.
//
// Numerics follow the TPU kernel: the product takes its inputs in fv's
// dtype (contrast and W_k rounded to bf16 in bf16 mode) and accumulates in
// f32; sm, gates, num and den are f32; the output is rounded once to fv's
// dtype.  Every sum runs in a fixed order: no atomics, deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 64;         // pixels per block
constexpr int kD = 64;         // output channels per block
constexpr int kKC = 32;        // contraction chunk staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kScales = 4;
constexpr int kRows = 12;      // pooled rows over all scales: 1 + 2 + 3 + 6

__device__ __forceinline__ int scale_offset(int k) {
  return k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 3 : 6;
}

__device__ __forceinline__ int scale_size(int k) {
  return k == 0 ? 1 : k == 1 ? 2 : k == 2 ? 3 : 6;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and widened back: the product's input dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
context_fused_kernel(const T* __restrict__ fv, const float* __restrict__ avew,
                     const float* __restrict__ uh, const T* __restrict__ wmat,
                     T* __restrict__ out, int n_pix, int height, int width,
                     int channels) {
  __shared__ float a_s[kP][kKC + 1];               // contrast chunk
  __shared__ __align__(16) float b_s[kKC][kD];     // W_k chunk
  __shared__ float uh_s[kP][kRows];                // each pixel's uh row
  __shared__ long long fv_row[kP];                 // offset of fv[n, 0]
  __shared__ long long av_row[kP];                 // offset of avew[b, 0, w, 0]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels d0 + 4 tx .. + 3
  const int ty = tid / 16;  // pixels p0 + 4 ty .. + 3
  const int d0 = blockIdx.x * kD;
  const int p0 = blockIdx.y * kP;
  const long long C = channels;
  const long long plane = static_cast<long long>(width) * C;  // avew row stride

  if (tid < kP) {
    // a ragged tail computes on the last real pixel; its store is masked
    const int n = min(p0 + tid, n_pix - 1);
    const int w = n % width;
    const int h = (n / width) % height;
    const int b = n / (width * height);
    fv_row[tid] = static_cast<long long>(n) * C;
    av_row[tid] = (static_cast<long long>(b) * kRows * width + w) * C;
#pragma unroll
    for (int r = 0; r < kRows; ++r) uh_s[tid][r] = uh[h * kRows + r];
  }
  __syncthreads();

  float num[4][4], den[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) num[i][j] = den[i][j] = 0.f;

#pragma unroll 1
  for (int k = 0; k < kScales; ++k) {
    const int off = scale_offset(k);
    const int ns = scale_size(k);
    const T* wk = wmat + static_cast<long long>(k) * C * C;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < channels; c0 += kKC) {
      // contrast chunk: one warp per pixel row, lanes along channels
      // (coalesced reads of fv and avew, conflict-free shared stores)
      const int kk = tid % kKC;
#pragma unroll
      for (int i = 0; i < kP * kKC / kThreads; ++i) {
        const int p = tid / kKC + i * (kThreads / kKC);
        const float* av = avew + av_row[p] + off * plane + c0 + kk;
        float sm = 0.f;
        for (int s = 0; s < ns; ++s) sm = fmaf(uh_s[p][off + s], av[s * plane], sm);
        const float x = to_f32(fv[fv_row[p] + c0 + kk]);
        a_s[p][kk] = round_to<T>(sm - x);
      }
      // W_k chunk: rows c0 .. c0 + kKC, columns d0 .. d0 + kD
#pragma unroll
      for (int i = 0; i < kKC * kD / kThreads; ++i) {
        const int r = tid / kD + i * (kThreads / kD);
        const int d = tid % kD;
        b_s[r][d] = to_f32(wk[(c0 + r) * C + d0 + d]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kKC; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[q][tx * 4]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = a_s[ty * 4 + i][q];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // gate this scale and fold it into num/den; sm is rebuilt for the
    // thread's own 4 x 4 outputs (S <= 6 reads each, L2-resident)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty * 4 + i;
      const float* av = avew + av_row[p] + off * plane + d0 + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sm = 0.f;
        for (int s = 0; s < ns; ++s) sm = fmaf(uh_s[p][off + s], av[s * plane + j], sm);
        const float gate = 1.f / (1.f + expf(-acc[i][j]));
        num[i][j] = fmaf(gate, sm, num[i][j]);
        den[i][j] += gate;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = p0 + ty * 4 + i;
    if (n >= n_pix) continue;
    T* o = out + static_cast<long long>(n) * C + d0 + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = from_f32<T>(num[i][j] / (den[i][j] + 1e-12f));
  }
}

}  // namespace

extern "C" {

// Channel-tile width: the wrapper refuses C % context_fused_channel_tile().
int context_fused_channel_tile() { return kD; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// fv/out: (n_pix, channels) in fv's dtype (bf16 when is_bf16, else f32);
// avew: (B, 12, width, channels) f32; uh: (height, 12) f32;
// wmat: (4, channels, channels) in fv's dtype; n_pix = B * height * width.
int context_fused_forward(const void* fv, const void* avew, const void* uh,
                          const void* wmat, void* out, int n_pix, int height,
                          int width, int channels, int is_bf16, void* stream) {
  if (n_pix <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      channels % kD != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(n_pix) + kP - 1) / kP;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(channels / kD, static_cast<unsigned>(tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    context_fused_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fv), static_cast<const float*>(avew),
        static_cast<const float*>(uh), static_cast<const __nv_bfloat16*>(wmat),
        static_cast<__nv_bfloat16*>(out), n_pix, height, width, channels);
  } else {
    context_fused_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(fv), static_cast<const float*>(avew),
        static_cast<const float*>(uh), static_cast<const float*>(wmat),
        static_cast<float*>(out), n_pix, height, width, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
