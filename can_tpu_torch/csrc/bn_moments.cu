// Masked BatchNorm moment sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel can_tpu/ops/pallas_bn.py::_kernel
// (launched by _sums_forward through pl.pallas_call).  For an activation y
// of (n_pix, C) (the flattened (B, h, w) grid, channels contiguous) and a
// per-pixel validity weight m of (n_pix,):
//
//   s1[c] = sum_n y[n, c] * m[n]
//   s2[c] = sum_n y[n, c]^2 * m[n]
//   s0    = sum_n m[n]
//
// all accumulated in f32 (y may be bf16: read as bf16, widened exactly).
//
// What bounds it on the card: bytes.  Each element of y is read once and
// costs 3 operations (y*m, +, fma), far below the card's ~20 f32 FLOP per
// byte, so the least time is (bytes of y + bytes of m) / 3.35 TB/s — about
// 0.27 ms for the largest training layer, (8, 576, 768, 64) f32.  What the
// design does about it: one pass over y with 16-byte loads, threads along
// the contiguous channels (a warp reads 512 contiguous bytes), the
// accumulators in registers, and no intermediate ever written to device
// memory except one (2C + 1) row of partial sums per block.
//
// Two stages, no atomics, so the result is bitwise the same on every run:
//   1. bn_moments_partial: block (chunk, channel group) sums its chunk of
//      pixels; each thread walks pixels row, row + rows, ... in order, the
//      block's warps combine in shared memory in row order, and the block
//      writes partial[chunk][0 | 1][c] and (channel group 0) s0[chunk].
//   2. bn_moments_finish: one thread per output sums the chunks in index
//      order, in f64, and rounds once to f32.  s0 is counted once per pixel
//      (not per channel); each chunk's f32 count is exact (a chunk holds far
//      fewer than 2^24 pixels) and the f64 total is exact, so s0 is the
//      f32 nearest the true count: exact up to 2^24 valid pixels (16.7 M;
//      a training batch of 8 x 576 x 768 holds 3.5 M), rounded to f32's
//      24-bit mantissa above that, as any f32 result would be.
// The chunk count depends only on the shape (never on the card's SM
// count), so the summation order — and the result — is fixed by the shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// blocks to aim for: 8 per SM of a 132-SM card; a constant so that the
// chunking (hence the summation order) never depends on the card
constexpr long long kTargetBlocks = 132 * 8;

// Channels a thread reads in one 16-byte load.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

// bf16 as its raw 16-bit pattern: widening to f32 is a 16-bit shift
struct Bf16 { uint16_t bits; };

template <> struct Vec<Bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const Bf16* p, float (&v)[8]) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct Plan {
  int lanes;         // threads across one pixel's channel group
  int rows;          // pixels a block reads at once
  int groups;        // channel groups (grid.y)
  long long chunk;   // pixels per block (a multiple of rows)
  long long chunks;  // grid.x
};

Plan make_plan(long long n_pix, int channels, int vec) {
  Plan p;
  const int lanes_needed = (channels + vec - 1) / vec;
  p.lanes = lanes_needed < 32 ? lanes_needed : 32;
  p.rows = kThreads / p.lanes;
  p.groups = (channels + p.lanes * vec - 1) / (p.lanes * vec);
  long long want = (kTargetBlocks + p.groups - 1) / p.groups;
  const long long max_chunks = (n_pix + p.rows - 1) / p.rows;
  if (want > max_chunks) want = max_chunks;
  if (want < 1) want = 1;
  long long chunk = (n_pix + want - 1) / want;
  chunk = (chunk + p.rows - 1) / p.rows * p.rows;
  p.chunk = chunk;
  p.chunks = (n_pix + chunk - 1) / chunk;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_moments_partial(const T* __restrict__ y, const float* __restrict__ m,
                   float* __restrict__ part, float* __restrict__ part_s0,
                   long long n_pix, int channels, int lanes, int rows,
                   long long chunk) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[kThreads * V];  // [row][lane * V + j]
  __shared__ float red0[kThreads];     // [row]

  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int row = tid / lanes;
  const int width = lanes * V;                 // channels of this group
  const int c_first = blockIdx.y * width;      // group's first channel
  const int c0 = c_first + lane * V;           // this thread's first channel
  const bool reads = row < rows && c0 < channels;
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long p_end = min(p_begin + chunk, n_pix);

  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  float s0 = 0.f;
  if (reads) {
    const long long C = channels;
#pragma unroll 4
    for (long long p = p_begin + row; p < p_end; p += rows) {
      const float mv = __ldg(m + p);
      float v[V];
      Vec<T>::load(y + p * C + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ym = v[j] * mv;
        s1[j] += ym;
        s2[j] = fmaf(ym, v[j], s2[j]);
      }
      s0 += mv;
    }
  }

  // combine the block's rows in row order: s1, then s2, then s0
  const bool writes_c = tid < width && c_first + tid < channels;
  float* out1 = part + static_cast<long long>(blockIdx.x) * 2 * channels;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[row * width + lane * V + j] = pass ? s2[j] : s1[j];
    __syncthreads();
    if (writes_c) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += red[r * width + tid];
      out1[pass * channels + c_first + tid] = acc;
    }
    __syncthreads();
  }
  if (blockIdx.y == 0) {
    if (lane == 0) red0[row] = s0;  // once per pixel row, not per channel
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += red0[r];
      part_s0[blockIdx.x] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bn_moments_finish(const float* __restrict__ part,
                  const float* __restrict__ part_s0, float* __restrict__ out,
                  long long chunks, int channels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int two_c = 2 * channels;
  if (i < two_c) {
    double acc = 0.0;
#pragma unroll 8
    for (long long k = 0; k < chunks; ++k) acc += part[k * two_c + i];
    out[i] = static_cast<float>(acc);
  } else if (i == two_c) {
    double acc = 0.0;
    for (long long k = 0; k < chunks; ++k) acc += part_s0[k];
    out[i] = static_cast<float>(acc);
  }
}

template <typename T>
int launch(const void* y, const void* m, void* scratch, void* out,
           long long n_pix, int channels, cudaStream_t s) {
  const Plan p = make_plan(n_pix, channels, Vec<T>::N);
  if (p.chunks > 0x7fffffffLL || p.groups > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  float* part = static_cast<float*>(scratch);
  float* part_s0 = part + p.chunks * 2 * channels;
  const dim3 grid(static_cast<unsigned>(p.chunks), static_cast<unsigned>(p.groups));
  bn_moments_partial<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(m), part, part_s0,
      n_pix, channels, p.lanes, p.rows, p.chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int outputs = 2 * channels + 1;
  bn_moments_finish<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, part_s0, static_cast<float*>(out), p.chunks, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Channels one thread loads at once: the wrapper refuses C % this != 0.
int bn_moments_vector_width(int is_bf16) { return is_bf16 ? Vec<Bf16>::N : Vec<float>::N; }

// Floats of scratch the wrapper must allocate: chunks * (2C + 1).
long long bn_moments_scratch_floats(long long n_pix, int channels, int is_bf16) {
  const Plan p = make_plan(n_pix, channels, is_bf16 ? Vec<Bf16>::N : Vec<float>::N);
  return p.chunks * (2LL * channels + 1);
}

// Launches both stages on `stream`; returns cudaGetLastError() (0 = ok).
// y: (n_pix, channels) f32, or bf16 when is_bf16, 16-byte aligned, with
// channels a multiple of bn_moments_vector_width; m: (n_pix,) f32;
// scratch: bn_moments_scratch_floats() f32; out: (2 * channels + 1) f32 =
// [s1 (channels), s2 (channels), s0].
int bn_moments_forward(const void* y, const void* m, void* scratch, void* out,
                       long long n_pix, int channels, int is_bf16,
                       void* stream) {
  const int vec = is_bf16 ? Vec<Bf16>::N : Vec<float>::N;
  if (n_pix <= 0 || channels <= 0 || channels % vec != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<Bf16>(y, m, scratch, out, n_pix, channels, s)
                 : launch<float>(y, m, scratch, out, n_pix, channels, s);
}

}  // extern "C"
