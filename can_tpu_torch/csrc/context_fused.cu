// Fused CANNet context tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel can_tpu/ops/pallas_context.py::_kernel
// (launched by _fused_forward through pl.pallas_call).  For every pixel p
// of the (B, H, W) grid and every output channel d:
//
//   for k in scales {1, 2, 3, 6}:
//     sm_k[p, c]   = sum_s uh[h(p), off_k + s] * avew[b(p), off_k + s, w(p), c]
//     gate_k[p, d] = sigmoid(sum_c (sm_k[p, c] - fv[p, c]) * W_k[c, d])
//     num[p, d]   += gate_k[p, d] * sm_k[p, d]
//     den[p, d]   += gate_k[p, d]
//   out[p, d] = num / (den + 1e-12)
//
// avew packs the four scales' width-interpolated pooled maps into one
// (B, 12, W, C) f32 buffer and uh their row-interpolation matrices into one
// (H, 12) f32 buffer, at row offsets 0, 1, 3, 6 (ops/cuda_context.py).
//
// Decomposition.  The logits are linear in the contrast:
//
//   (sm_k - fv) @ W_k = sm_k @ W_k - fv @ W_k
//   sm_k @ W_k [p, d] = sum_s uh[h(p), off_k + s] * Q[b(p), off_k + s, w(p), d]
//   Q[b, r, w, :]     = avew[b, r, w, :] @ W_{k(r)}
//
// so one call runs two launches:
//   1. context_q_kernel: Q (avew's shape, f32) from avew and W_k, an f32
//      register-tiled GEMM (B*12*W rows; ~3% of the main products);
//   2. the main launch: ONE GEMM acc = fv (P x C) @ Wcat (C x 4C), where
//      Wcat holds the four W_k side by side in column order (d-block of 32,
//      scale, d within the block), with the gate tail as its epilogue:
//        q_k = sum_s uh * Q ; sm_k = sum_s uh * avew  (the same 12 rows)
//        gate_k = sigmoid(q_k - acc_k) ; num += gate_k sm_k ; den += gate_k
//      The column order puts the four scales of one channel d in the same
//      thread's accumulators, so the epilogue runs in registers.
//
// What bounds it on the card: the four (P x C) @ (C x C) products, 2*4*C*C
// FLOP per pixel (208.6 GFLOP with the elementwise work for an
// 8 x 96 x 128 x 512 feature map) against ~400 MB of compulsory f32 traffic:
// operations, at 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32 FMAs).
// Beside them the epilogue needs 24 f32 values (12 rows of Q and of avew)
// per output.  What the design does about it:
//   * bf16: wgmma m64n128k16 (bf16 x bf16 -> f32) on tensor cores, a
//     128-pixel x 128-column block tile (2 warpgroups of 64 x 128, 64
//     accumulators a thread), a K chunk of 64, a 3-stage cp.async ring
//     holding both operands K-major in the canonical 128-byte swizzle, so
//     wgmma reads them from shared memory by descriptor (Wcat is passed
//     transposed for this: still a permutation of wmat);
//   * f32: CUDA-core FMAs (no TF32), a 128 x 128 block tile, 8 pixels x
//     (2 channels x 4 scales) per thread, float2 shared reads of both
//     operands (A row-major, fed by cp.async, which cannot transpose),
//     double-buffered cp.async staging;
//   * fv is read once per 128-column block, straight from the feature map
//     (never rebuilt), and the C / 32 column blocks of one pixel tile (16
//     at C = 512) are launched next to each other so fv stays in L2;
//   * a pixel tile is 8 rows x 16 columns of one image, so its 128 pixels
//     need the Q and avew rows of only 16 image columns (16 x 12 rows x 32
//     channels, 24 KB each): the block stages them by cp.async into ring
//     stages as they fall idle (bf16: during the last two K chunks; f32:
//     after the loop), and the epilogue reads shared memory: its 24 reads
//     per output would otherwise be 16 serial L2 round trips per warp.
//   Pixel tiles ride grid.x (no 65535 cap); ragged tiles are masked.
//
// Numerics.  The TPU kernel rounds the contrast to bf16 before its product.
// Here, in bf16, fv and W are bf16 (exact as given) and their products are
// summed in f32, sm @ W is taken in f32 (Q), so the result is closer to the
// all-f32 plain version than the TPU kernel's rounding.  The gates, num and
// den are f32; the output is rounded once to fv's dtype.  Every sum runs in
// a fixed order: no atomics, bitwise repeatable.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScales = 4;
constexpr int kRows = 12;       // pooled rows over all scales: 1 + 2 + 3 + 6
constexpr int kBM = 128;        // pixels (GEMM rows) per block
constexpr int kBN = 128;        // Wcat columns per block: 32 channels x 4 scales
constexpr int kDB = 32;         // channels per Wcat block
constexpr int kTH = 8;          // pixel tile: 8 image rows ...
constexpr int kTW = 16;         // ... x 16 image columns
constexpr int kChannelTile = 64;  // C must be a multiple of this

// bf16 main launch: 2 warpgroups of 64 x 128 (wgmma), K chunk 64, 3-stage ring
constexpr int kThreadsH = 256;
constexpr int kBKH = 64;
constexpr int kStagesH = 3;
constexpr int kStageBytesH = (kBM * kBKH + kBKH * kBN) * 2;  // A + B, bf16

// f32 GEMMs: 256 threads, K chunk 32, double buffer; A rows padded to 36
constexpr int kThreadsF = 256;
constexpr int kBKF = 32;
constexpr int kStagesF = 2;
constexpr int kAStrideF = kBKF + 4;
constexpr int kStageFloatsF = kBM * kAStrideF + kBKF * kBN;

// per-pixel tables after the ring: fv offset, Q/avew offset, store
// offset (-1 when masked), uh row
constexpr int kTableBytes = kBM * (3 * 8 + kRows * 4);

__device__ __forceinline__ int scale_offset(int k) {
  return k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 3 : 6;
}
__device__ __forceinline__ int scale_size(int k) {
  return k == 0 ? 1 : k == 1 ? 2 : k == 2 ? 3 : 6;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The gate and the final quotient.  f32 keeps expf and IEEE rounding (the
// correctly rounded reciprocal is 1/x exactly, without the division
// routine); bf16, whose output rounds to 8 bits, takes __expf and the fast
// reciprocal (relative error ~1e-6, far under its rounding).
__device__ __forceinline__ float sigmoid_neg(float x, float) {
  return __frcp_rn(1.f + expf(x));
}
__device__ __forceinline__ float sigmoid_neg(float x, __nv_bfloat16) {
  return __fdividef(1.f, 1.f + __expf(x));
}
__device__ __forceinline__ float quotient(float a, float b, float) { return a / b; }
__device__ __forceinline__ float quotient(float a, float b, __nv_bfloat16) {
  return __fdividef(a, b);
}

__device__ __forceinline__ void store_pair(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
}

// Per-pixel tables of the main launch.  Local pixel lp of tile
// (b, hb, wb) is image row hb*8 + lp%8, column wb*16 + lp/8: the 8
// accumulator rows of a lane group (g = lane / 4, consecutive lp) share one
// image column, hence one staged Q/avew row, and read it as a broadcast.
// Out-of-image pixels read a clamped pixel and store nothing.
struct Tables {
  long long* fv_off;   // n * C of the (clamped) pixel
  long long* av_off;   // (b * 12 * W + w) * C of the (clamped) pixel
  long long* out_off;  // n * C, or -1 when masked
  float* uh_row;       // uh[h, 0:12]
};

__device__ __forceinline__ Tables tables_at(unsigned char* p) {
  Tables t;
  t.fv_off = reinterpret_cast<long long*>(p);
  t.av_off = t.fv_off + kBM;
  t.out_off = t.av_off + kBM;
  t.uh_row = reinterpret_cast<float*>(t.out_off + kBM);
  return t;
}

__device__ __forceinline__ void fill_tables(const Tables& t, const float* uh,
                                            int tile, int height, int width,
                                            int channels) {
  const int lp = threadIdx.x;
  if (lp >= kBM) return;
  const int n_wb = (width + kTW - 1) / kTW;
  const int n_hb = (height + kTH - 1) / kTH;
  const int wb = tile % n_wb;
  const int hb = (tile / n_wb) % n_hb;
  const int b = tile / (n_wb * n_hb);
  const int h = hb * kTH + lp % kTH;
  const int w = wb * kTW + lp / kTH;
  const int hc = min(h, height - 1), wc = min(w, width - 1);
  const long long C = channels;
  const long long n = (static_cast<long long>(b) * height + hc) * width + wc;
  t.fv_off[lp] = n * C;
  t.av_off[lp] = (static_cast<long long>(b) * kRows * width + wc) * C;
  t.out_off[lp] = (h < height && w < width) ? n * C : -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t.uh_row[lp * kRows + r] = uh[hc * kRows + r];
}

// The block's rows of Q or of avew, staged in shared memory for the
// epilogue: [16 image columns][12 rows][32 channels] f32, 24 KB.  The 8 image
// rows of a tile share them, so they serve all 128 x 32 outputs.
constexpr int kQaRow = kDB;                        // floats per staged row
constexpr int kQaBytes = kTW * kRows * kQaRow * 4;  // one of Q, avew

static_assert(kQaBytes <= kStageBytesH, "a staged half must fit a bf16 stage");
static_assert(2 * kQaBytes <= kStagesF * kStageFloatsF * 4, "Q and avew must fit the f32 ring");

__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           const Tables& t, int d0,
                                           long long plane) {
  for (int id = threadIdx.x; id < kQaBytes / 16; id += blockDim.x) {
    const int ch = id % (kQaRow / 4), row = id / (kQaRow / 4);
    const int r = row % kRows, wl = row / kRows;
    cp_async16(smem_u32(dst + row * kQaRow + ch * 4),
               src + t.av_off[wl * kTH] + r * plane + d0 + ch * 4, true);
  }
}

// The gate tail for one pixel and two adjacent channels dl, dl + 1 of the
// block's 32: acc[k][j] = (fv @ W_k)[p, d0 + dl + j].
template <typename T>
__device__ __forceinline__ void gate_tail(const float (&acc)[kScales][2],
                                          const Tables& t, const float* qs,
                                          const float* as, int lp, int d0,
                                          int dl, T* __restrict__ out) {
  const float* u = t.uh_row + lp * kRows;
  const float* qrow = qs + (lp / kTH) * kRows * kQaRow + dl;
  const float* arow = as + (lp / kTH) * kRows * kQaRow + dl;
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kScales; ++k) {
    float qk[2] = {0.f, 0.f}, sm[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < scale_size(k); ++s) {
      const int r = scale_offset(k) + s;
      const float us = u[r];
      const float2 qv = *reinterpret_cast<const float2*>(qrow + r * kQaRow);
      const float2 av = *reinterpret_cast<const float2*>(arow + r * kQaRow);
      qk[0] = fmaf(us, qv.x, qk[0]);
      qk[1] = fmaf(us, qv.y, qk[1]);
      sm[0] = fmaf(us, av.x, sm[0]);
      sm[1] = fmaf(us, av.y, sm[1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float gate = sigmoid_neg(acc[k][j] - qk[j], T());  // sigmoid(q - acc)
      num[j] = fmaf(gate, sm[j], num[j]);
      den[j] += gate;
    }
  }
  const long long o = t.out_off[lp];
  if (o >= 0) {
    store_pair(out + o + d0 + dl, quotient(num[0], den[0] + 1e-12f, T()),
               quotient(num[1], den[1] + 1e-12f, T()));
  }
}

// ---------------------------------------------------------------- bf16 main

// Shared-memory matrix descriptor of a K-major bf16 tile in the canonical
// 128-byte swizzle: rows of 64 values (128 B), 16-byte chunks XOR-ed with
// row % 8, 8-row groups 1024 B apart, the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);  // start
  d |= static_cast<uint64_t>(1) << 16;                         // LBO (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;                 // SBO: 8 rows
  d |= static_cast<uint64_t>(1) << 62;                         // 128 B swizzle
  return d;
}

// D (64 x 128 per warpgroup, f32) += A (64 x 16, bf16) B (16 x 128, bf16),
// both from shared memory.  d[4 i + c] is row 16 warp + g (+8 for c >= 2),
// column 8 i + 2 (lane % 4) + (c & 1), g = lane / 4.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// cp.async writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A tile [128 pixels][64 k] and B tile [128 Wcat columns][64 k] (Wcat
// stored transposed, K-major), bf16, each in the canonical 128-byte swizzle.
__device__ __forceinline__ void load_stage_bf16(
    unsigned char* stage, const __nv_bfloat16* __restrict__ fv,
    const __nv_bfloat16* __restrict__ wcat_t, const Tables& t, int kc,
    long long ldb, int col0) {
  const uint32_t a_s = smem_u32(stage);
  const uint32_t b_s = a_s + kBM * kBKH * 2;
#pragma unroll
  for (int i = 0; i < kBM * kBKH / 8 / kThreadsH; ++i) {
    const int id = threadIdx.x + i * kThreadsH;
    const int row = id / 8, ch = id % 8;
    cp_async16(a_s + row * 128 + ((ch ^ (row & 7)) * 16),
               fv + t.fv_off[row] + kc * kBKH + ch * 8, true);
  }
#pragma unroll
  for (int i = 0; i < kBN * kBKH / 8 / kThreadsH; ++i) {
    const int id = threadIdx.x + i * kThreadsH;
    const int row = id / 8, ch = id % 8;
    cp_async16(b_s + row * 128 + ((ch ^ (row & 7)) * 16),
               wcat_t + (static_cast<long long>(col0) + row) * ldb + kc * kBKH + ch * 8,
               true);
  }
}

__global__ void __launch_bounds__(kThreadsH)
context_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ fv,
                         const float* __restrict__ avew,
                         const float* __restrict__ uh,
                         const __nv_bfloat16* __restrict__ wcat_t,
                         const float* __restrict__ q,
                         __nv_bfloat16* __restrict__ out, int height, int width,
                         int channels) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (the launch adds the slack)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_nb = channels / kDB;
  const int nb = blockIdx.x % n_nb;  // column blocks of a tile run together
  const int tile = blockIdx.x / n_nb;
  const Tables t = tables_at(smem + kStagesH * kStageBytesH);
  fill_tables(t, uh, tile, height, width, channels);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;         // pixels wg*64 .. +63
  const int warp = (threadIdx.x / 32) % 4;  // ... of which rows warp*16 .. +15
  const long long ldb = channels;           // Wcat^T row stride
  const int col0 = nb * kBN;
  const int nk = channels / kBKH;
  const long long plane = static_cast<long long>(width) * channels;
  // Q and avew rows go to the two stages the last chunks leave free:
  // stage nk % 3 (free from iteration nk - 2) and (nk + 1) % 3 (from nk - 1)
  float* qs = reinterpret_cast<float*>(smem + (nk % kStagesH) * kStageBytesH);
  float* as = reinterpret_cast<float*>(smem + ((nk + 1) % kStagesH) * kStageBytesH);

  // acc[4 i + c]: n8 chunk i = 4 k + e (scale k, channels e*8 .. +7 of the
  // block's 32), c as in wgmma_m64n128k16
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStagesH - 1; ++s) {
    if (s < nk) load_stage_bf16(smem + s * kStageBytesH, fv, wcat_t, t, s, ldb, col0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStagesH - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk kc landed; chunk kc - 1's products are done
    const int pre = kc + kStagesH - 1;
    if (pre < nk)
      load_stage_bf16(smem + (pre % kStagesH) * kStageBytesH, fv, wcat_t, t, pre,
                      ldb, col0);
    if (kc == max(nk - 2, 0)) stage_rows(qs, q, t, nb * kDB, plane);
    if (kc == nk - 1) stage_rows(as, avew, t, nb * kDB, plane);
    cp_async_commit();

    const uint32_t a_s = smem_u32(smem + (kc % kStagesH) * kStageBytesH);
    const uint64_t da = sw128_desc(a_s + wg * 64 * 128);
    const uint64_t db = sw128_desc(a_s + kBM * kBKH * 2);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBKH / 16; ++ks)  // 32 bytes along K per step
      wgmma_m64n128k16(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // Q and avew rows landed
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a2[kScales][2];
#pragma unroll
      for (int k = 0; k < kScales; ++k) {
        a2[k][0] = acc[(k * 4 + e) * 4 + half * 2];
        a2[k][1] = acc[(k * 4 + e) * 4 + half * 2 + 1];
      }
      const int lp = wg * 64 + warp * 16 + half * 8 + (lane >> 2);
      gate_tail(a2, t, qs, as, lp, nb * kDB, e * 8 + (lane & 3) * 2, out);
    }
}

// ---------------------------------------------------------------- f32 GEMMs

// A tile [128 rows][32 k] (row stride 36 floats) from per-row offsets,
// B tile [32 k][128 columns] f32.  Columns at or past ncols read zeros.
// bf16 weights (the Q launch in bf16 mode) are widened on the way in.
__device__ __forceinline__ void load_b_chunk(uint32_t dst, const float* src,
                                             bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void load_b_chunk(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    v.x = __uint_as_float(raw.x << 16);
    v.y = __uint_as_float(raw.x & 0xffff0000u);
    v.z = __uint_as_float(raw.y << 16);
    v.w = __uint_as_float(raw.y & 0xffff0000u);
  }
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
}

template <typename TB>
__device__ __forceinline__ void load_stage_f32(
    float* stage, const float* __restrict__ a, const long long* a_off,
    const TB* __restrict__ b, long long ldb, int col0, int ncols, int kc) {
  const uint32_t a_s = smem_u32(stage);
  const uint32_t b_s = a_s + kBM * kAStrideF * 4;
#pragma unroll
  for (int i = 0; i < kBM * kBKF / 4 / kThreadsF; ++i) {
    const int id = threadIdx.x + i * kThreadsF;
    const int row = id / 8, ch = id % 8;
    cp_async16(a_s + (row * kAStrideF + ch * 4) * 4,
               a + a_off[row] + kc * kBKF + ch * 4, true);
  }
#pragma unroll
  for (int i = 0; i < kBKF * kBN / 4 / kThreadsF; ++i) {
    const int id = threadIdx.x + i * kThreadsF;
    const int row = id / 32, ch = id % 32;
    const int col = col0 + ch * 4;
    const bool valid = col < ncols;
    load_b_chunk(b_s + (row * kBN + ch * 4) * 4,
                 b + (static_cast<long long>(kc) * kBKF + row) * ldb +
                     (valid ? col : 0),
                 valid);
  }
}

// acc[i][k*2 + j] += sum_c A[row_i, c] * B[c, k*32 + 2*tx + j], with
// row_i = 4 ty + i (i < 4), 64 + 4 ty + i - 4 (i >= 4); tx = tid % 16,
// ty = tid / 16.  Both operands are float2 shared reads without conflicts.
template <typename TB>
__device__ __forceinline__ void gemm_f32(float (&acc)[8][8], float* ring,
                                         const float* __restrict__ a,
                                         const long long* a_off,
                                         const TB* __restrict__ b,
                                         long long ldb, int col0, int ncols,
                                         int k_total) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nk = k_total / kBKF;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStagesF - 1; ++s) {
    if (s < nk) load_stage_f32(ring + s * kStageFloatsF, a, a_off, b, ldb, col0, ncols, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStagesF - 2>();
    __syncthreads();
    const int pre = kc + kStagesF - 1;
    if (pre < nk)
      load_stage_f32(ring + (pre % kStagesF) * kStageFloatsF, a, a_off, b, ldb,
                     col0, ncols, pre);
    cp_async_commit();
    const float* as = ring + (kc % kStagesF) * kStageFloatsF;
    const float* bs = as + kBM * kAStrideF;
#pragma unroll
    for (int kk = 0; kk < kBKF; kk += 2) {
      float2 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        av[i] = *reinterpret_cast<const float2*>(as + row * kAStrideF + kk);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float2 bv[kScales];
#pragma unroll
        for (int k = 0; k < kScales; ++k)
          bv[k] = *reinterpret_cast<const float2*>(bs + (kk + u) * kBN + k * kDB + tx * 2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = u == 0 ? av[i].x : av[i].y;
#pragma unroll
          for (int k = 0; k < kScales; ++k) {
            acc[i][k * 2] = fmaf(x, bv[k].x, acc[i][k * 2]);
            acc[i][k * 2 + 1] = fmaf(x, bv[k].y, acc[i][k * 2 + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kThreadsF)
context_gemm_f32_kernel(const float* __restrict__ fv,
                        const float* __restrict__ avew,
                        const float* __restrict__ uh,
                        const float* __restrict__ wcat,
                        const float* __restrict__ q, float* __restrict__ out,
                        int height, int width, int channels) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_nb = channels / kDB;
  const int nb = blockIdx.x % n_nb;
  const int tile = blockIdx.x / n_nb;
  const Tables t = tables_at(smem + kStagesF * kStageFloatsF * 4);
  fill_tables(t, uh, tile, height, width, channels);
  __syncthreads();

  float acc[8][8];
  gemm_f32(acc, reinterpret_cast<float*>(smem), fv, t.fv_off, wcat,
           4LL * channels, nb * kBN, 4 * channels, channels);

  // Q and avew rows into the idle ring
  float* qs = reinterpret_cast<float*>(smem);
  float* as = qs + kQaBytes / 4;
  const long long plane = static_cast<long long>(width) * channels;
  __syncthreads();  // every warp is done with the ring
  stage_rows(qs, q, t, nb * kDB, plane);
  stage_rows(as, avew, t, nb * kDB, plane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float a2[kScales][2];
#pragma unroll
    for (int k = 0; k < kScales; ++k) {
      a2[k][0] = acc[i][k * 2];
      a2[k][1] = acc[i][k * 2 + 1];
    }
    const int lp = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    gate_tail(a2, t, qs, as, lp, nb * kDB, tx * 2, out);
  }
}

// Q[b, off_k + s, w, :] = avew[b, off_k + s, w, :] @ W_k, f32, for scale
// k = blockIdx.y.  The rows of one scale, (b, s, w), are B * S_k * W rows of
// C; blockIdx.x = row tile * column tiles + column tile.
template <typename TW>
__global__ void __launch_bounds__(kThreadsF)
context_q_kernel(const float* __restrict__ avew, const TW* __restrict__ wmat,
                 float* __restrict__ q, int batch, int width, int channels) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* a_off = reinterpret_cast<long long*>(smem + kStagesF * kStageFloatsF * 4);
  const int k = blockIdx.y;
  const int off = scale_offset(k), ns = scale_size(k);
  const int rows = batch * ns * width;
  const int n_nb = (channels + kBN - 1) / kBN;
  const int nb = blockIdx.x % n_nb;
  const int r0 = (blockIdx.x / n_nb) * kBM;
  if (r0 >= rows) return;  // the whole block: scales differ in row count
  if (threadIdx.x < kBM) {
    const int i = min(r0 + static_cast<int>(threadIdx.x), rows - 1);
    const int b = i / (ns * width), rem = i % (ns * width);
    a_off[threadIdx.x] =
        (static_cast<long long>(b) * kRows * width + off * width + rem) * channels;
  }
  __syncthreads();

  float acc[8][8];
  const long long C = channels;
  gemm_f32(acc, reinterpret_cast<float*>(smem), avew, a_off,
           wmat + static_cast<long long>(k) * C * C, C, nb * kBN, channels,
           channels);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r0 + lr >= rows) continue;
#pragma unroll
    for (int kk = 0; kk < kScales; ++kk) {
      const int col = nb * kBN + kk * kDB + tx * 2;
      if (col < channels)
        store_pair(q + a_off[lr] + col, acc[i][kk * 2], acc[i][kk * 2 + 1]);
    }
  }
}

template <typename K>
cudaError_t with_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// Channel tile: the wrapper refuses C % context_fused_channel_tile().
int context_fused_channel_tile() { return kChannelTile; }

// Wcat's block width: columns (d // 32, scale, d % 32); the wrapper checks
// its own against it.
int context_fused_wcat_block() { return kDB; }

// Launches Q's kernel, then the main one, on `stream`; returns the first
// non-zero cudaGetLastError() (0 = ok).  fv/out: (batch, height, width,
// channels) in fv's dtype (bf16 when is_bf16, else f32); avew and q:
// (batch, 12, width, channels) f32; uh: (height, 12) f32; wmat: (4,
// channels, channels) in fv's dtype; wcat: Wcat (channels, 4 * channels)
// in f32, its transpose (4 * channels, channels) in bf16.
int context_fused_forward(const void* fv, const void* avew, const void* uh,
                          const void* wmat, const void* wcat, void* q,
                          void* out, int batch, int height, int width,
                          int channels, int is_bf16, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      channels % kChannelTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(avew);
  float* qf = static_cast<float*>(q);

  // launch 1: Q
  const long long q_tiles = (static_cast<long long>(batch) * 6 * width + kBM - 1) / kBM;
  const long long q_blocks = q_tiles * ((channels + kBN - 1) / kBN);
  const long long tiles = static_cast<long long>(batch) *
                          ((height + kTH - 1) / kTH) * ((width + kTW - 1) / kTW);
  const long long blocks = tiles * (channels / kDB);
  if (q_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int q_smem = kStagesF * kStageFloatsF * 4 + kBM * 8;
  cudaError_t err;
  if (is_bf16) {
    err = with_smem(context_q_kernel<__nv_bfloat16>, q_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    context_q_kernel<__nv_bfloat16><<<dim3(static_cast<unsigned>(q_blocks), kScales), kThreadsF, q_smem, s>>>(
        av, static_cast<const __nv_bfloat16*>(wmat), qf, batch, width, channels);
  } else {
    err = with_smem(context_q_kernel<float>, q_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    context_q_kernel<float><<<dim3(static_cast<unsigned>(q_blocks), kScales), kThreadsF, q_smem, s>>>(
        av, static_cast<const float*>(wmat), qf, batch, width, channels);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // launch 2: fv @ Wcat with the gate tail
  if (is_bf16) {
    const int bytes = kStagesH * kStageBytesH + kTableBytes + 1024;  // + alignment slack
    err = with_smem(context_gemm_bf16_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    context_gemm_bf16_kernel<<<static_cast<unsigned>(blocks), kThreadsH, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(fv), av, static_cast<const float*>(uh),
        static_cast<const __nv_bfloat16*>(wcat), qf,
        static_cast<__nv_bfloat16*>(out), height, width, channels);
  } else {
    const int bytes = kStagesF * kStageFloatsF * 4 + kTableBytes;
    err = with_smem(context_gemm_f32_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    context_gemm_f32_kernel<<<static_cast<unsigned>(blocks), kThreadsF, bytes, s>>>(
        static_cast<const float*>(fv), av, static_cast<const float*>(uh),
        static_cast<const float*>(wcat), qf, static_cast<float*>(out), height,
        width, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
