// Masked BatchNorm moment sums and their gradient, for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel can_tpu/ops/pallas_bn.py::_kernel
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
// Backward: replaces the custom VJP _sums_bwd (pallas_bn.py:143), which
// re-differentiates the jnp twin, "one fused elementwise pass" there:
//
//   dy[n, c] = m[n] * (g1[c] + 2 g2[c] y[n, c])
//
// in f32, rounded once to y's dtype; m gets no gradient.
//
// What bounds both on the card: bytes.  Each element of y costs 3 f32
// operations against 4 (f32) or 2 (bf16) bytes, far below the card's ~20
// f32 FLOP per byte: the forward's least time is one read of y and m at
// 3.35 TB/s (~0.27 ms for the largest training layer, (8, 576, 768, 64)
// f32), the backward's one read of y and m and one write of dy.
//
// Forward design: ONE launch per call.
//   * Each block streams a contiguous pixel range.  Channels are innermost,
//     so a range of whole pixels is one contiguous byte range of y (and of
//     m): one elected thread copies it stage by stage into a 4-stage ring
//     in shared memory with 1-D bulk asynchronous copies (cp.async.bulk,
//     completion on an mbarrier; no tensor map, so no link to libcuda);
//     all threads reduce from shared memory, each over fixed channels of
//     fixed pixel rows, the accumulators in registers.  (A register-streaming
//     loop, 8 independent 16-byte loads in flight a thread, tied the ring in
//     f32 and ran 1.4x longer in bf16 on an H100: the ring stays.)
//   * The block combines its rows in shared memory in row order.  Blocks
//     form clusters along the pixel ranges; each cluster sums its blocks'
//     (2C + 1) partials through distributed shared memory in rank order, in
//     f64, and writes one row of partials to the scratch.  The last cluster
//     to finish (an unsigned ticket, atomicAdd with acquire-release order)
//     sums the clusters' rows in index order, in f64, one output a thread
//     over all its blocks, rounds once to f32, and sets the ticket back to 0.
//   * No float atomics: the sums are bitwise the same on every run.  The
//     block count, chunk, stage and cluster size depend only on the shape
//     (never on the card's SM count), so the summation order does too.
//   * s0 is counted once per pixel; every f32 count that enters it covers at
//     most 2^22 pixels (a block's chunk is capped there) and is exact, the
//     f64 sums above it are exact, so s0 is the f32 nearest the true count:
//     exact up to 2^24 valid pixels, rounded to f32 above that.
//   * The ticket lives in the scratch the wrapper passes: it must be 0 at
//     launch and private to one stream.  The wrapper keeps one zeroed
//     scratch per (device, stream); launches on one stream run in order, and
//     each leaves the ticket at 0 for the next.  Two streams never share one.
//
// Backward design: one elementwise pass; a thread owns fixed channels of a
// pixel row (g1 and 2 g2 in registers), reads y with 16-byte loads (4 pixel
// rows in flight), m once per pixel, writes dy with 16-byte stores.  The
// products and sums are rounded as the plain version rounds them
// (__fmul_rn/__fadd_rn: no contraction into an fma), so in f32 the two
// agree bitwise.
//
// Any n_pix >= 1, any C % vec == 0 (vec = 4 f32, 8 bf16); y, m 16-byte
// aligned (the wrapper copies a view that is not).  Channels beyond 256
// vectors split into channel groups (grid.y).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// blocks to aim for at most: 2 per SM of a 132-SM card.  A constant, so
// that the chunking (hence the summation order) never depends on the card
constexpr long long kMaxBlocks = 264;
// bytes of y a block streams at least: small layers get fewer blocks
constexpr long long kBlockBytes = 64 * 1024;
// a block's chunk never exceeds this many pixels (s0's f32 counts stay exact)
constexpr long long kMaxChunk = 1LL << 22;
// blocks of a cluster: a pair, the two SMs of a TPC (a cluster of 4 must
// find 4 free block slots in one GPC at once)
constexpr int kMaxCluster = 2;
constexpr int kStages = 4;
constexpr int kStageBytes = 24 * 1024;  // bytes of y a ring stage holds at most
constexpr int kFinishLoads = 8;         // loads in flight a thread (the final sum)
constexpr int kBarBytes = 128;          // the ring's mbarriers, padded
// the ring's shared memory at most: kStages x (24 KB of y + its m; m is
// largest at C = 4 f32, 16-byte pixels).  ~100 KB at the model's widths:
// 2 blocks an SM
constexpr int kRingSmem = kBarBytes + kStages * (kStageBytes + kStageBytes / 16 * 4);
// (dynamic + static shared memory must stay under 227 KB a block)
constexpr int kMaxSmem = kRingSmem < 226 * 1024 ? kRingSmem : 226 * 1024;

// Channels a thread reads in one 16-byte load.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void load_shared(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// bf16 as its raw 16-bit pattern: widening to f32 is a 16-bit shift
struct Bf16 { uint16_t bits; };

__device__ __forceinline__ void widen8(const uint4 x, float (&v)[8]) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <> struct Vec<Bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const Bf16* p, float (&v)[8]) {
    widen8(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ __forceinline__ static void load_shared(const Bf16* p, float (&v)[8]) {
    widen8(*reinterpret_cast<const uint4*>(p), v);
  }
  // round to nearest even, as PyTorch's .to(torch.bfloat16)
  __device__ __forceinline__ static void store(Bf16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct Plan {
  int lanes;         // threads across one pixel's channel group
  int rows;          // pixel rows a block's threads cover at once
  int groups;        // channel groups (grid.y)
  int width;         // channels of a group
  int cluster;       // blocks of a cluster (along grid.x)
  int stage_pix;     // pixels of a ring stage (a multiple of 4)
  int smem;          // dynamic shared memory of the ring kernel
  long long chunk;   // pixels of a block (a multiple of 4)
  long long blocks;  // grid.x (a multiple of cluster)
};

__host__ __device__ inline int align_up(long long x, int a) {
  return static_cast<int>((x + a - 1) / a * a);
}

Plan make_plan(long long n_pix, int channels, int vec, int esize) {
  Plan p;
  const int slots = channels / vec;  // 16-byte vectors of one pixel
  p.lanes = slots < kThreads ? slots : kThreads;
  p.rows = kThreads / p.lanes;
  p.width = p.lanes * vec;
  p.groups = (channels + p.width - 1) / p.width;
  const long long bytes = n_pix * channels * esize;
  long long want = (bytes + kBlockBytes - 1) / kBlockBytes;
  if (want > kMaxBlocks) want = kMaxBlocks;
  want = (want + p.groups - 1) / p.groups;  // blocks along the pixels
  if (want < (n_pix + kMaxChunk - 1) / kMaxChunk) want = (n_pix + kMaxChunk - 1) / kMaxChunk;
  if (want < 1) want = 1;
  long long chunk = (n_pix + want - 1) / want;
  chunk = (chunk + 3) / 4 * 4;  // stage starts stay 16-byte aligned in m
  p.chunk = chunk;
  long long blocks = (n_pix + chunk - 1) / chunk;
  p.cluster = blocks >= kMaxCluster ? kMaxCluster : 1;
  p.blocks = (blocks + p.cluster - 1) / p.cluster * p.cluster;
  const int seg = p.width * esize;  // bytes of one pixel's group segment
  int stage = kStageBytes / seg;
  stage = stage / 4 * 4;
  p.stage_pix = stage < 4 ? 4 : stage;
  p.smem = kBarBytes + kStages * (align_up(static_cast<long long>(p.stage_pix) * seg, 128) +
                                  align_up(p.stage_pix * 4, 128));
  return p;
}

// ---- PTX helpers ------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// global -> this block's shared memory, `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the forward ---------------------------------------------------------
struct Args {
  const void* y;
  const float* m;
  double* part;       // [blocks / cluster][2C + 1]
  unsigned* ticket;   // 0 at launch, left at 0
  float* out;         // [2C + 1] = s1, s2, s0
  long long n_pix;
  int channels;
  Plan plan;
};

template <typename T>
struct Acc {
  static constexpr int V = Vec<T>::N;
  float s1[V], s2[V], s0;
  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    s0 = 0.f;
  }
  __device__ __forceinline__ void add(const float (&v)[V], float mv) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float ym = v[j] * mv;
      s1[j] += ym;
      s2[j] = fmaf(ym, v[j], s2[j]);
    }
    s0 += mv;
  }
};

// The block's rows in row order, then the cluster's blocks in rank order,
// then (in the last cluster to finish) the clusters in index order.
// `work` is shared memory free for reuse, at least kThreads * V + 2 * width
// + 1 floats.
template <typename T>
__device__ void combine(const Args& a, const Acc<T>& acc, float* work) {
  constexpr int V = Vec<T>::N;
  const Plan& p = a.plan;
  const int tid = threadIdx.x;
  const int lane = tid % p.lanes, row = tid / p.lanes;
  const int c_first = blockIdx.y * p.width;
  const int gw = min(p.width, a.channels - c_first);  // channels of this group
  const bool owns = row < p.rows && lane * V < gw;
  float* red = work;                   // [rows][gw]
  float* bpart = work + kThreads * V;  // [s1 (gw) | s2 (gw) | s0]
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (owns) {
#pragma unroll
      for (int j = 0; j < V; ++j) red[row * gw + lane * V + j] = pass ? acc.s2[j] : acc.s1[j];
    }
    __syncthreads();
    for (int c = tid; c < gw; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < p.rows; ++r) s += red[r * gw + c];
      bpart[pass * gw + c] = s;
    }
    __syncthreads();
  }
  if (lane == 0 && row < p.rows) red[row] = acc.s0;  // once per pixel row
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < p.rows; ++r) s += red[r];
    bpart[2 * gw] = s;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are in its shared memory
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long two_c1 = 2LL * a.channels + 1;
  double* row_out = a.part + (blockIdx.x / k) * two_c1;
  // each rank sums a share of the outputs over the cluster's blocks
  for (int i = rank * kThreads + tid; i <= 2 * gw; i += k * kThreads) {
    double s = 0.0;
    for (int q = 0; q < k; ++q) s += static_cast<double>(cluster.map_shared_rank(bpart, q)[i]);
    if (i < gw) {
      row_out[c_first + i] = s;
    } else if (i < 2 * gw) {
      row_out[a.channels + c_first + (i - gw)] = s;
    } else if (blockIdx.y == 0) {
      row_out[2 * a.channels] = s;  // s0: once, by the first channel group
    }
  }
  __threadfence();
  cluster.sync();  // peers are done reading this block; the cluster's row is written

  // rank 0 takes the ticket and tells the cluster's blocks whether theirs
  // is the last cluster; if so they share the final sum
  __shared__ unsigned last;
  if (rank == 0 && tid == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*a.ticket);
    const unsigned clusters = static_cast<unsigned>(gridDim.x / k * gridDim.y);
    const unsigned is_last = t.fetch_add(1u, cuda::memory_order_acq_rel) == clusters - 1;
    for (int q = 0; q < k; ++q) *cluster.map_shared_rank(&last, q) = is_last;
  }
  cluster.sync();
  if (!last) return;
  __threadfence();
  // one output a thread, the clusters' rows in index order; kFinishLoads
  // rows loaded before any is added, so the L2 round trips overlap
  const long long rows_out = gridDim.x / k;
  for (long long i = rank * kThreads + tid; i < two_c1; i += k * kThreads) {
    double s = 0.0;
    long long r = 0;
    for (; r + kFinishLoads <= rows_out; r += kFinishLoads) {
      double v[kFinishLoads];
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) v[u] = __ldcg(a.part + (r + u) * two_c1 + i);
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) s += v[u];
    }
    for (; r < rows_out; ++r) s += __ldcg(a.part + r * two_c1 + i);
    a.out[i] = static_cast<float>(s);
  }
  if (rank == 0 && tid == 0) *a.ticket = 0u;  // ready for the next launch on this stream
}

// The ring: one thread copies stage after stage of the block's pixel range
// into shared memory; every thread reduces from there.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bn_moments_ring_kernel(const Args a) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.plan;
  const int tid = threadIdx.x;
  const int lane = tid % p.lanes, row = tid / p.lanes;
  const int c_first = blockIdx.y * p.width;
  const int gw = min(p.width, a.channels - c_first);
  const bool reads = row < p.rows && lane * V < gw;
  const int seg = gw * static_cast<int>(sizeof(T));  // bytes of a pixel's segment
  const int y_stage = align_up(static_cast<long long>(p.stage_pix) * p.width * sizeof(T), 128);
  const int stage_bytes = y_stage + align_up(p.stage_pix * 4, 128);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  const long long p_begin = static_cast<long long>(blockIdx.x) * p.chunk;
  const long long n_mine = max(0LL, min(p_begin + p.chunk, a.n_pix) - p_begin);
  const int n_stages = static_cast<int>((n_mine + p.stage_pix - 1) / p.stage_pix);
  const T* y = static_cast<const T*>(a.y);

  auto load_stage = [&](int it) {  // one thread: stage `it` into its ring slot
    const int s = it % kStages;
    const long long p0 = p_begin + static_cast<long long>(it) * p.stage_pix;
    const int count = static_cast<int>(min(static_cast<long long>(p.stage_pix), n_mine -
                                           static_cast<long long>(it) * p.stage_pix));
    T* ys = reinterpret_cast<T*>(ring + s * stage_bytes);
    float* ms = reinterpret_cast<float*>(ring + s * stage_bytes + y_stage);
    const int m_bulk = count & ~3;  // a ragged end of m (< 4 pixels) by hand
    for (int q = m_bulk; q < count; ++q) ms[q] = a.m[p0 + q];
    mbar_expect_tx(&bars[s], static_cast<unsigned>(count) * seg + m_bulk * 4u);
    if (p.groups == 1) {
      bulk_copy(ys, y + p0 * a.channels, static_cast<unsigned>(count) * seg, &bars[s]);
    } else {
      for (int q = 0; q < count; ++q) {
        bulk_copy(ys + q * gw, y + (p0 + q) * a.channels + c_first, seg, &bars[s]);
      }
    }
    if (m_bulk) bulk_copy(ms, a.m + p0, m_bulk * 4u, &bars[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int it = 0; it < kStages && it < n_stages; ++it) load_stage(it);
  }
  __syncthreads();

  Acc<T> acc;
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % kStages;
    mbar_wait(&bars[s], static_cast<unsigned>(it / kStages) & 1u);
    const int count = static_cast<int>(min(static_cast<long long>(p.stage_pix), n_mine -
                                           static_cast<long long>(it) * p.stage_pix));
    const T* ys = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const float* ms = reinterpret_cast<const float*>(ring + s * stage_bytes + y_stage);
    if (reads) {
      for (int q = row; q < count; q += p.rows) {
        float v[V];
        Vec<T>::load_shared(ys + q * gw + lane * V, v);
        acc.add(v, ms[q]);
      }
    }
    __syncthreads();  // stage s is read: refill it
    if (tid == 0 && it + kStages < n_stages) load_stage(it + kStages);
  }
  combine<T>(a, acc, reinterpret_cast<float*>(ring));
}

template <typename T>
int launch_forward(Args a, cudaStream_t s) {
  const Plan& p = a.plan;
  if (p.blocks > 0x7fffffffLL || p.groups > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  void (*kernel)(const Args) = bn_moments_ring_kernel<T>;
  // above 48 KB a kernel must opt in, once per device
  static unsigned opted = 0u;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(opted & (1u << dev))) {
    const int err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
    if (err != 0) return err;
    opted |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.groups), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// ---- the backward --------------------------------------------------------
constexpr int kBackwardUnroll = 4;
constexpr long long kBackwardBlocks = 132 * 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_moments_backward_kernel(const T* __restrict__ y, const float* __restrict__ m,
                           const float* __restrict__ g1, const float* __restrict__ g2,
                           T* __restrict__ dy, long long n_pix, int channels, int lanes,
                           int rows, int width) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int lane = tid % lanes, row = tid / lanes;
  const int c0 = blockIdx.y * width + lane * V;
  if (row >= rows || c0 >= channels) return;
  float a[V], b[V];  // g1 and 2 g2 of this thread's channels
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = __ldg(g1 + c0 + j);
    b[j] = 2.f * __ldg(g2 + c0 + j);  // exact
  }
  const long long stride = static_cast<long long>(gridDim.x) * rows;
  for (long long q0 = static_cast<long long>(blockIdx.x) * rows + row; q0 < n_pix;
       q0 += stride * kBackwardUnroll) {
    float v[kBackwardUnroll][V], mv[kBackwardUnroll];
#pragma unroll
    for (int u = 0; u < kBackwardUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q < n_pix) {
        mv[u] = __ldg(m + q);
        Vec<T>::load(y + q * channels + c0, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBackwardUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q < n_pix) {
        float d[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          d[j] = __fmul_rn(mv[u], __fadd_rn(a[j], __fmul_rn(b[j], v[u][j])));
        }
        Vec<T>::store(dy + q * channels + c0, d);
      }
    }
  }
}

template <typename T>
int launch_backward(const void* y, const void* m, const void* g1, const void* g2, void* dy,
                    long long n_pix, int channels, cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  const int slots = channels / V;
  const int lanes = slots < kThreads ? slots : kThreads;
  const int rows = kThreads / lanes;
  const int width = lanes * V;
  const int groups = (channels + width - 1) / width;
  long long blocks = (n_pix + rows - 1) / rows;
  const long long cap = (kBackwardBlocks + groups - 1) / groups;
  if (blocks > cap) blocks = cap;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  bn_moments_backward_kernel<T><<<dim3(static_cast<unsigned>(blocks), groups), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(m), static_cast<const float*>(g1),
      static_cast<const float*>(g2), static_cast<T*>(dy), n_pix, channels, lanes, rows, width);
  return static_cast<int>(cudaGetLastError());
}

int vec_of(int is_bf16) { return is_bf16 ? Vec<Bf16>::N : Vec<float>::N; }

Plan plan_of(long long n_pix, int channels, int is_bf16) {
  return make_plan(n_pix, channels, vec_of(is_bf16), is_bf16 ? 2 : 4);
}

bool takes(const void* y, const void* m, long long n_pix, int channels, int is_bf16) {
  return n_pix > 0 && channels > 0 && channels % vec_of(is_bf16) == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
}

}  // namespace

extern "C" {

// Channels one thread loads at once: the wrapper refuses C % this != 0.
int bn_moments_vector_width(int is_bf16) { return vec_of(is_bf16); }

// Bytes of scratch the forward needs: a 16-byte ticket word, then one f64
// row of (2C + 1) partials per cluster.  The wrapper zeroes it once.
long long bn_moments_scratch_bytes(long long n_pix, int channels, int is_bf16) {
  const Plan p = plan_of(n_pix, channels, is_bf16);
  return 16 + p.blocks / p.cluster * (2LL * channels + 1) * 8;
}

// The forward's launch plan, for the wrapper's records: {grid.x, grid.y,
// cluster, chunk, stage pixels, shared bytes}.
void bn_moments_plan(long long n_pix, int channels, int is_bf16, long long* out6) {
  const Plan p = plan_of(n_pix, channels, is_bf16);
  out6[0] = p.blocks; out6[1] = p.groups; out6[2] = p.cluster;
  out6[3] = p.chunk; out6[4] = p.stage_pix; out6[5] = p.smem;
}

// One launch on `stream`; returns a CUDA error code (0 = ok).
// y: (n_pix, channels) f32, or bf16 when is_bf16, 16-byte aligned, with
// channels a multiple of bn_moments_vector_width; m: (n_pix,) f32, 16-byte
// aligned; scratch: bn_moments_scratch_bytes() bytes, zeroed when allocated
// and used by one stream only; out: (2 * channels + 1) f32 = [s1, s2, s0].
int bn_moments_forward(const void* y, const void* m, void* scratch, void* out,
                       long long n_pix, int channels, int is_bf16, void* stream) {
  if (!takes(y, m, n_pix, channels, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.y = y;
  a.m = static_cast<const float*>(m);
  a.ticket = static_cast<unsigned*>(scratch);
  a.part = reinterpret_cast<double*>(static_cast<unsigned char*>(scratch) + 16);
  a.out = static_cast<float*>(out);
  a.n_pix = n_pix;
  a.channels = channels;
  a.plan = plan_of(n_pix, channels, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_forward<Bf16>(a, s) : launch_forward<float>(a, s);
}

// dy = m (g1 + 2 g2 y), one launch on `stream`; returns a CUDA error code.
// y, dy: (n_pix, channels) in y's dtype, 16-byte aligned; m: (n_pix,) f32;
// g1, g2: (channels,) f32.
int bn_moments_backward(const void* y, const void* m, const void* g1, const void* g2,
                        void* dy, long long n_pix, int channels, int is_bf16, void* stream) {
  if (!takes(y, m, n_pix, channels, is_bf16) || reinterpret_cast<uintptr_t>(dy) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_backward<Bf16>(y, m, g1, g2, dy, n_pix, channels, s)
                 : launch_backward<float>(y, m, g1, g2, dy, n_pix, channels, s);
}

}  // extern "C"
