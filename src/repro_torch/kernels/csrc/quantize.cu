// The paper's INT8 quantize/dequantize kernel family, for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/quantize.py:
//   absmax_kernel            _absmax_kernel                (per-channel pass 1)
//   quantize_scales_kernel   _quantize_with_scales_kernel  (per-channel pass 2)
//   quantize_blocked_kernel  _quantize_blocked_kernel      (per-block, one kernel)
//   dequantize_kernel        _dequantize_kernel
// Every kernel takes N matrices (N, T, D) at once (N = the product of the
// leading dims), row-major float32 input with D % 4 == 0.
//
// Bound on an H100: memory. Each element is a few operations per 4 + 1 bytes
// moved. A thread reads 16 bytes (a float4) of a row at a time; L such lanes
// side by side cover a slab of 4 L columns, kThreads / L rows a sweep, and a
// thread issues a batch of loads (kRegRows float4) before it uses the first.
// The per-channel pair cuts each (matrix, column slab) into chunks of T, one
// block a chunk; the wrapper's plans (quantize.absmax_plan, quantize_plan)
// pick the slab and the chunks from the shapes and the SM count. The
// absmax's chunks of one slab are one thread block cluster (at most 16
// blocks), sized so the grid is about one wave of the card (512 blocks of
// 32-column slabs at (32, 2048, 128) on 132 SMs). A block reduces its rows
// in registers, warp shuffles and shared memory, writes its row into the
// shared memory of the cluster's first block, and that block folds the
// rows after one cluster barrier and stores them: one launch, no fill, no
// atomics and no state kept between launches, so it replays in a CUDA
// graph. The quantize pass fills the card with 2 rows a thread and turns
// its slab's absmax into scales once a block.
// The blocked kernel reads each element from device memory once: a block
// owns a (token block, column slab) whole and keeps its rows in registers
// from the absmax to the quantize, so no block waits on another. The slab
// is as narrow as the rows need (L lanes of 16 bytes a row, kThreads / L
// rows a sweep, at most kRegRows sweeps: 8 lanes, 128-byte rows, at block
// 256) and narrower still where the grid would not fill the card; only a
// token block of more than 2048 rows (one lane) reads its last rows twice.
//
// Bitwise equal to the plain PyTorch versions: the scale a product with
// float32(1/127), values an IEEE division by it (__fdiv_rn), round half to
// even (__float2int_rn); max is order-free, so any partition of a
// reduction is exact; no fast-math anywhere. NaN and inf as the reference
// gives them: every max propagates NaN (max.NaN), so a channel holding one
// has a NaN absmax and scale, and a NaN quotient becomes 0 (__float2int_rn
// gives 0 for NaN; an inf saturates, then the integer clamp to +-127).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;                    // float4 columns: 128 floats
constexpr int kRowGroups = 8;                 // one warp each
constexpr int kThreads = kLanes * kRowGroups;
constexpr int kCols = 4 * kLanes;
constexpr int kRows = 64;                     // T rows per dequantize block
constexpr int kRegRows = 8;                   // loads a thread holds at once
constexpr int kMaxCluster = 16;               // blocks of one absmax slab's T
constexpr int kQmax = 127;
constexpr float kInvQmax = 1.f / 127.f;      // float32(1/127), folded exactly
constexpr float kEps = 1e-30f;

// max that returns NaN when either input is NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float4 abs_max4(float4 m, float4 v) {
  return make_float4(max_nan(m.x, fabsf(v.x)), max_nan(m.y, fabsf(v.y)),
                     max_nan(m.z, fabsf(v.z)), max_nan(m.w, fabsf(v.w)));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// s = max(absmax, eps) / 127 as the reference computes it when compiled:
// XLA turns the division by the constant into a product with float32(1/127)
__device__ __forceinline__ float scale_of(float absmax) {
  return __fmul_rn(max_nan(absmax, kEps), kInvQmax);
}

__device__ __forceinline__ float4 scale4(float4 a) {
  return make_float4(scale_of(a.x), scale_of(a.y), scale_of(a.z), scale_of(a.w));
}

__device__ __forceinline__ int quant1(float x, float s) {
  return max(-kQmax, min(kQmax, __float2int_rn(__fdiv_rn(x, s))));
}

// four int8 values of x / s, packed low byte first
__device__ __forceinline__ unsigned quant4(float4 v, float4 s) {
  return (quant1(v.x, s.x) & 0xff) | (quant1(v.y, s.y) & 0xff) << 8 |
         (quant1(v.z, s.z) & 0xff) << 16 | static_cast<unsigned>(quant1(v.w, s.w)) << 24;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int off) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, off),
                     __shfl_xor_sync(0xffffffffu, v.y, off),
                     __shfl_xor_sync(0xffffffffu, v.z, off),
                     __shfl_xor_sync(0xffffffffu, v.w, off));
}

// The block's max of m over the threads that share a lane (L lanes a row):
// the warp's rows by shuffles (lanes L apart share columns), then the
// warps through shared memory. Every thread gets its lane's result.
template <int L>
__device__ __forceinline__ float4 block_max(float4 m, float4 (*red)[L]) {
#pragma unroll
  for (int off = 16; off >= L; off /= 2) m = max4(m, shfl_xor4(m, off));
  if (threadIdx.x % 32 < L) red[threadIdx.x / 32][threadIdx.x % L] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max4(m, red[w][threadIdx.x % L]);
  return m;
}

// rows a chunk: T over the splits, rounded up to whole sweeps of RS rows
__host__ __device__ inline int chunk_rows(int T, int splits, int RS) {
  const int rows = (T + splits - 1) / splits;
  return (rows + RS - 1) / RS * RS;
}

// Column absmax of chunk y of (matrix z, slab x): rows [y * rows, +rows).
// Grid (slabs, chunks, N), the chunks of a slab one thread block cluster
// of (1, chunks, 1) (at most kMaxCluster). Each block reduces its chunk in
// registers, warp shuffles and shared memory; with one chunk it stores its
// row, else every block writes its row into the shared memory of the
// cluster's first block, and after a cluster barrier that block folds the
// rows and stores. The write waits on a barrier every block arrives at
// when it starts (a block's shared memory may be written only once it
// runs), which the walk has long passed. Nothing outlives the launch.
template <int L>
__global__ void __launch_bounds__(kThreads) absmax_kernel(
    const float* __restrict__ x, float* __restrict__ out, int T, int D, int rows) {
  constexpr int RS = kThreads / L;  // rows a sweep
  __shared__ float4 red[kThreads / 32][L];
  __shared__ float4 part[kMaxCluster][L];
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int col = blockIdx.x * 4 * L + 4 * lane;
  const bool in = col < D;
  const int t0 = blockIdx.y * rows, t1 = min(T, t0 + rows);
  const float* xc = x + static_cast<size_t>(blockIdx.z) * T * D + col;
  const bool split = gridDim.y > 1;
  if (split) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  float4 m = zero4();
  for (int t = t0 + row; in && t < t1; t += kRegRows * RS) {
    // a batch of rows t + k * RS: all loads issued before any is used
    float4 v[kRegRows];
#pragma unroll
    for (int k = 0; k < kRegRows; ++k) {
      const int tk = t + k * RS;
      v[k] = tk < t1 ? load4(xc + static_cast<size_t>(tk) * D) : zero4();
    }
#pragma unroll
    for (int k = 0; k < kRegRows; ++k) m = abs_max4(m, v[k]);
  }
  m = block_max<L>(m, red);
  float* o = out + static_cast<size_t>(blockIdx.z) * D + col;
  if (!split) {
    if (row == 0 && in) store4(o, m);
    return;
  }
  // the cluster spans the grid's y extent: block rank == blockIdx.y
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every block runs
  if (row == 0) *cluster.map_shared_rank(&part[blockIdx.y][lane], 0) = m;
  cluster.sync();
  if (blockIdx.y == 0 && row == 0 && in) {
    for (int r = 1; r < static_cast<int>(gridDim.y); ++r) m = max4(m, part[r][lane]);
    store4(o, m);
  }
}

template <int V>
__device__ __forceinline__ void store_words(int8_t* p, const unsigned (&w)[V]) {
  if constexpr (V == 1) *reinterpret_cast<unsigned*>(p) = w[0];
  else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Per-channel pass 2 on chunk y of (matrix z, slab x): a thread owns 4 V
// consecutive columns of a row (V float4 loads, one 4 V-byte store), L
// threads a row, kThreads / L rows a sweep. The block's first row of
// threads turns the absmax into the slab's scales once (chunk 0 stores
// them) while every thread's first batch of rows (kRegRows / V) is in
// flight; all of a batch's loads are issued before any is used.
template <int L, int V>
__global__ void __launch_bounds__(kThreads) quantize_scales_kernel(
    const float* __restrict__ x, const float* __restrict__ absmax,
    int8_t* __restrict__ q, float* __restrict__ scales, int T, int D, int rows) {
  constexpr int RS = kThreads / L, B = kRegRows / V;
  __shared__ float4 divisor[L * V];
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int col = blockIdx.x * 4 * V * L + 4 * V * lane;
  const bool in = col < D;
  const size_t mat = blockIdx.z;
  const int t0 = blockIdx.y * rows + row, t1 = min(T, static_cast<int>(blockIdx.y + 1) * rows);
  const int n = in && t0 < t1 ? (t1 - t0 + RS - 1) / RS : 0;  // rows of this thread
  const size_t base = mat * T * D + col;
  float4 v[B][V];
  auto load = [&](int b0) {  // rows t0 + (b0 + k) RS of this thread
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int t = t0 + (b0 + k) * RS;
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[k][j] = b0 + k < n ? load4(x + base + static_cast<size_t>(t) * D + 4 * j) : zero4();
    }
  };
  load(0);
  if (row == 0 && in) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float4 s = scale4(load4(absmax + mat * D + col + 4 * j));
      if (blockIdx.y == 0) store4(scales + mat * D + col + 4 * j, s);
      // the Pallas kernel clamps s again before dividing (quantize.py:50)
      divisor[lane * V + j] = make_float4(max_nan(s.x, kEps), max_nan(s.y, kEps),
                                          max_nan(s.z, kEps), max_nan(s.w, kEps));
    }
  }
  __syncthreads();
  float4 sc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sc[j] = divisor[lane * V + j];
  // the next batch's loads after this one's stores (the first batch's went
  // out before the barrier)
  for (int b = 0;;) {
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (b + k < n) {
        unsigned w[V];
#pragma unroll
        for (int j = 0; j < V; ++j) w[j] = quant4(v[k][j], sc[j]);
        store_words<V>(q + base + static_cast<size_t>(t0 + (b + k) * RS) * D, w);
      }
    }
    b += B;
    if (b >= n) break;
    load(b);
  }
}

// Per (token block y, channel): absmax over the block's bs rows, the scale
// row, then the block's int8 values. Grid (ceil(D / (4 L)), T / bs, N): a
// block owns a slab of 4 L columns of one token block, L lanes a row (16
// bytes each) and kThreads / L rows a sweep, and holds up to kRegRows
// sweeps in registers from the absmax to the quantize. Three blocks an SM
// leave it 80 registers a thread: without the hint ptxas keeps 64 and
// spills up to 44 bytes.
template <int L>
__global__ void __launch_bounds__(kThreads, 3) quantize_blocked_kernel(
    const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
    int T, int D, int bs) {
  constexpr int RS = kThreads / L;  // rows a sweep
  __shared__ float4 red[kThreads / 32][L];
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int col = blockIdx.x * 4 * L + 4 * lane;
  const bool in = col < D;
  const float* xb = x + (static_cast<size_t>(blockIdx.z) * T +
                         static_cast<size_t>(blockIdx.y) * bs) * D + col;
  int8_t* qb = q + (xb - x);

  // rows row + k * RS: all loads issued before any is used
  float4 v[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int t = row + k * RS;
    v[k] = in && t < bs ? load4(xb + static_cast<size_t>(t) * D) : zero4();
  }
  float4 m = zero4();
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) m = abs_max4(m, v[k]);
  // rows past the registers' sweeps are read again to quantize
  for (int t = row + kRegRows * RS; in && t < bs; t += RS)
    m = abs_max4(m, load4(xb + static_cast<size_t>(t) * D));
  m = block_max<L>(m, red);
  if (!in) return;
  const float4 s = scale4(m);
  if (row == 0)
    store4(scales + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * D + col, s);
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int t = row + k * RS;
    if (t < bs) *reinterpret_cast<unsigned*>(qb + static_cast<size_t>(t) * D) = quant4(v[k], s);
  }
  for (int t = row + kRegRows * RS; t < bs; t += RS) {
    const size_t off = static_cast<size_t>(t) * D;
    *reinterpret_cast<unsigned*>(qb + off) = quant4(load4(xb + off), s);
  }
}

template <int L>
cudaError_t launch_blocked(const float* x, int8_t* q, float* scales, int N, int T, int D,
                           int bs, cudaStream_t stream) {
  const dim3 grid((D + 4 * L - 1) / (4 * L), T / bs, N);
  quantize_blocked_kernel<L><<<grid, kThreads, 0, stream>>>(x, q, scales, T, D, bs);
  return cudaGetLastError();
}

// one cluster of (1, chunks, 1) blocks a slab: rank == blockIdx.y
template <int L>
cudaError_t launch_absmax(const float* x, float* out, int N, int T, int D, int splits,
                          cudaStream_t stream) {
  const int rows = chunk_rows(T, splits, kThreads / L);
  const int chunks = (T + rows - 1) / rows;
  if (chunks > 8) {  // past the portable cluster size
    const cudaError_t e = cudaFuncSetAttribute(
        absmax_kernel<L>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = chunks;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 4 * L - 1) / (4 * L), chunks, N);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, absmax_kernel<L>, x, out, T, D, rows);
}

template <int L, int V>
cudaError_t launch_scales(const float* x, const float* absmax, int8_t* q, float* scales, int N,
                          int T, int D, int splits, cudaStream_t stream) {
  const int rows = chunk_rows(T, splits, kThreads / L);
  const dim3 grid((D + 4 * V * L - 1) / (4 * V * L), (T + rows - 1) / rows, N);
  quantize_scales_kernel<L, V><<<grid, kThreads, 0, stream>>>(x, absmax, q, scales, T, D, rows);
  return cudaGetLastError();
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                       float d) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(a, b);
  p2[1] = __floats2bfloat162_rn(c, d);
}

// out = q * s, row t taking scale row t / (T / nb).
template <typename Out>
__global__ void __launch_bounds__(kThreads) dequantize_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scales, Out* __restrict__ out,
    int T, int D, int nb) {
  const int lane = threadIdx.x % kLanes, rg = threadIdx.x / kLanes;
  const int col = blockIdx.x * kCols + 4 * lane;
  if (col >= D) return;
  const int bs = T / nb;
  const size_t mat = static_cast<size_t>(blockIdx.z);
  const size_t base = mat * T * D + col;
  const float* srow = scales + mat * nb * D + col;
  const int t0 = blockIdx.y * kRows, t1 = min(T, t0 + kRows);
#pragma unroll 4
  for (int t = t0 + rg; t < t1; t += kRowGroups) {
    const size_t off = base + static_cast<size_t>(t) * D;
    const float4 s = load4(srow + static_cast<size_t>(t / bs) * D);
    const char4 v = *reinterpret_cast<const char4*>(q + off);
    store4(out + off, static_cast<float>(v.x) * s.x, static_cast<float>(v.y) * s.y,
           static_cast<float>(v.z) * s.z, static_cast<float>(v.w) * s.w);
  }
}

bool bad_shape(int N, int T, int D) {
  return N <= 0 || N > 65535 || T <= 0 || D <= 0 || D % 4 != 0;
}

dim3 grid_of(int N, int T, int D, int rows) {
  return dim3((D + kCols - 1) / kCols, (T + rows - 1) / rows, N);
}

}  // namespace

// lanes: 16-byte lanes a row, a power of two from 1 to 32; splits: chunks
// of T, 1 to kMaxCluster (the wrapper's quantize.absmax_plan picks both)
extern "C" int absmax_cols(const float* x, float* out, int N, int T, int D, int lanes,
                           int splits, void* stream) {
  if (bad_shape(N, T, D) || splits < 1 || splits > kMaxCluster) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_absmax<1>(x, out, N, T, D, splits, s);
    case 2: return launch_absmax<2>(x, out, N, T, D, splits, s);
    case 4: return launch_absmax<4>(x, out, N, T, D, splits, s);
    case 8: return launch_absmax<8>(x, out, N, T, D, splits, s);
    case 16: return launch_absmax<16>(x, out, N, T, D, splits, s);
    case 32: return launch_absmax<32>(x, out, N, T, D, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// lanes as above; vec: float4 loads a thread a row (1 or 2; D % (4 vec) ==
// 0); splits: chunks of T (the wrapper's quantize.quantize_plan picks the
// three)
extern "C" int quantize_with_scales(const float* x, const float* absmax, int8_t* q,
                                    float* scales, int N, int T, int D, int lanes, int vec,
                                    int splits, void* stream) {
  if (bad_shape(N, T, D) || vec < 1 || D % (4 * vec) || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QWS_CASE(L, V) \
  if (lanes == L && vec == V) return launch_scales<L, V>(x, absmax, q, scales, N, T, D, splits, s)
  QWS_CASE(1, 1); QWS_CASE(2, 1); QWS_CASE(4, 1); QWS_CASE(8, 1);
  QWS_CASE(16, 1); QWS_CASE(32, 1);
  QWS_CASE(1, 2); QWS_CASE(2, 2); QWS_CASE(4, 2); QWS_CASE(8, 2);
  QWS_CASE(16, 2); QWS_CASE(32, 2);
#undef QWS_CASE
  return cudaErrorInvalidValue;
}

// lanes: 16-byte lanes a row, a power of two from 1 to 32 (the wrapper's
// quantize.blocked_lanes picks it)
extern "C" int quantize_blocked(const float* x, int8_t* q, float* scales, int N, int T,
                                int D, int bs, int lanes, void* stream) {
  if (bad_shape(N, T, D) || bs <= 0 || T % bs || T / bs > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_blocked<1>(x, q, scales, N, T, D, bs, s);
    case 2: return launch_blocked<2>(x, q, scales, N, T, D, bs, s);
    case 4: return launch_blocked<4>(x, q, scales, N, T, D, bs, s);
    case 8: return launch_blocked<8>(x, q, scales, N, T, D, bs, s);
    case 16: return launch_blocked<16>(x, q, scales, N, T, D, bs, s);
    case 32: return launch_blocked<32>(x, q, scales, N, T, D, bs, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int dequantize(const int8_t* q, const float* scales, void* out, int N, int T,
                          int D, int nb, int out_bf16, void* stream) {
  if (bad_shape(N, T, D) || nb <= 0 || T % nb) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(N, T, D, kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        q, scales, static_cast<__nv_bfloat16*>(out), T, D, nb);
  else
    dequantize_kernel<float><<<grid, kThreads, 0, s>>>(q, scales, static_cast<float*>(out),
                                                        T, D, nb);
  return cudaGetLastError();
}
