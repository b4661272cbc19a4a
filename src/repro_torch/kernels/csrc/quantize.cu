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
// moved. Design: a block covers 128 columns (32 lanes x one 16-byte float4
// load each, so a warp reads 512 contiguous bytes of a row) by 8 row groups
// of one warp; rows stride by 8 inside the block. Reductions over T run in
// registers, then shared memory, then (absmax only, whose T axis is split
// across blocks) an integer atomicMax on the float bits, which orders
// non-negative floats exactly.
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
// even (rintf); max is order-free, so any partition of a reduction is
// exact; no fast-math anywhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                    // float4 columns: 128 floats
constexpr int kRowGroups = 8;                 // one warp each
constexpr int kThreads = kLanes * kRowGroups;
constexpr int kCols = 4 * kLanes;
constexpr int kAbsmaxRows = 256;              // T rows per absmax block
constexpr int kRows = 64;                     // T rows per quantize/dequantize block
constexpr int kRegRows = 8;                   // sweeps a blocked-quantize thread holds
constexpr float kQmax = 127.f;
constexpr float kInvQmax = 1.f / 127.f;      // float32(1/127), folded exactly
constexpr float kEps = 1e-30f;

__device__ __forceinline__ float4 abs_max4(float4 m, float4 v) {
  return make_float4(fmaxf(m.x, fabsf(v.x)), fmaxf(m.y, fabsf(v.y)),
                     fmaxf(m.z, fabsf(v.z)), fmaxf(m.w, fabsf(v.w)));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// s = max(absmax, eps) / 127 as the reference computes it when compiled:
// XLA turns the division by the constant into a product with float32(1/127)
__device__ __forceinline__ float scale_of(float absmax) {
  return __fmul_rn(fmaxf(absmax, kEps), kInvQmax);
}

__device__ __forceinline__ int8_t quant1(float x, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ char4 quant4(float4 v, float4 s) {
  return make_char4(quant1(v.x, s.x), quant1(v.y, s.y), quant1(v.z, s.z),
                    quant1(v.w, s.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column absmax of rows [y * kAbsmaxRows, +kAbsmaxRows) of matrix z, folded
// into out (N, D), which the caller zeroes.
__global__ void __launch_bounds__(kThreads) absmax_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out,
                                                          int T, int D) {
  __shared__ float4 red[kRowGroups][kLanes];
  const int lane = threadIdx.x % kLanes, rg = threadIdx.x / kLanes;
  const int col = blockIdx.x * kCols + 4 * lane;
  const int t0 = blockIdx.y * kAbsmaxRows, t1 = min(T, t0 + kAbsmaxRows);
  const float* xm = x + static_cast<size_t>(blockIdx.z) * T * D;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < D) {
#pragma unroll 4
    for (int t = t0 + rg; t < t1; t += kRowGroups)
      m = abs_max4(m, load4(xm + static_cast<size_t>(t) * D + col));
  }
  red[rg][lane] = m;
  __syncthreads();
  if (rg != 0 || col >= D) return;
  for (int g = 1; g < kRowGroups; ++g) m = max4(m, red[g][lane]);
  int* o = reinterpret_cast<int*>(out + static_cast<size_t>(blockIdx.z) * D + col);
  atomicMax(o + 0, __float_as_int(m.x));
  atomicMax(o + 1, __float_as_int(m.y));
  atomicMax(o + 2, __float_as_int(m.z));
  atomicMax(o + 3, __float_as_int(m.w));
}

// Per-channel pass 2: scales from the absmax, then q = clip(rint(x / s)).
__global__ void __launch_bounds__(kThreads) quantize_scales_kernel(
    const float* __restrict__ x, const float* __restrict__ absmax,
    int8_t* __restrict__ q, float* __restrict__ scales, int T, int D) {
  const int lane = threadIdx.x % kLanes, rg = threadIdx.x / kLanes;
  const int col = blockIdx.x * kCols + 4 * lane;
  if (col >= D) return;
  const size_t mat = static_cast<size_t>(blockIdx.z);
  const float4 a = load4(absmax + mat * D + col);
  const float4 s = make_float4(scale_of(a.x), scale_of(a.y), scale_of(a.z), scale_of(a.w));
  if (blockIdx.y == 0 && rg == 0) *reinterpret_cast<float4*>(scales + mat * D + col) = s;
  // the Pallas kernel clamps s again before dividing (quantize.py:50)
  const float4 sc = make_float4(fmaxf(s.x, kEps), fmaxf(s.y, kEps), fmaxf(s.z, kEps),
                                fmaxf(s.w, kEps));
  const int t0 = blockIdx.y * kRows, t1 = min(T, t0 + kRows);
  const size_t base = mat * T * D + col;
#pragma unroll 4
  for (int t = t0 + rg; t < t1; t += kRowGroups) {
    const size_t off = base + static_cast<size_t>(t) * D;
    *reinterpret_cast<char4*>(q + off) = quant4(load4(x + off), sc);
  }
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int off) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, off),
                     __shfl_xor_sync(0xffffffffu, v.y, off),
                     __shfl_xor_sync(0xffffffffu, v.z, off),
                     __shfl_xor_sync(0xffffffffu, v.w, off));
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
  const int lane = threadIdx.x % L, row = threadIdx.x / L, warp = threadIdx.x / 32;
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
    v[k] = in && t < bs ? load4(xb + static_cast<size_t>(t) * D)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) m = abs_max4(m, v[k]);
  // rows past the registers' sweeps are read again to quantize
  for (int t = row + kRegRows * RS; in && t < bs; t += RS)
    m = abs_max4(m, load4(xb + static_cast<size_t>(t) * D));
  // the warp's rows (lanes L apart share columns), then the block's warps
#pragma unroll
  for (int off = 16; off >= L; off /= 2) m = max4(m, shfl_xor4(m, off));
  if (threadIdx.x % 32 < L) red[warp][lane] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max4(m, red[w][lane]);
  if (!in) return;
  const float4 s = make_float4(scale_of(m.x), scale_of(m.y), scale_of(m.z), scale_of(m.w));
  if (row == 0)
    *reinterpret_cast<float4*>(
        scales + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * D + col) = s;
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int t = row + k * RS;
    if (t < bs) *reinterpret_cast<char4*>(qb + static_cast<size_t>(t) * D) = quant4(v[k], s);
  }
  for (int t = row + kRegRows * RS; t < bs; t += RS) {
    const size_t off = static_cast<size_t>(t) * D;
    *reinterpret_cast<char4*>(qb + off) = quant4(load4(xb + off), s);
  }
}

template <int L>
cudaError_t launch_blocked(const float* x, int8_t* q, float* scales, int N, int T, int D,
                           int bs, cudaStream_t stream) {
  const dim3 grid((D + 4 * L - 1) / (4 * L), T / bs, N);
  quantize_blocked_kernel<L><<<grid, kThreads, 0, stream>>>(x, q, scales, T, D, bs);
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

extern "C" int absmax_cols(const float* x, float* out, int N, int T, int D, void* stream) {
  if (bad_shape(N, T, D)) return cudaErrorInvalidValue;
  absmax_kernel<<<grid_of(N, T, D, kAbsmaxRows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, out, T, D);
  return cudaGetLastError();
}

extern "C" int quantize_with_scales(const float* x, const float* absmax, int8_t* q,
                                    float* scales, int N, int T, int D, void* stream) {
  if (bad_shape(N, T, D)) return cudaErrorInvalidValue;
  quantize_scales_kernel<<<grid_of(N, T, D, kRows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, absmax, q, scales, T,
                                                                D);
  return cudaGetLastError();
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
