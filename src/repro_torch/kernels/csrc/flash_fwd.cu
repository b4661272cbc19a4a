// Flash-attention forward (training forward and contiguous prefill), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_fwd.py::_fwd_kernel (entry
// flash_prefill), with the numerics of the path it serves on the card,
// repro/models/flash.py::flash_attention: queries are scaled by rsqrt(D) in
// float32 and rounded to the input type, logits are products of input-typed
// values summed in float32, probabilities are rounded to the input type
// before P.V and the sums run in float32. q (B, H, S, D), k/v (B, H_kv, T, D),
// float32 or bfloat16 -> out (B, H, S, D) float32 and the row statistics
// m (running max) and l (softmax denominator, at least 1e-30),
// (B, H_kv, G, S) float32, which the backward needs. Query i (absolute
// position kv_offset + i) sees key j when j <= kv_offset + i (causal) and
// j > kv_offset + i - window (window > 0).
//
// Bound on an H100: operations. Every live (query, key) pair costs 4 * D
// flops against K/V read once per query tile; at S = T = 2048 causal that is
// 69 GFLOP for 67 MB. This first version does them as float32 FMAs on the
// CUDA cores (67 TFLOP/s peak), not on the tensor cores (wgmma is later work).
// Design (that of paged_prefill.cu): grid (ceil(S / (64 / G)), H_kv, B), 256
// threads. A block holds a 64-row query tile in shared memory: the G heads of
// one GQA group at the same 64 / G positions, so each K/V tile it loads
// serves the whole group and the causal frontier is one number for the tile.
// It streams 64-key tiles converted to float32 into shared memory, walking
// only from the window's first live key to the tile's causal frontier (what
// skip_dead does on the TPU; any S and T, the ragged edge masked). Each thread
// owns a 4 x 4 block of the 64 x 64 logit tile and a 4 x (D / 16) block of the
// output accumulator in registers; the online-softmax state is per row in
// shared memory. Tiles run from the heaviest (last) query tile down.
#include <cuda_bf16.h>

#include "page_dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows per block (G heads x 64 / G positions)
constexpr int kKeys = 64;   // keys per shared-memory tile

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded (to nearest even) to T's precision, as float32
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
struct Smem {
  static constexpr int q = kRows * (D + 1);  // padded: no bank conflicts
  static constexpr int k = kKeys * (D + 1);
  static constexpr int v = kKeys * D;
  static constexpr int s = kRows * (kKeys + 1);
  static constexpr size_t bytes = sizeof(float) * (q + k + v + s + 3 * kRows)
                                  + sizeof(int) * kRows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,   // (B, H, S, D)
    const T* __restrict__ k,   // (B, H_kv, T, D)
    const T* __restrict__ v,
    float* __restrict__ out,   // (B, H, S, D)
    float* __restrict__ m_out, // (B, H_kv, G, S)
    float* __restrict__ l_out,
    int Hkv, int G, int S, int Tk, int causal, int window, int kv_offset,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::q;
  float* Vs = Ks + Smem<D>::k;
  float* Ss = Vs + Smem<D>::v;
  float* ms = Ss + Smem<D>::s;
  float* ls = ms + kRows;
  float* al = ls + kRows;
  int* qpos = reinterpret_cast<int*>(al + kRows);  // -1: row outside q

  const int npos = kRows / G;                       // positions per tile
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = qt * npos;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G;

  // row r: head g = r / npos of the group, position s0 + r % npos
  auto row_off = [&](int r) {
    const int g = r / npos, s = s0 + r % npos;
    return ((static_cast<size_t>(b) * H + static_cast<size_t>(h) * G + g) * S + s);
  };
  for (int r = tid; r < kRows; r += kThreads) {
    const int g = r / npos, s = s0 + r % npos;
    qpos[r] = (g < G && s < S) ? kv_offset + s : -1;
    ms[r] = -1e30f;
    ls[r] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] =
        qpos[r] >= 0 ? round_to<T>(to_f(q[row_off(r) * D + d]) * scale) : 0.f;
  }

  // the keys any row of the tile can see: [lo, hi)
  const int s_last = min(S, s0 + npos) - 1;
  const int hi = causal ? min(Tk, kv_offset + s_last + 1) : Tk;
  // lo on the 64-key grid, so the tiles are those of a walk from key 0
  const int lo =
      window > 0 ? max(0, kv_offset + s0 - window + 1) / kKeys * kKeys : 0;
  auto live = [&](int r, int kpos) {
    const int qp = qpos[r];
    if (qp < 0) return false;
    if (causal && kpos > qp) return false;
    return window <= 0 || kpos > qp - window;
  };

  float acc[4][D / 16] = {};
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + h) * Tk;
  for (int j0 = lo; j0 < hi; j0 += kKeys) {
    const int nk = min(kKeys, hi - j0);
    __syncthreads();  // the previous tile is consumed (and Qs / qpos written)
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const size_t src = (kv_base + j0 + j) * D + d;
      Ks[j * (D + 1) + d] = to_f(k[src]);
      Vs[j * D + d] = to_f(v[src]);
    }
    __syncthreads();

    float sc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // online softmax, one warp per row at a time, two keys per lane; l sums
    // the float32 probabilities, P.V takes them rounded to the input type
    for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
      const int r = warp * (kRows / (kThreads / 32)) + rr;
      float* row = Ss + r * (kKeys + 1);
      const bool l0 = lane < nk && live(r, j0 + lane);
      const bool l1 = lane + 32 < nk && live(r, j0 + lane + 32);
      const float x0 = l0 ? row[lane] : -1e30f;
      const float x1 = l1 ? row[lane + 32] : -1e30f;
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = l0 ? expf(x0 - m_new) : 0.f;
      const float p1 = l1 ? expf(x1 - m_new) : 0.f;
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        al[r] = a;
        ls[r] = ls[r] * a + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = al[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < nk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();  // ms / ls final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (qpos[r] < 0) continue;
    const float l = fmaxf(ls[r], 1e-30f);
    const size_t o = row_off(r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[o + tx + 16 * j] = acc[i][j] / l;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    if (qpos[r] < 0) continue;
    const int g = r / npos, s = s0 + r % npos;
    const size_t st = ((static_cast<size_t>(b) * Hkv + h) * G + g) * S + s;
    m_out[st] = ms[r];
    l_out[st] = fmaxf(ls[r], 1e-30f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, float* m,
                   float* l, int B, int Hkv, int G, int S, int Tk, int causal, int window,
                   int kv_offset, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, Smem<D>::bytes, allowed);
  if (e != cudaSuccess) return e;
  const int npos = kRows / G;
  const dim3 grid((S + npos - 1) / npos, Hkv, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, Smem<D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, m,
      l, Hkv, G, S, Tk, causal, window, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, float* out,
                     float* m, float* l, int B, int Hkv, int G, int S, int Tk, int causal,
                     int window, int kv_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window, kv_offset,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window, kv_offset,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window, kv_offset,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                            kv_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k and v alike)
extern "C" int flash_fwd(const void* q, const void* k, const void* v, float* out, float* m,
                         float* l, int B, int Hkv, int G, int S, int Tk, int D, int dtype,
                         int causal, int window, int kv_offset, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || G <= 0 || G > kRows || S <= 0 ||
      Tk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                           kv_offset, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                                   kv_offset, scale, s);
  return cudaErrorInvalidValue;
}
