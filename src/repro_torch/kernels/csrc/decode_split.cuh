// Shared by the decode kernels that split a row's token walk across blocks
// (paged_decode.cu, flat_decode.cu; flash-decoding): the thread layout of a
// split, its queries and online-softmax state in registers, the
// dequantization of 16 bytes of a K/V row, the end of a split (its row
// groups merged through shared memory into one float32 partial (o, m, l)
// per query) and the kernel that merges a row's splits into the
// unnormalized (o, m, l) of the contract: m = max m_s, l = sum l_s
// e^(m_s - m), o = sum o_s e^(m_s - m). A split with nothing live (m_s =
// -1e30, l_s = 0, o_s = 0) adds nothing; a row with no live split keeps
// m = -1e30, l = 0, o = 0.
#pragma once

#include "page_dequant.cuh"

namespace {

constexpr int kThreads = 128;  // threads a split block
constexpr int kStages = 4;     // cp.async ring: kStages - 1 stages in flight

// A split block's layout over rows of D bytes (a token's K or V, or an int4
// page row of two tokens): CH threads share a row, 16 bytes each, a thread
// always the same 16 channels; RS rows a sweep, NR rows a thread a stage,
// SR rows a stage of the ring (K and V).
template <int D>
struct Walk {
  static constexpr int CH = D / 16;
  static constexpr int RS = kThreads / CH;
  static constexpr int NR = RS >= 64 ? 1 : 64 / RS;
  static constexpr int SR = RS * NR;
  static constexpr size_t stage_bytes = 2ull * SR * D;
  template <int GB>
  static constexpr size_t merge_bytes() {
    return sizeof(float) * (static_cast<size_t>(RS) * GB * (D + 2));
  }
  template <int GB>
  static constexpr size_t smem_bytes() {
    return kStages * stage_bytes > merge_bytes<GB>() ? kStages * stage_bytes
                                                     : merge_bytes<GB>();
  }
};

// This thread's slice (16 channels at q0 + g * D) of its GB queries, those
// below ng (others 0), and the online-softmax state of each: acc = 0,
// m = -1e30, l = 0 (what a query with nothing live keeps).
template <int GB>
__device__ __forceinline__ void init_queries(float (&qr)[GB][16], float (&acc)[GB][16],
                                             float (&m)[GB], float (&l)[GB],
                                             const float* __restrict__ q0, int D, int ng) {
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float4* src = reinterpret_cast<const float4*>(q0 + static_cast<size_t>(g) * D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < ng) x = src[j];
      qr[g][4 * j] = x.x;
      qr[g][4 * j + 1] = x.y;
      qr[g][4 * j + 2] = x.z;
      qr[g][4 * j + 3] = x.w;
    }
#pragma unroll
    for (int d = 0; d < 16; ++d) acc[g][d] = 0.f;
    m[g] = -1e30f;
    l[g] = 0.f;
  }
}

// Fold a stage's N logits a query (dead ones -inf) into the thread's online
// softmax: m and l move on, acc is rescaled, x becomes the probabilities.
template <int GB, int N>
__device__ __forceinline__ void fold_logits(float (&x)[GB][N], float (&m)[GB], float (&l)[GB],
                                            float (&acc)[GB][16]) {
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float mx = m[g];
#pragma unroll
    for (int j = 0; j < N; ++j) mx = fmaxf(mx, x[g][j]);
    const float a = expf(m[g] - mx);
    m[g] = mx;
    l[g] *= a;
#pragma unroll
    for (int d = 0; d < 16; ++d) acc[g][d] *= a;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      x[g][j] = expf(x[g][j] - mx);
      l[g] += x[g][j];
    }
  }
}

// the 16 values of token `tk` (0, or 1 for int4's high nibble) in 16 bytes
// of a packed page row, times their scales
template <int KV>
__device__ __forceinline__ void dequant16(const uint4& w, int tk, const float (&sc)[16],
                                          float (&x)[16]) {
  const int8_t* by = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    float f;
    if (KV == KV_INT4) {
      const int8_t b = by[d];
      f = static_cast<float>(tk ? (b >> 4)
                                : (static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4));
    } else if (KV == KV_FP8) {
      __nv_fp8_e4m3 e;
      e.__x = static_cast<__nv_fp8_storage_t>(by[d]);
      f = static_cast<float>(e);
    } else {
      f = static_cast<float>(by[d]);
    }
    x[d] = f * sc[d];
  }
}

// The end of a split. Each of the block's RS row groups holds, in the
// threads of its CH = D / 16 lanes (lane c owns channels c * 16 + [0, 16)),
// the online-softmax state of the GB queries qb * GB + [0, GB) of a GQA
// group: acc (unnormalized output), m, l. They are merged through `red`
// (shared memory of RS * GB * (D + 2) floats, free when called) into the
// split's partials: o_part (B * H, nsplit, D) and m_part / l_part
// (B * H, nsplit), query rows row0 + qb * GB + g below row0 + G.
template <int D, int GB, int RS>
__device__ __forceinline__ void store_split(float* red, const float (&acc)[GB][16],
                                            const float (&m)[GB], const float (&l)[GB], int rg,
                                            int c, int G, int qb, size_t row0, int sp,
                                            float* __restrict__ o_part,
                                            float* __restrict__ m_part,
                                            float* __restrict__ l_part) {
  const int nsplit = gridDim.z;
  float* red_m = red + RS * GB * D;
  float* red_l = red_m + RS * GB;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float4* dst = reinterpret_cast<float4*>(red + (rg * GB + g) * D + c * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[j] = make_float4(acc[g][4 * j], acc[g][4 * j + 1], acc[g][4 * j + 2], acc[g][4 * j + 3]);
    if (c == 0) {
      red_m[rg * GB + g] = m[g];
      red_l[rg * GB + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    if (qb * GB + g >= G) continue;
    float mb = -1e30f;
    for (int r = 0; r < RS; ++r) mb = fmaxf(mb, red_m[r * GB + g]);
    float ob = 0.f, lb = 0.f;
    for (int r = 0; r < RS; ++r) {
      const float w = expf(red_m[r * GB + g] - mb);
      ob += red[(r * GB + g) * D + d] * w;
      lb += red_l[r * GB + g] * w;
    }
    const size_t row = row0 + qb * GB + g;
    o_part[(row * nsplit + sp) * D + d] = ob;
    if (d == 0) {
      m_part[row * nsplit + sp] = mb;
      l_part[row * nsplit + sp] = lb;
    }
  }
}

// one block of D threads per (row, head): the splits' partials merged into
// the unnormalized (o, m, l) of the contract
__global__ void merge_splits_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ m_part,
                                    const float* __restrict__ l_part, float* __restrict__ o,
                                    float* __restrict__ m, float* __restrict__ l, int nsplit) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x, D = blockDim.x;
  const float* mp = m_part + row * nsplit;
  float mb = -1e30f;
  for (int s = 0; s < nsplit; ++s) mb = fmaxf(mb, mp[s]);
  float ob = 0.f, lb = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(mp[s] - mb);
    ob += o_part[(row * nsplit + s) * D + d] * w;
    lb += l_part[row * nsplit + s] * w;
  }
  o[row * D + d] = ob;
  if (d == 0) {
    m[row] = mb;
    l[row] = lb;
  }
}

}  // namespace
