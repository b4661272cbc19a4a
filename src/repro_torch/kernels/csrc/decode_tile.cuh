// Used by the seed baseline alone (seed_decode.cu, through flat_walk.cuh):
// the shared memory of one (kv head, batch row) block and the fold of one
// dequantized tile of keys and values into the float32 online-softmax state
// of the G queries of a GQA group. The walk (tile loader and mask) is
// flat_walk.cuh's. Paged and flat decode have split walks of their own.
#pragma once

#include "page_dequant.cuh"

namespace decode {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 64;      // tokens per shared-memory tile

// One block's shared memory, carved from the dynamic buffer.
template <int D>
struct Smem {
  float* qs;   // G * D queries
  float* acc;  // G * D unnormalized output
  float* kt;   // kTile * (D + 1) keys, padded: no bank conflicts
  float* vt;   // kTile * D values
  float* st;   // G * kTile logits, then probabilities
  float* ms;   // G running max
  float* ls;   // G running sum
  float* al;   // G rescale factor of this tile

  __device__ Smem(float* base, int G)
      : qs(base), acc(qs + G * D), kt(acc + G * D), vt(kt + kTile * (D + 1)),
        st(vt + kTile * D), ms(st + G * kTile), ls(ms + G), al(ls + G) {}

  static size_t bytes(int G) {
    return sizeof(float) * (2 * G * D + kTile * (D + 1) + kTile * D + G * kTile + 3 * G);
  }
};

// Load the G queries at q, zero the output, and start the state at
// m = -1e30, l = 0 (what a row with no live slot keeps).
template <int D>
__device__ __forceinline__ void init(const Smem<D>& s, const float* __restrict__ q,
                                     int G) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    s.qs[i] = q[i];
    s.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    s.ms[g] = -1e30f;
    s.ls[g] = 0.f;
  }
  __syncthreads();
}

// Fold the tile the caller wrote into kt / vt (its first nk <= kTile slots)
// into the state. Slot j takes part when live(j); a dead slot gets logit
// -1e30 and probability 0. Logits are q . k * scale in float32.
template <int D, typename Live>
__device__ __forceinline__ void fold_tile(const Smem<D>& s, int G, int nk, float scale,
                                          Live live) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __syncthreads();  // the caller's tile is written
  for (int i = tid; i < G * kTile; i += kThreads) {
    const int g = i / kTile, j = i % kTile;
    if (j < nk) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += s.qs[g * D + d] * s.kt[j * (D + 1) + d];
      s.st[i] = live(j) ? dot * scale : -1e30f;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = -1e30f;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, s.st[g * kTile + j]);
    mx = warp_max(mx);
    const float m_prev = s.ms[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = live(j) ? expf(s.st[g * kTile + j] - m_new) : 0.f;
      s.st[g * kTile + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      s.al[g] = a;
      s.ls[g] = s.ls[g] * a + sum;
      s.ms[g] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = s.acc[i] * s.al[g];
    for (int j = 0; j < nk; ++j) a += s.st[g * kTile + j] * s.vt[j * D + d];
    s.acc[i] = a;
  }
  __syncthreads();  // kt / vt free for the next tile
}

// Write the unnormalized partials: o at o + qoff (G * D), m and l of the
// G rows starting at row r0 of (B * H).
template <int D>
__device__ __forceinline__ void store(const Smem<D>& s, float* __restrict__ o,
                                      float* __restrict__ m_out, float* __restrict__ l_out,
                                      size_t qoff, size_t r0, int G) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) o[qoff + i] = s.acc[i];
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_out[r0 + g] = s.ms[g];
    l_out[r0 + g] = s.ls[g];
  }
}

}  // namespace decode
