// Paged varlen chunk-prefill attention over a quantized KV page pool, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_prefill.py::_prefill_kernel
// (built by _paged_prefill, reached through paged_attention_prefill). A chunk
// of C queries per batch row, the GQA group stacked as G*C rows (row r is
// chunk position r % C of head-group lane r / C) and pre-scaled by rsqrt(D),
// attends over the row's hist_len history tokens (read straight from the
// quantized pages through the page table, at most hist_blocks pages) and then
// over the chunk's own float32 K/V with causal and kpos < valid masking. The
// output is normalized; rows past `valid` are garbage the caller discards.
//
// Bound on an H100: operations once the history is long. Every query row
// meets every live key: 4 * D flops per (row, key) against one byte per key
// element read once for the whole row tile, so at C = 1024 the flops outrun
// the bytes by a wide margin. This first version does them as float32 FMAs
// on the CUDA cores (67 TFLOP/s peak), not on the tensor cores.
// Design: grid (ceil(G*C / 64), H_kv, B), 256 threads. A block holds a
// 64-row query tile in shared memory and streams 64-key tiles: history pages
// first (only the ceil(hist_len / ps) live pages, only tokens below
// hist_len, each byte dequantized once into a float32 shared tile), then the
// chunk's keys only up to the tile's last query position. Each thread owns a
// 4 x 4 block of the 64 x 64 logit tile and a 4 x (D / 16) block of the
// output accumulator in registers; the online-softmax state is per row in
// shared memory. 115 KB of dynamic shared memory at D = 128.
#include "page_dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per shared-memory tile

template <int D>
struct Smem {
  static constexpr int q = kRows * D;
  static constexpr int k = kKeys * (D + 1);  // padded: no bank conflicts
  static constexpr int v = kKeys * D;
  static constexpr int s = kRows * (kKeys + 1);
  static constexpr size_t bytes = sizeof(float) * (q + k + v + s + 3 * kRows);
};

// Fold one loaded key tile (nk keys in Ks/Vs) into the block's state.
// causal: chunk keys at kpos0 + c, masked by kpos <= qpos && kpos < valid;
// otherwise every one of the nk history keys is live.
template <int D>
__device__ __forceinline__ void fold_tile(const float* Qs, const float* Ks,
                                          const float* Vs, float* S, float* ms,
                                          float* ls, float* al, float (&acc)[4][D / 16],
                                          int nk, bool causal, int kpos0, int valid,
                                          int r0, int C) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  auto live = [&](int r, int c) {
    if (c >= nk) return false;
    if (!causal) return true;
    const int kpos = kpos0 + c;
    return kpos <= (r0 + r) % C && kpos < valid;
  };

  float s[4][4] = {};
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = s[i][j];
  __syncthreads();

  // online softmax, one warp per row at a time, two keys per lane
  for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
    const int r = warp * (kRows / (kThreads / 32)) + rr;
    float* row = S + r * (kKeys + 1);
    const bool l0 = live(r, lane), l1 = live(r, lane + 32);
    const float x0 = l0 ? row[lane] : -1e30f;
    const float x1 = l1 ? row[lane + 32] : -1e30f;
    const float m_prev = ms[r];
    const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
    const float p0 = l0 ? expf(x0 - m_new) : 0.f;
    const float p1 = l1 ? expf(x1 - m_new) : 0.f;
    row[lane] = p0;
    row[lane + 32] = p1;
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
    for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * (kKeys + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float v = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * v;
    }
  }
  __syncthreads();
}

template <int D, int KV>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ qg,        // (B, H_kv, GC, D) pre-scaled
    const float* __restrict__ kc,        // (B, H_kv, C, D)
    const float* __restrict__ vc,
    const int8_t* __restrict__ kq,       // (P, ps_packed, H_kv, D)
    const float* __restrict__ ks,        // (P, H_kv, D)
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    const int* __restrict__ page_table,  // (B, NT)
    const int* __restrict__ hist_len,    // (B,)
    const int* __restrict__ valid,       // (B,)
    float* __restrict__ out,             // (B, H_kv, GC, D)
    int Hkv, int GC, int C, int ps, int ps_packed, int NT, int hist_blocks) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::q;
  float* Vs = Ks + Smem<D>::k;
  float* S = Vs + Smem<D>::v;
  float* ms = S + Smem<D>::s;
  float* ls = ms + kRows;
  float* al = ls + kRows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, GC - r0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const int row_stride = Hkv * D;

  for (int i = tid; i < kRows * D; i += kThreads)
    Qs[i] = (i / D < nrows) ? qg[(bh * GC + r0) * D + i] : 0.f;
  for (int r = tid; r < kRows; r += kThreads) {
    ms[r] = -1e30f;
    ls[r] = 0.f;
  }
  float acc[4][D / 16] = {};
  const int hl = hist_len[b];
  const int vd = valid[b];
  int n_hist = hl > 0 ? (hl + ps - 1) / ps : 0;
  if (n_hist > hist_blocks) n_hist = hist_blocks;
  __syncthreads();

  // history: the row's live pages, dequantized tile by tile
  for (int t = 0; t < n_hist; ++t) {
    const int pid = page_table[b * NT + t];
    const size_t page_off = static_cast<size_t>(pid) * ps_packed * row_stride + h * D;
    const int8_t* kp = kq + page_off;
    const int8_t* vp = vq + page_off;
    const float* ksr = ks + (static_cast<size_t>(pid) * Hkv + h) * D;
    const float* vsr = vs + (static_cast<size_t>(pid) * Hkv + h) * D;
    const int page_live = min(ps, hl - t * ps);
    for (int j0 = 0; j0 < page_live; j0 += kKeys) {
      const int nk = min(kKeys, page_live - j0);
      for (int i = tid; i < nk * D; i += kThreads) {
        const int j = i / D, d = i % D;
        Ks[j * (D + 1) + d] = page_value<KV>(kp, j0 + j, row_stride, d) * ksr[d];
        Vs[j * D + d] = page_value<KV>(vp, j0 + j, row_stride, d) * vsr[d];
      }
      __syncthreads();
      fold_tile<D>(Qs, Ks, Vs, S, ms, ls, al, acc, nk, false, 0, vd, r0, C);
    }
  }

  // chunk: keys up to the tile's last query position, below `valid`
  const int r1 = r0 + nrows - 1;
  const int q_last = (r0 / C == r1 / C) ? r1 % C : C - 1;
  const int n_chunk = min(q_last + 1, vd);
  for (int j0 = 0; j0 < n_chunk; j0 += kKeys) {
    const int nk = min(kKeys, n_chunk - j0);
    for (int i = tid; i < nk * D; i += kThreads) {
      const size_t src = (bh * C + j0) * D + i;
      Ks[(i / D) * (D + 1) + i % D] = kc[src];
      Vs[i] = vc[src];
    }
    __syncthreads();
    fold_tile<D>(Qs, Ks, Vs, S, ms, ls, al, acc, nk, true, j0, vd, r0, C);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const float inv_l = 1.f / fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[(bh * GC + r0 + r) * D + tx + 16 * j] = acc[i][j] * inv_l;
  }
}

template <int D, int KV>
cudaError_t launch(const float* qg, const float* kc, const float* vc, const void* kq,
                   const float* ks, const void* vq, const float* vs, const int* pt,
                   const int* hl, const int* vd, float* out, int B, int Hkv, int GC,
                   int C, int ps, int ps_packed, int NT, int hist_blocks,
                   cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(paged_prefill_kernel<D, KV>, Smem<D>::bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((GC + kRows - 1) / kRows, Hkv, B);
  paged_prefill_kernel<D, KV><<<grid, kThreads, Smem<D>::bytes, stream>>>(
      qg, kc, vc, static_cast<const int8_t*>(kq), ks, static_cast<const int8_t*>(vq), vs,
      pt, hl, vd, out, Hkv, GC, C, ps, ps_packed, NT, hist_blocks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fmt(int kv, const float* qg, const float* kc, const float* vc,
                       const void* kq, const float* ks, const void* vq, const float* vs,
                       const int* pt, const int* hl, const int* vd, float* out, int B,
                       int Hkv, int GC, int C, int ps, int ps_packed, int NT,
                       int hist_blocks, cudaStream_t s) {
  switch (kv) {
    case KV_INT8:
      return launch<D, KV_INT8>(qg, kc, vc, kq, ks, vq, vs, pt, hl, vd, out, B, Hkv, GC,
                                C, ps, ps_packed, NT, hist_blocks, s);
    case KV_FP8:
      return launch<D, KV_FP8>(qg, kc, vc, kq, ks, vq, vs, pt, hl, vd, out, B, Hkv, GC,
                               C, ps, ps_packed, NT, hist_blocks, s);
    case KV_INT4:
      return launch<D, KV_INT4>(qg, kc, vc, kq, ks, vq, vs, pt, hl, vd, out, B, Hkv, GC,
                                C, ps, ps_packed, NT, hist_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_prefill(const float* qg, const float* kc, const float* vc,
                             const void* kq, const float* ks, const void* vq,
                             const float* vs, const int* page_table,
                             const int* hist_len, const int* valid, float* out, int B,
                             int Hkv, int GC, int C, int D, int ps, int ps_packed,
                             int NT, int hist_blocks, int kv_format, void* stream) {
  if (B <= 0 || Hkv <= 0 || C <= 0 || GC % C) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_fmt<16>(kv_format, qg, kc, vc, kq, ks, vq, vs, page_table, hist_len,
                            valid, out, B, Hkv, GC, C, ps, ps_packed, NT, hist_blocks, s);
    case 32:
      return launch_fmt<32>(kv_format, qg, kc, vc, kq, ks, vq, vs, page_table, hist_len,
                            valid, out, B, Hkv, GC, C, ps, ps_packed, NT, hist_blocks, s);
    case 64:
      return launch_fmt<64>(kv_format, qg, kc, vc, kq, ks, vq, vs, page_table, hist_len,
                            valid, out, B, Hkv, GC, C, ps, ps_packed, NT, hist_blocks, s);
    case 128:
      return launch_fmt<128>(kv_format, qg, kc, vc, kq, ks, vq, vs, page_table,
                             hist_len, valid, out, B, Hkv, GC, C, ps, ps_packed, NT,
                             hist_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
