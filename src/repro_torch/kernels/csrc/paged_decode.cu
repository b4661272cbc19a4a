// Paged decode attention partials over a quantized KV page pool, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_paged_decode_kernel
// (built by _paged_decode, reached through paged_attention_decode_partials).
// One query token per batch row attends over the row's live pages through its
// page table; the output is the unnormalized online-softmax state (o, m, l),
// merged by the caller with the row's fp residual tail.
//
// Bound on an H100: memory. Each live K/V byte and scale row is read once and
// the work per byte is a few flops for the G (= 2 on internlm2) queries of a
// GQA group, far under the ~20 flop/byte the card needs in float32.
// Design: one block per (kv head, row), 128 threads. The G queries sit in
// shared memory; the block walks only the row's ceil(len / ps) live pages
// (never the table tail) and, inside a page, only tokens below `len`, in
// 64-token tiles. A tile is read once, coalesced along D, dequantized to
// float32 into shared memory, and folded into the float32 online-softmax
// state (decode_tile.cuh, shared with flat_decode.cu). Simple first: with
// B * H_kv blocks a small batch leaves most SMs idle; splitting the page walk
// across blocks (flash-decoding) is later work.
#include "decode_tile.cuh"

namespace {

using decode::kThreads;
using decode::kTile;

template <int D, int KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q,          // (B, H, D)
    const int8_t* __restrict__ kq,        // (P, ps_packed, H_kv, D)
    const float* __restrict__ ks,         // (P, H_kv, D)
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    const int* __restrict__ page_table,   // (B, NT)
    const int* __restrict__ lengths,      // (B,)
    float* __restrict__ o,                // (B, H, D)
    float* __restrict__ m_out,            // (B, H)
    float* __restrict__ l_out,            // (B, H)
    int H, int Hkv, int G, int ps, int ps_packed, int NT, float scale) {
  extern __shared__ float smem[];
  const decode::Smem<D> s(smem, G);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[b];
  const int row_stride = Hkv * D;
  const size_t qoff = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  decode::init(s, q + qoff, G);
  int n_pages = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pages > NT) n_pages = NT;

  for (int t = 0; t < n_pages; ++t) {
    const int pid = page_table[b * NT + t];
    const size_t page_off = static_cast<size_t>(pid) * ps_packed * row_stride + h * D;
    const int8_t* kp = kq + page_off;
    const int8_t* vp = vq + page_off;
    const float* ksr = ks + (static_cast<size_t>(pid) * Hkv + h) * D;
    const float* vsr = vs + (static_cast<size_t>(pid) * Hkv + h) * D;
    const int page_live = min(ps, len - t * ps);
    for (int j0 = 0; j0 < page_live; j0 += kTile) {
      const int nk = min(kTile, page_live - j0);
      for (int i = tid; i < nk * D; i += kThreads) {
        const int j = i / D, d = i % D;
        s.kt[j * (D + 1) + d] = page_value<KV>(kp, j0 + j, row_stride, d) * ksr[d];
        s.vt[j * D + d] = page_value<KV>(vp, j0 + j, row_stride, d) * vsr[d];
      }
      decode::fold_tile(s, G, nk, scale, [](int) { return true; });
    }
  }
  decode::store(s, o, m_out, l_out, qoff, static_cast<size_t>(b) * H + h * G, G);
}

template <int D, int KV>
cudaError_t launch(const float* q, const void* kq, const float* ks, const void* vq,
                   const float* vs, const int* page_table, const int* lengths, float* o,
                   float* m, float* l, int B, int H, int Hkv, int ps, int ps_packed,
                   int NT, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int G = H / Hkv;
  const size_t smem = decode::Smem<D>::bytes(G);
  cudaError_t e = allow_smem(paged_decode_kernel<D, KV>, smem, allowed);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<D, KV><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      q, static_cast<const int8_t*>(kq), ks, static_cast<const int8_t*>(vq), vs,
      page_table, lengths, o, m, l, H, Hkv, G, ps, ps_packed, NT, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fmt(int kv, const float* q, const void* kq, const float* ks,
                       const void* vq, const float* vs, const int* pt, const int* len,
                       float* o, float* m, float* l, int B, int H, int Hkv, int ps,
                       int ps_packed, int NT, float scale, cudaStream_t s) {
  switch (kv) {
    case KV_INT8:
      return launch<D, KV_INT8>(q, kq, ks, vq, vs, pt, len, o, m, l, B, H, Hkv, ps,
                                ps_packed, NT, scale, s);
    case KV_FP8:
      return launch<D, KV_FP8>(q, kq, ks, vq, vs, pt, len, o, m, l, B, H, Hkv, ps,
                               ps_packed, NT, scale, s);
    case KV_INT4:
      return launch<D, KV_INT4>(q, kq, ks, vq, vs, pt, len, o, m, l, B, H, Hkv, ps,
                                ps_packed, NT, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_partials(const float* q, const void* kq, const float* ks,
                                     const void* vq, const float* vs,
                                     const int* page_table, const int* lengths,
                                     float* o, float* m, float* l, int B, int H,
                                     int Hkv, int D, int ps, int ps_packed, int NT,
                                     int kv_format, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_fmt<16>(kv_format, q, kq, ks, vq, vs, page_table, lengths, o, m, l,
                            B, H, Hkv, ps, ps_packed, NT, scale, s);
    case 32:
      return launch_fmt<32>(kv_format, q, kq, ks, vq, vs, page_table, lengths, o, m, l,
                            B, H, Hkv, ps, ps_packed, NT, scale, s);
    case 64:
      return launch_fmt<64>(kv_format, q, kq, ks, vq, vs, page_table, lengths, o, m, l,
                            B, H, Hkv, ps, ps_packed, NT, scale, s);
    case 128:
      return launch_fmt<128>(kv_format, q, kq, ks, vq, vs, page_table, lengths, o, m,
                             l, B, H, Hkv, ps, ps_packed, NT, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
