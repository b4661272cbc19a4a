// Decode attention partials over the contiguous INT8 KV cache, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_flat_decode_kernel
// (built by _decode_flat, reached through quant_attention_decode[_partials]).
// One query token per (batch row, q head) attends over its row's int8 cache
// (B, H_kv, T, D) with one float32 scale row per token block (nb = T / bs
// rows) or per channel (nb = 1); token t dequantizes as q * scale[t / bs].
// Slot t is live when t < min(len, T) and its ring age (len - 1 - t) mod T
// is below the row's window. Outputs are the unnormalized online-softmax
// partials (o, m, l), merged by the caller with the fp residual tail or
// normalized; a row with no live slot gives o = 0, m = -1e30, l = 0.
//
// Bound on an H100: memory. Each live K/V byte and scale row is read once
// and the work per byte is a few flops for the G (= 2 on internlm2) queries
// of a GQA group, far under the ~20 flop/byte the card needs in float32.
// Design (that of paged_decode.cu with contiguous rows in place of the page
// table, and the same tile fold, decode_tile.cuh): one block per (kv head,
// row), 128 threads. The G queries sit in shared memory; the block walks
// only the row's ceil(min(len, T) / 64) live 64-token tiles (a last partial
// tile is masked, so T need not be a tile multiple), each read once with
// 4-byte loads along D, dequantized to float32 into shared memory and folded
// into the float32 online-softmax state.
// Simple first: B * H_kv blocks leave most SMs idle at small batch; splitting
// the token walk across blocks (flash-decoding) is later work.
#include "decode_tile.cuh"

namespace {

using decode::kThreads;
using decode::kTile;

// Slot t (< min(len, T)) is inside the window: ring age below `window`.
__device__ __forceinline__ bool in_window(int len, int t, int T, int window) {
  return (len - 1 - t) % T < window;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flat_decode_kernel(
    const float* __restrict__ q,       // (B, H, D)
    const int8_t* __restrict__ kq,     // (B, H_kv, T, D)
    const float* __restrict__ ks,      // (B, H_kv, nb, D)
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    const int* __restrict__ lengths,   // (B,)
    const int* __restrict__ windows,   // (B,)
    float* __restrict__ o,             // (B, H, D)
    float* __restrict__ m_out,         // (B, H)
    float* __restrict__ l_out,         // (B, H)
    int H, int Hkv, int G, int T, int nb, float scale) {
  extern __shared__ float smem[];
  const decode::Smem<D> s(smem, G);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[b], window = windows[b];
  const int n_slots = window > 0 ? min(len, T) : 0;
  const int bs = T / nb;             // tokens per scale row
  const size_t row = static_cast<size_t>(b) * Hkv + h;
  const int8_t* kp = kq + row * T * D;
  const int8_t* vp = vq + row * T * D;
  const float* ksr = ks + row * nb * D;
  const float* vsr = vs + row * nb * D;
  const size_t qoff = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * D;
  decode::init(s, q + qoff, G);

  for (int j0 = 0; j0 < n_slots; j0 += kTile) {
    const int nk = min(kTile, n_slots - j0);
    for (int i = tid; i < nk * (D / 4); i += kThreads) {
      const int j = i / (D / 4), d = 4 * (i % (D / 4));
      const int t = j0 + j;
      const size_t off = static_cast<size_t>(t) * D + d;
      const size_t soff = static_cast<size_t>(t / bs) * D + d;
      const char4 kc = *reinterpret_cast<const char4*>(kp + off);
      const char4 vc = *reinterpret_cast<const char4*>(vp + off);
      const float4 k4 = *reinterpret_cast<const float4*>(ksr + soff);
      const float4 v4 = *reinterpret_cast<const float4*>(vsr + soff);
      float* kr = s.kt + j * (D + 1) + d;
      kr[0] = static_cast<float>(kc.x) * k4.x;
      kr[1] = static_cast<float>(kc.y) * k4.y;
      kr[2] = static_cast<float>(kc.z) * k4.z;
      kr[3] = static_cast<float>(kc.w) * k4.w;
      *reinterpret_cast<float4*>(s.vt + j * D + d) =
          make_float4(static_cast<float>(vc.x) * v4.x, static_cast<float>(vc.y) * v4.y,
                      static_cast<float>(vc.z) * v4.z, static_cast<float>(vc.w) * v4.w);
    }
    decode::fold_tile(s, G, nk, scale,
                      [&](int j) { return in_window(len, j0 + j, T, window); });
  }
  decode::store(s, o, m_out, l_out, qoff, static_cast<size_t>(b) * H + h * G, G);
}

template <int D>
cudaError_t launch(const float* q, const int8_t* kq, const float* ks, const int8_t* vq,
                   const float* vs, const int* lengths, const int* windows, float* o,
                   float* m, float* l, int B, int H, int Hkv, int T, int nb, float scale,
                   cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int G = H / Hkv;
  const size_t smem = decode::Smem<D>::bytes(G);
  cudaError_t e = allow_smem(flat_decode_kernel<D>, smem, allowed);
  if (e != cudaSuccess) return e;
  flat_decode_kernel<D><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      q, kq, ks, vq, vs, lengths, windows, o, m, l, H, Hkv, G, T, nb, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flat_decode_partials(const float* q, const int8_t* kq, const float* ks,
                                    const int8_t* vq, const float* vs, const int* lengths,
                                    const int* windows, float* o, float* m, float* l,
                                    int B, int H, int Hkv, int D, int T, int nb,
                                    float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H % Hkv || T <= 0 || nb <= 0 || T % nb)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, T, nb,
                        scale, s);
    case 32:
      return launch<32>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, T, nb,
                        scale, s);
    case 64:
      return launch<64>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, T, nb,
                        scale, s);
    case 128:
      return launch<128>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, T, nb,
                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
