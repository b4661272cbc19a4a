// Decode attention partials over the contiguous INT8 KV cache, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_flat_decode_kernel
// (built by _decode_flat, reached through quant_attention_decode[_partials]).
// One query token per (batch row, q head) attends over its row's int8 cache
// (B, H_kv, T, D) with one float32 scale row per token block (nb = T / bs
// rows) or per channel (nb = 1); token t dequantizes as q * scale[t / bs].
// Slot t is live when t < min(len, T) and its ring age (len - 1 - t) mod T
// is below the row's window. Outputs are the unnormalized online-softmax
// partials (o, m, l); a row with no live slot gives o = 0, m = -1e30, l = 0.
//
// Bound on an H100: memory. Each live K/V byte and scale row is read once
// and the work per byte is a few flops for the G (= 2 on internlm2) queries
// of a GQA group, far under the ~20 flop/byte the card needs in float32, so
// the logits and P.V stay float32 FMAs on the CUDA cores.
// Design: the split walk of flat_split.cuh (flash-decoding over the grid
// (kv head x query pair, row, split), 16-byte cp.async rows in a ring, scale
// rows in registers, then decode_split.cuh's merge), instantiated to copy
// only live slots: a dead slot's copy is skipped (zero-filled), a split past
// the row's live slots reads nothing and writes m = -1e30, l = 0, o = 0.
#include "flat_split.cuh"

extern "C" int flat_decode_partials(const float* q, const int8_t* kq, const float* ks,
                                    const int8_t* vq, const float* vs, const int* lengths,
                                    const int* windows, float* o, float* m, float* l,
                                    float* o_part, float* m_part, float* l_part, int B, int H,
                                    int Hkv, int D, int T, int nb, int tps, int nsplit,
                                    float scale, void* stream) {
  const FlatArgs a{q, kq, ks, vq, vs, lengths, windows, o, m, l, o_part, m_part, l_part,
                   B, H, Hkv, T, nb, tps, nsplit, scale};
  return flat_dispatch<false>(a, D, stream);
}
