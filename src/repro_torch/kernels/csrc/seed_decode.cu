// The seed baseline of decode attention over the contiguous INT8 KV cache,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_decode_kernel
// (built by _decode_single, reached through
// quant_attention_decode_partials_vmap, one launch per (batch row, kv head)
// under vmap). It computes what flat_decode.cu computes (flat_walk.cuh) and
// keeps the baseline's cost profile: every block walks EVERY 64-token tile
// of T and masks the dead slots, as the vmap lowering turns the reference's
// compute skip into a select that still reads and computes each tile. One
// launch serves all B * H_kv pairs.
//
// Bound on an H100: memory, as flat_decode.cu, but the bytes it moves are
// the whole cache (B * H_kv * T * D per K and V), not the live part; the gap
// between the two at mixed lengths is what the flat kernel's dead-tile skip
// buys. It exists to be timed beside flat_decode, not to serve.
#include "flat_walk.cuh"

extern "C" int seed_decode_partials(const float* q, const int8_t* kq, const float* ks,
                                    const int8_t* vq, const float* vs, const int* lengths,
                                    const int* windows, float* o, float* m, float* l,
                                    int B, int H, int Hkv, int D, int T, int nb,
                                    float scale, void* stream) {
  return flat::dispatch<false>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, D,
                               T, nb, scale, stream);
}
