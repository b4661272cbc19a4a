// The seed baseline of decode attention over the contiguous INT8 KV cache,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_decode_kernel
// (built by _decode_single, reached through
// quant_attention_decode_partials_vmap, one launch per (batch row, kv head)
// under vmap). It computes what flat_decode.cu computes and keeps the
// baseline's cost profile: under vmap(vmap) the reference's pallas_call
// gains the batch and head axes in its grid and its compute skip (pl.when)
// becomes a select, so it reads and computes every tile of T, the dead ones
// included. That is the one way the baseline differs from flat decode.
//
// Bound on an H100: memory, as flat_decode.cu, but the bytes it moves are
// the whole cache (B * H_kv * T * D per K and V, and every scale row), not
// the live part; the gap between the two at mixed lengths is what flat
// decode's dead-slot skip buys. It exists to be timed beside flat_decode,
// not to serve.
// Design: flat decode's split walk (flat_split.cuh: the grid (kv head x
// query pair, row, split) over the card, 16-byte cp.async rows in a ring,
// scale rows in registers, decode_split.cuh's merge), instantiated with
// kWalkAll: every slot of every split is copied and folded, a dead one
// masked in the fold (probability 0), never skipped. A split wholly past a
// row's live slots still reads its bytes.
#include "flat_split.cuh"

extern "C" int seed_decode_partials(const float* q, const int8_t* kq, const float* ks,
                                    const int8_t* vq, const float* vs, const int* lengths,
                                    const int* windows, float* o, float* m, float* l,
                                    float* o_part, float* m_part, float* l_part, int B, int H,
                                    int Hkv, int D, int T, int nb, int tps, int nsplit,
                                    float scale, void* stream) {
  const FlatArgs a{q, kq, ks, vq, vs, lengths, windows, o, m, l, o_part, m_part, l_part,
                   B, H, Hkv, T, nb, tps, nsplit, scale};
  return flat_dispatch<true>(a, D, stream);
}
