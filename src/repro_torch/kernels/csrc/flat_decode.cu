// Decode attention partials over the contiguous INT8 KV cache, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_attention.py::_flat_decode_kernel
// (built by _decode_flat, reached through quant_attention_decode[_partials]).
// What it computes, and the block layout, are in flat_walk.cuh; this kernel
// walks only the row's live tiles.
//
// Bound on an H100: memory. Each live K/V byte and scale row is read once
// and the work per byte is a few flops for the G (= 2 on internlm2) queries
// of a GQA group, far under the ~20 flop/byte the card needs in float32.
// Design (that of paged_decode.cu with contiguous rows in place of the page
// table, and the same tile fold, decode_tile.cuh): one block per (kv head,
// row), 128 threads. The block walks only the row's ceil(min(len, T) / 64)
// live 64-token tiles (a last partial tile is masked, so T need not be a
// tile multiple), each read once with 4-byte loads along D.
// Simple first: B * H_kv blocks leave most SMs idle at small batch; splitting
// the token walk across blocks (flash-decoding) is later work.
#include "flat_walk.cuh"

extern "C" int flat_decode_partials(const float* q, const int8_t* kq, const float* ks,
                                    const int8_t* vq, const float* vs, const int* lengths,
                                    const int* windows, float* o, float* m, float* l,
                                    int B, int H, int Hkv, int D, int T, int nb,
                                    float scale, void* stream) {
  return flat::dispatch<true>(q, kq, ks, vq, vs, lengths, windows, o, m, l, B, H, Hkv, D,
                              T, nb, scale, stream);
}
