// The split walk over the contiguous INT8 KV cache, shared by flat decode
// (flat_decode.cu, kWalkAll = false) and the seed baseline (seed_decode.cu,
// kWalkAll = true). One query token per (batch row, q head) attends over
// its row's int8 cache (B, H_kv, T, D) with one float32 scale row per token
// block (nb = T / bs rows) or per channel (nb = 1); token t dequantizes as
// q * scale[t / bs]. Slot t is live when t < min(len, T) and its ring age
// (len - 1 - t) mod T is below the row's window. Outputs are the
// unnormalized online-softmax partials (o, m, l); a row with no live slot
// gives o = 0, m = -1e30, l = 0.
//
// Design (flash-decoding, as paged_decode.cu with contiguous rows in place
// of the page table): the grid is (kv head x query pair, row, split). A split
// walks a fixed run of `tps` token slots of its row, writes float32 partials
// to scratch, and decode_split.cuh's merge kernel combines a row's splits
// (with one split the walk writes the outputs itself). The wrapper picks the
// split count from host-known shapes only (batch, kv heads, group, T, SM
// count), never from lengths or windows, so the launch adds no host sync.
// Inside a split, D / 16 threads share a token row (16 bytes each, coalesced
// along D) and a thread always handles the same 16 channels, so it holds
// their scale rows in registers (reloaded only when the token block changes),
// its queries and its slice of the output. Rows arrive by cp.async in a ring
// of kStages stages, kStages - 1 in flight while one is folded; each thread
// reads back only the bytes it copied itself, so the walk needs no barrier.
//
// kWalkAll = false (flat decode) copies only live slots: a dead slot's copy
// is skipped (zero-filled), and a split past the row's live slots reads
// nothing. kWalkAll = true (the seed baseline) copies and folds EVERY slot
// of the split, with its scale row, and masks the dead ones in the fold
// (logit -inf, probability 0), as the reference's vmap lowering turns its
// compute skip into a select that still reads and computes every tile.
//
// Head widths 16 to 256. At D 256 sixteen threads share a row and the ring
// of kStages stages of 64 K and V rows takes 128 KB (opted in by
// allow_smem). With GB = 2 queries a block, a GQA group of 16 (one kv head,
// recurrentgemma_9b) is 8 query blocks, each walking the whole row: K/V are
// read 8 times.
#pragma once

#include "cp_async.cuh"
#include "decode_split.cuh"

namespace {

// 16 floats at p (16-byte aligned) into registers
__device__ __forceinline__ void load16(float (&x)[16], const float* __restrict__ p) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(p)[j];
    x[4 * j] = a.x, x[4 * j + 1] = a.y, x[4 * j + 2] = a.z, x[4 * j + 3] = a.w;
  }
}

// grid (H_kv * nqb, B, nsplit); block (kv head h, query pair qb, row b,
// split sp) attends queries h * G + qb * GB + [0, GB) (those below G) over
// the live slots of [sp * tps, sp * tps + tps) of row b's cache.
template <int D, int GB, bool kWalkAll>
__global__ void __launch_bounds__(kThreads) flat_split_kernel(
    const float* __restrict__ q,       // (B, H, D)
    const int8_t* __restrict__ kq,     // (B, H_kv, T, D)
    const float* __restrict__ ks,      // (B, H_kv, nb, D)
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    const int* __restrict__ lengths,   // (B,)
    const int* __restrict__ windows,   // (B,)
    float* __restrict__ o_part,        // (B, H, nsplit, D)
    float* __restrict__ m_part,        // (B, H, nsplit)
    float* __restrict__ l_part,
    int H, int Hkv, int G, int T, int nb, int tps, float scale) {
  using W = Walk<D>;
  constexpr int CH = W::CH, RS = W::RS, NR = W::NR, SR = W::SR;
  extern __shared__ __align__(16) unsigned char fd_smem[];
  const int nqb = (G + GB - 1) / GB;
  const int h = blockIdx.x / nqb, qb = blockIdx.x % nqb;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / CH, c = tid % CH;

  const int len = lengths[b], window = windows[b];
  const int n_slots = window > 0 ? min(len, T) : 0;
  const int t_begin = sp * tps, t_end = min(t_begin + tps, n_slots);
  // the slots the split copies: the live ones, or all of the split
  const int w_end = kWalkAll ? min(t_begin + tps, T) : t_end;
  const int n_stages = t_begin < w_end ? (w_end - t_begin + SR - 1) / SR : 0;
  // slot t >= t_begin is live: written, in the split, inside the window
  auto live = [&](int t) { return t < t_end && (len - 1 - t) % T < window; };
  auto copied = [&](int t) { return kWalkAll ? t < w_end : live(t); };

  const size_t row = static_cast<size_t>(b) * Hkv + h;
  const int8_t* kp = kq + row * T * D + c * 16;
  const int8_t* vp = vq + row * T * D + c * 16;
  const float* ksr = ks + row * nb * D + c * 16;
  const float* vsr = vs + row * nb * D + c * 16;
  const int bs = T / nb;  // tokens a scale row

  auto stage_k = [&](int s) { return fd_smem + (s % kStages) * W::stage_bytes; };
  auto prefetch = [&](int s) {
    if (s < n_stages) {
      const int t0 = t_begin + s * SR;
      unsigned char* kd = stage_k(s);
      unsigned char* vd = kd + SR * D;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rr = rg + i * RS, t = t0 + rr;
        const bool ok = copied(t);
        const size_t src = static_cast<size_t>(ok ? t : 0) * D;
        cp_async16(kd + rr * D + c * 16, kp + src, ok);
        cp_async16(vd + rr * D + c * 16, vp + src, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // this thread's GB queries and output slice: channels c * 16 + [0, 16)
  float qr[GB][16], acc[GB][16], m[GB], l[GB];
  init_queries<GB>(qr, acc, m, l,
                   q + (static_cast<size_t>(b) * H + h * G + qb * GB) * D + c * 16, D,
                   G - qb * GB);

  // scale rows of the token blocks last used (a slot not copied holds the
  // zero fill, so its stale or zero scales are never NaN in P.V; a copied
  // dead slot has probability 0 and finite codes and scales)
  float ksc[16], vsc[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) ksc[d] = vsc[d] = 0.f;
  int kblk = -1, vblk = -1;
  for (int s = 0; s < n_stages; ++s) {
    prefetch(s + kStages - 1);
    cp_async_wait<kStages - 1>();  // stage s has landed (this thread's bytes)
    const int t0 = t_begin + s * SR;
    const unsigned char* kd = stage_k(s);
    const unsigned char* vd = kd + SR * D;

    // logits of the stage's slots: this thread's 16 channels, then summed
    // over the CH lanes of the row; dead slots -inf (probability 0)
    float x[GB][NR];
    int blk[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int t = t0 + rg + i * RS;
      const bool lv = live(t);
      blk[i] = copied(t) ? t / bs : -1;
      if (blk[i] >= 0 && blk[i] != kblk) {
        kblk = blk[i];
        load16(ksc, ksr + static_cast<size_t>(kblk) * D);
      }
      const uint4 w = *reinterpret_cast<const uint4*>(kd + (rg + i * RS) * D + c * 16);
      float kf[16];
      dequant16<KV_INT8>(w, 0, ksc, kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < 16; ++d) dot += qr[g][d] * kf[d];
#pragma unroll
        for (int off = CH / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        x[g][i] = lv ? dot * scale : -__int_as_float(0x7f800000);
      }
    }
    fold_logits<GB, NR>(x, m, l, acc);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (blk[i] >= 0 && blk[i] != vblk) {
        vblk = blk[i];
        load16(vsc, vsr + static_cast<size_t>(vblk) * D);
      }
      const uint4 w = *reinterpret_cast<const uint4*>(vd + (rg + i * RS) * D + c * 16);
      float vf[16];
      dequant16<KV_INT8>(w, 0, vsc, vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = x[g][i];
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[g][d] += p * vf[d];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is past the ring: its memory holds the merge
  store_split<D, GB, RS>(reinterpret_cast<float*>(fd_smem), acc, m, l, rg, c, G, qb,
                         static_cast<size_t>(b) * H + h * G, sp, o_part, m_part, l_part);
}

struct FlatArgs {
  const float* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* lengths;
  const int* windows;
  float *o, *m, *l, *o_part, *m_part, *l_part;
  int B, H, Hkv, T, nb, tps, nsplit;
  float scale;
};

template <int D, int GB, bool kWalkAll>
cudaError_t flat_launch(const FlatArgs& a, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  constexpr size_t smem = Walk<D>::template smem_bytes<GB>();
  cudaError_t e = allow_smem(flat_split_kernel<D, GB, kWalkAll>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int G = a.H / a.Hkv, nqb = (G + GB - 1) / GB;
  // one split: the walk's partials are the outputs
  const bool one = a.nsplit == 1;
  flat_split_kernel<D, GB, kWalkAll>
      <<<dim3(a.Hkv * nqb, a.B, a.nsplit), kThreads, smem, stream>>>(
          a.q, a.kq, a.ks, a.vq, a.vs, a.lengths, a.windows, one ? a.o : a.o_part,
          one ? a.m : a.m_part, one ? a.l : a.l_part, a.H, a.Hkv, G, a.T, a.nb, a.tps,
          a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || one) return e;
  merge_splits_kernel<<<a.B * a.H, D, 0, stream>>>(a.o_part, a.m_part, a.l_part, a.o, a.m,
                                                   a.l, a.nsplit);
  return cudaGetLastError();
}

template <int D, bool kWalkAll>
cudaError_t flat_launch_g(const FlatArgs& a, cudaStream_t s) {
  return a.H == a.Hkv ? flat_launch<D, 1, kWalkAll>(a, s) : flat_launch<D, 2, kWalkAll>(a, s);
}

// Check the shape rules and launch the instantiation for head width D.
// o_part (B, H, nsplit, D), m_part / l_part (B, H, nsplit): the wrapper's
// float32 scratch (unused with nsplit = 1); nsplit = ceil(T / tps).
template <bool kWalkAll>
int flat_dispatch(const FlatArgs& a, int D, void* stream) {
  if (a.B <= 0 || a.B > 65535 || a.Hkv <= 0 || a.H % a.Hkv || a.T <= 0 || a.nb <= 0 ||
      a.T % a.nb || a.tps <= 0 || a.nsplit <= 0 || a.nsplit > 65535 ||
      (a.nsplit - 1) * a.tps >= a.T || static_cast<long long>(a.nsplit) * a.tps < a.T)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return flat_launch_g<16, kWalkAll>(a, s);
    case 32: return flat_launch_g<32, kWalkAll>(a, s);
    case 64: return flat_launch_g<64, kWalkAll>(a, s);
    case 128: return flat_launch_g<128, kWalkAll>(a, s);
    case 256: return flat_launch_g<256, kWalkAll>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
