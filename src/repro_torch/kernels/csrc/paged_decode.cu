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
// GQA group, far under the ~20 flop/byte the card needs in float32, so the
// logits and P.V stay float32 FMAs on the CUDA cores.
// Design (flash-decoding): the grid is (kv head x query pair, row, split).
// A split walks a fixed run of `pps` page-table entries of its row, only the
// live ones (never the table tail; a split past the row's live pages writes
// m = -1e30, l = 0, o = 0), and writes float32 partials to scratch; a second
// kernel merges a row's splits: m = max m_s, l = sum l_s e^(m_s - m),
// o = sum o_s e^(m_s - m). The wrapper picks the split count from host-known
// shapes only (batch, kv heads, table width, SM count), never from lengths,
// so the launch adds no host sync.
// Inside a split, D / 16 threads share a packed page row (16 bytes each,
// coalesced along D) and a thread always handles the same 16 channels, so it
// holds their scale rows (once a page), its queries and its slice of the
// output in registers. Page rows arrive by cp.async in a ring of kStages
// stages, kStages - 1 in flight while one is folded; each thread reads back
// only the bytes it copied itself, so the walk needs no barrier. A stage's
// logits are reduced over the row's lanes by shuffles and folded into the
// thread's own online-softmax state; the block's row groups merge once, at
// the end, through shared memory. The row-group and split merges are
// decode_split.cuh's, shared with flat_decode.cu.
#include "cp_async.cuh"
#include "decode_split.cuh"

namespace {

// grid (H_kv * nqb, B, nsplit); block (kv head, query pair qb, row b, split
// sp) attends queries h * G + qb * GB + [0, GB) (those below G) over the
// live tokens of pages [sp * pps, sp * pps + pps) of row b's table.
template <int D, int KV, int GB>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const float* __restrict__ q,          // (B, H, D)
    const int8_t* __restrict__ kq,        // (P, ps_packed, H_kv, D)
    const float* __restrict__ ks,         // (P, H_kv, D)
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    const int* __restrict__ page_table,   // (B, NT)
    const int* __restrict__ lengths,      // (B,)
    float* __restrict__ o_part,           // (B, H, nsplit, D)
    float* __restrict__ m_part,           // (B, H, nsplit)
    float* __restrict__ l_part,
    int H, int Hkv, int G, int ps, int ps_packed, int NT, int pps, float scale) {
  using W = Walk<D>;
  constexpr int CH = W::CH, RS = W::RS, NR = W::NR, SR = W::SR;
  constexpr int TPR = KV == KV_INT4 ? 2 : 1;  // tokens a packed row
  extern __shared__ __align__(16) unsigned char pd_smem[];
  const int nqb = (G + GB - 1) / GB;
  const int h = blockIdx.x / nqb, qb = blockIdx.x % nqb;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / CH, c = tid % CH;
  const int row_stride = Hkv * D;

  const int len = lengths[b];
  const int n_pages = min(NT, len > 0 ? (len + ps - 1) / ps : 0);
  const int p_begin = sp * pps, p_end = min(p_begin + pps, n_pages);
  const int spp = (ps_packed + SR - 1) / SR;          // stages a full page
  auto live_rows = [&](int t) { return (min(ps, len - t * ps) + TPR - 1) / TPR; };
  const int n_stages =
      p_begin < p_end ? (p_end - 1 - p_begin) * spp + (live_rows(p_end - 1) + SR - 1) / SR : 0;

  auto stage_k = [&](int s) { return pd_smem + (s % kStages) * W::stage_bytes; };
  auto prefetch = [&](int s) {
    if (s < n_stages) {
      const int t = p_begin + s / spp, row0 = (s % spp) * SR;
      const int pid = page_table[b * NT + t];
      const int lr = live_rows(t);
      const size_t base = static_cast<size_t>(pid) * ps_packed * row_stride + h * D + c * 16;
      unsigned char* kd = stage_k(s);
      unsigned char* vd = kd + SR * D;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rr = rg + i * RS;
        const bool ok = row0 + rr < lr;
        const size_t src = base + static_cast<size_t>(ok ? row0 + rr : 0) * row_stride;
        cp_async16(kd + rr * D + c * 16, kq + src, ok);
        cp_async16(vd + rr * D + c * 16, vq + src, ok);
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

  float ksc[16], vsc[16];
  for (int s = 0; s < n_stages; ++s) {
    prefetch(s + kStages - 1);
    cp_async_wait<kStages - 1>();  // stage s has landed (this thread's bytes)
    const int t = p_begin + s / spp, row0 = (s % spp) * SR;
    if (s % spp == 0) {  // a new page: its scale rows for this thread's channels
      const size_t so = (static_cast<size_t>(page_table[b * NT + t]) * Hkv + h) * D + c * 16;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 a = reinterpret_cast<const float4*>(ks + so)[j];
        const float4 v = reinterpret_cast<const float4*>(vs + so)[j];
        ksc[4 * j] = a.x, ksc[4 * j + 1] = a.y, ksc[4 * j + 2] = a.z, ksc[4 * j + 3] = a.w;
        vsc[4 * j] = v.x, vsc[4 * j + 1] = v.y, vsc[4 * j + 2] = v.z, vsc[4 * j + 3] = v.w;
      }
    }
    const int lt = min(ps, len - t * ps);  // live tokens of the page
    const unsigned char* kd = stage_k(s);
    const unsigned char* vd = kd + SR * D;

    // logits of the stage's tokens: this thread's 16 channels, then summed
    // over the CH lanes of the row; dead tokens -inf (probability 0)
    float x[GB][NR * TPR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const uint4 w = *reinterpret_cast<const uint4*>(kd + (rg + i * RS) * D + c * 16);
#pragma unroll
      for (int tk = 0; tk < TPR; ++tk) {
        float kf[16];
        dequant16<KV>(w, tk, ksc, kf);
        const bool live = (row0 + rg + i * RS) * TPR + tk < lt;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < 16; ++d) dot += qr[g][d] * kf[d];
#pragma unroll
          for (int off = CH / 2; off > 0; off /= 2)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          x[g][i * TPR + tk] = live ? dot * scale : -__int_as_float(0x7f800000);
        }
      }
    }
    fold_logits<GB, NR * TPR>(x, m, l, acc);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const uint4 w = *reinterpret_cast<const uint4*>(vd + (rg + i * RS) * D + c * 16);
#pragma unroll
      for (int tk = 0; tk < TPR; ++tk) {
        float vf[16];
        dequant16<KV>(w, tk, vsc, vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float p = x[g][i * TPR + tk];
#pragma unroll
          for (int d = 0; d < 16; ++d) acc[g][d] += p * vf[d];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is past the ring: its memory holds the merge
  store_split<D, GB, RS>(reinterpret_cast<float*>(pd_smem), acc, m, l, rg, c, G, qb,
                         static_cast<size_t>(b) * H + h * G, sp, o_part, m_part, l_part);
}

struct Args {
  const float* q;
  const void* kq;
  const float* ks;
  const void* vq;
  const float* vs;
  const int* page_table;
  const int* lengths;
  float *o, *m, *l, *o_part, *m_part, *l_part;
  int B, H, Hkv, D, ps, ps_packed, NT, pps, nsplit;
  float scale;
};

template <int D, int KV, int GB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  constexpr size_t smem = Walk<D>::template smem_bytes<GB>();
  cudaError_t e = allow_smem(paged_decode_split_kernel<D, KV, GB>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int G = a.H / a.Hkv, nqb = (G + GB - 1) / GB;
  paged_decode_split_kernel<D, KV, GB><<<dim3(a.Hkv * nqb, a.B, a.nsplit), kThreads, smem,
                                         stream>>>(
      a.q, static_cast<const int8_t*>(a.kq), a.ks, static_cast<const int8_t*>(a.vq), a.vs,
      a.page_table, a.lengths, a.o_part, a.m_part, a.l_part, a.H, a.Hkv, G, a.ps,
      a.ps_packed, a.NT, a.pps, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_splits_kernel<<<a.B * a.H, D, 0, stream>>>(a.o_part, a.m_part, a.l_part, a.o, a.m,
                                                   a.l, a.nsplit);
  return cudaGetLastError();
}

template <int D, int KV>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  return a.H == a.Hkv ? launch<D, KV, 1>(a, s) : launch<D, KV, 2>(a, s);
}

template <int D>
cudaError_t launch_fmt(int kv, const Args& a, cudaStream_t s) {
  switch (kv) {
    case KV_INT8: return launch_g<D, KV_INT8>(a, s);
    case KV_FP8: return launch_g<D, KV_FP8>(a, s);
    case KV_INT4: return launch_g<D, KV_INT4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// o_part (B, H, nsplit, D), m_part / l_part (B, H, nsplit): the wrapper's
// float32 scratch; nsplit = ceil(NT / pps)
extern "C" int paged_decode_partials(const float* q, const void* kq, const float* ks,
                                     const void* vq, const float* vs,
                                     const int* page_table, const int* lengths, float* o,
                                     float* m, float* l, float* o_part, float* m_part,
                                     float* l_part, int B, int H, int Hkv, int D, int ps,
                                     int ps_packed, int NT, int kv_format, int pps,
                                     int nsplit, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H % Hkv || NT <= 0 || pps <= 0 || nsplit <= 0 ||
      nsplit > 65535 || (nsplit - 1) * pps >= NT || nsplit * pps < NT)
    return cudaErrorInvalidValue;
  const Args a{q, kq, ks, vq, vs, page_table, lengths, o, m, l, o_part, m_part, l_part,
               B, H, Hkv, D, ps, ps_packed, NT, pps, nsplit, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fmt<16>(kv_format, a, s);
    case 32: return launch_fmt<32>(kv_format, a, s);
    case 64: return launch_fmt<64>(kv_format, a, s);
    case 128: return launch_fmt<128>(kv_format, a, s);
    default: return cudaErrorInvalidValue;
  }
}
