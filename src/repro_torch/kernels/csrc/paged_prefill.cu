// Paged varlen chunk-prefill attention over a quantized KV page pool, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quant_prefill.py::_prefill_kernel
// (built by _paged_prefill, reached through paged_attention_prefill). A chunk
// of C queries per batch row, the GQA group stacked as G*C rows (row r is
// chunk position r % C of head-group lane r / C) and pre-scaled by rsqrt(D),
// attends over the row's hist_len history tokens (read straight from the
// quantized pages through the page table, at most hist_blocks pages) and then
// over the chunk's own float32 K/V with causal and kpos < valid masking. The
// output is normalized; the caller discards rows past `valid`.
//
// Bound on an H100: operations once the history is long. Every query row
// meets every live key: 4 * D flops per (row, key) against one byte per key
// element read once for the whole row tile, so at C = 1024 the flops outrun
// the bytes by a wide margin.
// Design: the products run on the tensor cores (mma.sync.m16n8k16, bf16
// operands, float32 accumulators) and keep the float32 contract by splitting
// every float operand into three bf16 terms: hi, mid and lo, each the top 8
// significant bits of what remains, so hi + mid + lo is the float32 value
// exactly and every product of terms is exact; only the order of the float32
// sums differs from the plain version.
//  - History, Q.K: the page's K scale row folds onto the query side per
//    channel (q' = q * ks, float32) and q' splits into three terms, each
//    multiplied by the page's codes, which are exact in bf16 (int8, fp8_e4m3,
//    int4): 3 products.
//  - History, P.V: p splits into three terms against the V codes (3
//    products); the tile's float32 product takes the page's V scale row per
//    channel before it joins the output.
//  - Chunk: both sides are float32 and both split; the six products whose
//    terms' orders sum to at most 2 (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid,
//    lo.hi) leave out terms below 2^-23 of the product, for Q.K and for P.V.
// Grid (ceil(G*C / 64), H_kv, B), 4 warps of 16 query rows; heaviest row
// tiles (latest chunk positions) first. A row tile whose positions are all
// at or past `valid` (read on the device) computes nothing and writes 0.0.
// The history walks only the row's live pages and tokens in tiles of
// min(64, ps) keys inside one page: page rows arrive by cp.async (16 bytes a
// thread) into two buffers, the next tile's copy in flight while this one is
// folded, and are converted once per tile to a bf16 code tile that ldmatrix
// reads. The chunk's keys stop at min(last query position + 1, valid); its
// float32 K/V tiles of 32 keys arrive by cp.async into two buffers and are
// split where the fragments are loaded. Each thread keeps its two rows'
// online-softmax state and its slice of the output in registers; l sums the
// float32 probabilities. A product term is issued across all of a step's
// independent accumulators before the next term, so the MMAs that feed one
// accumulator issue 4 or 8 apart and mma.sync's latency is covered. About 101 KB of shared memory at D = 128: two
// blocks an SM.
#include "cp_async.cuh"
#include "mma.cuh"
#include "page_dequant.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kRows = 64;       // query rows a block
constexpr int kHistKeys = 64;   // history keys a tile (fewer when ps < 64)
constexpr int kChunkKeys = 32;  // chunk keys a tile

template <int D>
struct Smem {
  static constexpr int qst = D + 8;  // float32 Q row: A loads without bank conflicts
  static constexpr int cst = D + 8;  // bf16 code row: 16 bytes of skew for ldmatrix
  static constexpr int kst = D + 8;  // float32 chunk K row
  static constexpr int vst = D + 4;  // float32 chunk V row (column loads)
  static constexpr size_t q_bytes = sizeof(float) * kRows * qst;
  static constexpr size_t raw_stage = 2ull * kHistKeys * D;  // K and V page rows
  static constexpr size_t codes = sizeof(uint16_t) * kHistKeys * cst;
  static constexpr size_t hist_bytes = 2 * raw_stage + 2 * codes;
  static constexpr size_t chunk_stage = sizeof(float) * kChunkKeys * (kst + vst);
  static constexpr size_t chunk_bytes = 2 * chunk_stage;
  static constexpr size_t bytes =
      q_bytes + (hist_bytes > chunk_bytes ? hist_bytes : chunk_bytes);
};

// x = hi + mid + lo exactly: each term the top 8 significant bits (a bf16)
// of what remains; two values packed per register, x0 in the low half
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(x0) & 0xffff0000u, h1 = __float_as_uint(x1) & 0xffff0000u;
  const float r0 = x0 - __uint_as_float(h0), r1 = x1 - __uint_as_float(h1);
  const uint32_t m0 = __float_as_uint(r0) & 0xffff0000u, m1 = __float_as_uint(r1) & 0xffff0000u;
  const float s0 = r0 - __uint_as_float(m0), s1 = r1 - __uint_as_float(m1);
  hi = __byte_perm(h0, h1, 0x7632);
  mid = __byte_perm(m0, m1, 0x7632);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

// a small integer (|v| < 128) as float32, without a conversion instruction
__device__ __forceinline__ float small_int(int v) {
  return __int_as_float(0x4b000000 | (v + 128)) - 8388736.f;
}

// the code of token `tk` (0, or 1 for int4's high nibble) in a page byte,
// as float32 (exact, and exact in bf16)
template <int KV>
__device__ __forceinline__ float code_of(int8_t by, int tk) {
  if (KV == KV_INT4)
    return small_int(tk ? (by >> 4) : (static_cast<int8_t>(static_cast<uint8_t>(by) << 4) >> 4));
  if (KV == KV_FP8) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>(by);
    return static_cast<float>(e);
  }
  return small_int(by);
}

// the bf16 pair of two floats that are exact in bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack_exact(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// The A fragments (this warp's 16 rows x 16 channels of k-step kk) of the
// float32 queries in Qs, times sc (two float2 of the K scale row at this
// thread's channels) when `scaled`, split into three bf16 terms.
template <int D, bool scaled>
__device__ __forceinline__ void q_frags(uint32_t (&a)[3][4], const float* Qs, int kk,
                                        const float* __restrict__ ksr) {
  constexpr int qst = Smem<D>::qst;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = kk * 16 + 2 * (lane % 4);
  const float* q0 = Qs + (warp * 16 + lane / 4) * qst + col;
  float2 x[4] = {*reinterpret_cast<const float2*>(q0),
                 *reinterpret_cast<const float2*>(q0 + 8 * qst),
                 *reinterpret_cast<const float2*>(q0 + 8),
                 *reinterpret_cast<const float2*>(q0 + 8 * qst + 8)};
  if (scaled) {
    const float2 s0 = __ldg(reinterpret_cast<const float2*>(ksr + col));
    const float2 s1 = __ldg(reinterpret_cast<const float2*>(ksr + col + 8));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 s = j < 2 ? s0 : s1;
      x[j].x *= s.x;
      x[j].y *= s.y;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) split3(x[j].x, x[j].y, a[0][j], a[1][j], a[2][j]);
}

// Online softmax of one key tile's logits sc (NB n-blocks of 8 keys; dead
// pairs already -inf) for this thread's two rows: rescales o and l, and
// returns p split into three bf16 terms as the A operand of P.V (16 keys a
// k-step). l sums the float32 probabilities.
template <int D, int NB>
__device__ __forceinline__ void softmax_tile(float (&sc)[NB][4], float (&mrow)[2],
                                             float (&lrow)[2], float (&o)[D / 8][4],
                                             uint32_t (&pa)[NB / 2][3][4]) {
  float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = expf(mrow[i] - mx[i]);
    mrow[i] = mx[i];
    lrow[i] *= alpha[i];
  }
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
    const float p0 = expf(sc[nt][0] - mx[0]), p1 = expf(sc[nt][1] - mx[0]);
    const float p2 = expf(sc[nt][2] - mx[1]), p3 = expf(sc[nt][3] - mx[1]);
    lrow[0] += p0 + p1;
    lrow[1] += p2 + p3;
    const int kt = nt / 2, e = (nt % 2) * 2;
    split3(p0, p1, pa[kt][0][e], pa[kt][1][e], pa[kt][2][e]);
    split3(p2, p3, pa[kt][0][e + 1], pa[kt][1][e + 1], pa[kt][2][e + 1]);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
}

// acc(j) += a . b[j], j < N, over the six products of split operands whose
// term orders sum to at most 2, smallest first; each product across the N
// accumulators before the next, so one accumulator's MMAs issue N apart
template <int N, typename Acc>
__device__ __forceinline__ void mma_split6(Acc acc, const uint32_t (&a)[3][4],
                                           const uint32_t (&b0)[N][3],
                                           const uint32_t (&b1)[N][3]) {
  auto product = [&](int i, int k) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_bf16(acc(j), a[i], b0[j][k], b1[j][k]);
  };
  product(2, 0);
  product(1, 1);
  product(0, 2);
  product(1, 0);
  product(0, 1);
  product(0, 0);
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
  using S = Smem<D>;
  constexpr int TPR = KV == KV_INT4 ? 2 : 1;  // tokens a packed page row
  extern __shared__ __align__(16) unsigned char pf_smem[];
  float* Qs = reinterpret_cast<float*>(pf_smem);
  unsigned char* U = pf_smem + S::q_bytes;  // history or chunk tiles

  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int nrows = min(kRows, GC - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  float* dst = out + (bh * GC + r0) * D;
  const int vd = valid[b];

  // a tile whose positions are all at or past `valid` writes zeros
  const int r1 = r0 + nrows - 1;
  const bool one_lane = r0 / C == r1 / C;
  if ((one_lane ? r0 % C : 0) >= vd) {
    for (int i = tid; i < nrows * D / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int q_last = one_lane ? r1 % C : C - 1;

  // history tiles: min(64, ps) keys inside one page; the row's live pages
  const int hl = hist_len[b];
  const int n_hist = min(hl > 0 ? (hl + ps - 1) / ps : 0, hist_blocks);
  const int kt_keys = min(kHistKeys, ps);
  const int tpp = (ps + kt_keys - 1) / kt_keys;  // tiles a full page
  auto page_live = [&](int t) { return min(ps, hl - t * ps); };
  const int n_ht = n_hist ? (n_hist - 1) * tpp + (page_live(n_hist - 1) + kt_keys - 1) / kt_keys
                          : 0;
  const int row_stride = Hkv * D;
  unsigned char* raw = U;
  uint16_t* Kc = reinterpret_cast<uint16_t*>(U + 2 * S::raw_stage);
  uint16_t* Vc = Kc + kHistKeys * S::cst;
  auto hist_tile = [&](int i, int& pid, int& j0, int& lt) {
    const int t = i / tpp;
    pid = page_table[b * NT + t];
    j0 = (i % tpp) * kt_keys;
    lt = min(kt_keys, page_live(t) - j0);  // live keys of the tile
  };
  auto hist_prefetch = [&](int i) {
    if (i < n_ht) {
      int pid, j0, lt;
      hist_tile(i, pid, j0, lt);
      const int rows = (lt + TPR - 1) / TPR;
      const size_t base = static_cast<size_t>(pid) * ps_packed * row_stride + h * D +
                          static_cast<size_t>(j0 / TPR) * row_stride;
      unsigned char* kd = raw + (i % 2) * S::raw_stage;
      unsigned char* vdst = kd + kHistKeys * D;
      for (int x = tid; x < (kHistKeys / TPR) * (D / 16); x += kThreads) {
        const int r = x / (D / 16), c = (x % (D / 16)) * 16;
        const bool ok = r < rows;
        const size_t src = base + static_cast<size_t>(ok ? r : 0) * row_stride + c;
        cp_async16(kd + r * D + c, kq + src, ok);
        cp_async16(vdst + r * D + c, vq + src, ok);
      }
    }
    cp_async_commit();
  };
  hist_prefetch(0);

  // the block's queries, float32, in shared memory (rows past GC zero)
  for (int i = tid; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = *reinterpret_cast<const float4*>(qg + (bh * GC + r0 + r) * D + d);
    *reinterpret_cast<float4*>(Qs + r * S::qst + d) = x;
  }

  // this thread's rows of the tile (the fragments'): rw and rw + 8
  const int rw = warp * 16 + lane / 4, t4 = lane % 4;
  const int qpos[2] = {(r0 + rw) % C, (r0 + rw + 8) % C};
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float mrow[2] = {-1e30f, -1e30f};
  float lrow[2] = {0.f, 0.f};  // this thread's share; a row's 4 lanes add up at the end

  for (int i = 0; i < n_ht; ++i) {
    hist_prefetch(i + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile i's page rows visible; every warp done with the codes
    int pid, j0, lt;
    hist_tile(i, pid, j0, lt);
    {  // page rows -> bf16 codes (rows past the live keys zero)
      const unsigned char* kr = raw + (i % 2) * S::raw_stage;
      const unsigned char* vr = kr + kHistKeys * D;
      for (int x = tid; x < kHistKeys * (D / 8); x += kThreads) {
        const int j = x / (D / 8), d = (x % (D / 8)) * 8;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (j < lt) {
          const size_t off = static_cast<size_t>(j / TPR) * D + d;
          const uint2 kb = *reinterpret_cast<const uint2*>(kr + off);
          const uint2 vb = *reinterpret_cast<const uint2*>(vr + off);
          const int8_t* ke = reinterpret_cast<const int8_t*>(&kb);
          const int8_t* ve = reinterpret_cast<const int8_t*>(&vb);
          const int tk = TPR == 2 ? j % 2 : 0;
          uint32_t* kp = reinterpret_cast<uint32_t*>(&kw);
          uint32_t* vp = reinterpret_cast<uint32_t*>(&vw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kp[e] = pack_exact(code_of<KV>(ke[2 * e], tk), code_of<KV>(ke[2 * e + 1], tk));
            vp[e] = pack_exact(code_of<KV>(ve[2 * e], tk), code_of<KV>(ve[2 * e + 1], tk));
          }
        }
        *reinterpret_cast<uint4*>(Kc + j * S::cst + d) = kw;
        *reinterpret_cast<uint4*>(Vc + j * S::cst + d) = vw;
      }
    }
    __syncthreads();  // the codes visible
    const float* ksr = ks + (static_cast<size_t>(pid) * Hkv + h) * D;
    const float* vsr = vs + (static_cast<size_t>(pid) * Hkv + h) * D;

    // S = (Q * ks) . codes^T: the warp's 16 rows x 64 keys, 3 products
    constexpr int NB = kHistKeys / 8;
    float sc[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[3][4], bb[NB / 2][4];
      q_frags<D, true>(a, Qs, kk, ksr);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np)
        if (np * 16 < lt)
          ldsm_x4(bb[np], Kc + (np * 16 + lane % 8 + (lane / 16) * 8) * S::cst + kk * 16 +
                              ((lane / 8) % 2) * 8);
      // a term across every key block before the next term: the products
      // of one accumulator issue NB MMAs apart
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int np = 0; np < NB / 2; ++np)
          if (np * 16 < lt) {
            mma_bf16(sc[2 * np], a[term], bb[np][0], bb[np][1]);
            mma_bf16(sc[2 * np + 1], a[term], bb[np][2], bb[np][3]);
          }
    }
    if (lt < kHistKeys) {  // keys past the tile's live ones: -inf
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t4 + (e & 1) >= lt) sc[nt][e] = -__int_as_float(0x7f800000);
    }
    uint32_t pa[NB / 2][3][4];
    softmax_tile<D, NB>(sc, mrow, lrow, o, pa);

    // O += (P . codes) * vs: 3 products a tile into fresh accumulators of
    // DG channel blocks at a time, then the page's V scales
    constexpr int DG = D / 8 < 8 ? D / 8 : 8;
#pragma unroll
    for (int dg = 0; dg < D / 8; dg += DG) {
      float t[DG][4];
#pragma unroll
      for (int j = 0; j < DG; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NB / 2; ++kt) {
        if (kt * 16 >= lt) break;
        uint32_t bb[DG / 2][4];
#pragma unroll
        for (int p = 0; p < DG / 2; ++p)
          ldsm_x4_t(bb[p], Vc + (kt * 16 + lane % 16) * S::cst + (dg + 2 * p) * 8 +
                               (lane / 16) * 8);
#pragma unroll
        for (int term = 2; term >= 0; --term)
#pragma unroll
          for (int p = 0; p < DG / 2; ++p) {
            mma_bf16(t[2 * p], pa[kt][term], bb[p][0], bb[p][1]);
            mma_bf16(t[2 * p + 1], pa[kt][term], bb[p][2], bb[p][3]);
          }
      }
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const float2 sv =
            __ldg(reinterpret_cast<const float2*>(vsr + (dg + j) * 8 + 2 * t4));
        o[dg + j][0] += t[j][0] * sv.x;
        o[dg + j][1] += t[j][1] * sv.y;
        o[dg + j][2] += t[j][2] * sv.x;
        o[dg + j][3] += t[j][3] * sv.y;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past the history: its memory takes the chunk

  // chunk: keys up to the tile's last query position, below `valid`
  const int n_chunk = min(q_last + 1, vd);
  const int n_ct = (n_chunk + kChunkKeys - 1) / kChunkKeys;
  const float* kcb = kc + bh * C * D;
  const float* vcb = vc + bh * C * D;
  auto chunk_k = [&](int i) { return reinterpret_cast<float*>(U + (i % 2) * S::chunk_stage); };
  auto chunk_prefetch = [&](int i) {
    if (i < n_ct) {
      float* kd = chunk_k(i);
      float* vdst = kd + kChunkKeys * S::kst;
      const int j0 = i * kChunkKeys;
      for (int x = tid; x < kChunkKeys * (D / 4); x += kThreads) {
        const int j = x / (D / 4), d = (x % (D / 4)) * 4;
        const bool ok = j0 + j < n_chunk;
        const size_t src = static_cast<size_t>(ok ? j0 + j : 0) * D + d;
        cp_async16(kd + j * S::kst + d, kcb + src, ok);
        cp_async16(vdst + j * S::vst + d, vcb + src, ok);
      }
    }
    cp_async_commit();
  };
  chunk_prefetch(0);
  for (int i = 0; i < n_ct; ++i) {
    chunk_prefetch(i + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile i visible (and Qs, when no history ran)
    const float* Kf = chunk_k(i);
    const float* Vf = Kf + kChunkKeys * S::kst;
    const int j0 = i * kChunkKeys;

    // S = Q . K^T: the warp's 16 rows x 32 keys, both sides split, 6 products
    constexpr int NB = kChunkKeys / 8;
    float sc[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[3][4], b0[NB][3], b1[NB][3];
      q_frags<D, false>(a, Qs, kk, nullptr);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const float* kr = Kf + (nt * 8 + lane / 4) * S::kst + kk * 16 + 2 * t4;
        const float2 k0 = *reinterpret_cast<const float2*>(kr);
        const float2 k1 = *reinterpret_cast<const float2*>(kr + 8);
        split3(k0.x, k0.y, b0[nt][0], b0[nt][1], b0[nt][2]);
        split3(k1.x, k1.y, b1[nt][0], b1[nt][1], b1[nt][2]);
      }
      mma_split6<NB>([&](int j) -> float(&)[4] { return sc[j]; }, a, b0, b1);
    }
    // dead pairs -inf: kpos past the row's position or at/past `valid`
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + nt * 8 + 2 * t4 + (e & 1);
        if (kpos > qpos[e / 2] || kpos >= vd) sc[nt][e] = -__int_as_float(0x7f800000);
      }
    uint32_t pa[NB / 2][3][4];
    softmax_tile<D, NB>(sc, mrow, lrow, o, pa);

    // O += P . V, both sides split, 6 products, DC channel blocks at a time
    constexpr int DC = D / 8 < 4 ? D / 8 : 4;
#pragma unroll
    for (int kt = 0; kt < NB / 2; ++kt)
#pragma unroll
      for (int dg = 0; dg < D / 8; dg += DC) {
        uint32_t b0[DC][3], b1[DC][3];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float* vr = Vf + (kt * 16 + 2 * t4) * S::vst + (dg + j) * 8 + lane / 4;
          split3(vr[0], vr[S::vst], b0[j][0], b0[j][1], b0[j][2]);
          split3(vr[8 * S::vst], vr[9 * S::vst], b1[j][0], b1[j][1], b1[j][2]);
        }
        mma_split6<DC>([&](int j) -> float(&)[4] { return o[dg + j]; }, pa[kt], b0, b1);
      }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = rw + 8 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(dst + r * D + dt * 8 + 2 * t4) =
          make_float2(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
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
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || C <= 0 || GC % C || ps <= 0 ||
      ps_packed * (kv_format == KV_INT4 ? 2 : 1) != ps)
    return cudaErrorInvalidValue;
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
