// Flash-attention forward (training forward and contiguous prefill), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_fwd.py::_fwd_kernel (entry
// flash_prefill), with the numerics of the path it serves on the card,
// repro/models/flash.py::flash_attention: queries are scaled by rsqrt(D) in
// float32 and rounded to the input type, logits are products of input-typed
// values summed in float32, probabilities are rounded to the input type
// before P.V and the sums run in float32. q (B, H, S, D), k/v (B, H_kv, T, D),
// float32 or bfloat16 -> out (B, H, S, D) float32 and the row statistics
// m (running max) and l (softmax denominator, at least 1e-30),
// (B, H_kv, G, S) float32, which the backward needs. Query i (absolute
// position kv_offset + i) sees key j when j <= kv_offset + i (causal) and
// j > kv_offset + i - window (window > 0).
//
// Bound on an H100: operations. Every live (query, key) pair costs 4 * D
// flops against K/V read once per query tile; at S = T = 2048 causal that is
// 69 GFLOP for 67 MB. Both kernels share the grid (ceil(S / (64 / G)),
// H_kv, B): a block owns a 64-row query tile holding the G heads of one GQA
// group at the same 64 / G positions, so each K/V tile it loads serves the
// whole group and the causal frontier is one number for the tile. It walks
// 64-key tiles only from the window's first live key (on the 64-key grid,
// so the tiles are those of a walk from key 0) to the tile's causal
// frontier (what skip_dead does on the TPU; any S and T, the ragged edge
// masked). Tiles run from the heaviest (last) query tile down.
//
// bfloat16 (flash_fwd_tc_kernel): the products run on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators (exact bf16
// products, so only the summation order differs from the plain version).
// 4 warps own 16 query rows each. Q is scaled, rounded and staged once in
// shared memory; K/V tiles arrive by cp.async (16 bytes a thread) into two
// buffers, the next tile's copy in flight while this one is folded; rows are
// padded by 16 bytes so ldmatrix reads them without bank conflicts (V
// through ldmatrix.trans). Each thread keeps its two rows' online-softmax
// state (m, l) and its slice of the output in registers; a row's max is
// reduced over the 4 lanes that share it by shuffles. P stays in registers:
// the float32 logit fragment, rounded to bf16, is the A operand of P.V; l
// sums the unrounded probabilities. wgmma, TMA and a warp-specialised
// producer are later work.
//
// float32 (flash_fwd_kernel): float32 FMAs on the CUDA cores (TF32 would
// break the float32 tolerance), 256 threads. It streams 64-key tiles into
// shared memory; each thread owns a 4 x 4 block of the 64 x 64 logit tile
// and a 4 x (D / 16) block of the output accumulator in registers; the
// online-softmax state is per row in shared memory.
//
// Head widths 16 to 256. At D 256 (recurrentgemma_9b: 16 query heads over
// one kv head, so a tile holds 4 positions of the 16 heads) the tiles
// outgrow the 48 KB default: the bf16 kernel stages 5 x 64 x 264 bf16
// (165 KB), the float32 one Q, K, V and the logit tile (210 KB), both opted
// in by allow_smem; the bf16 kernel's output fragment is then 128 float32
// registers a lane (ptxas reports what spills).
#include <cuda_bf16.h>

#include "cp_async.cuh"
#include "mma.cuh"
#include "page_dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows per block (G heads x 64 / G positions)
constexpr int kKeys = 64;   // keys per shared-memory tile

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }

// x rounded (to nearest even) to T's precision, as float32
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

template <int D>
struct Smem {
  static constexpr int q = kRows * (D + 1);  // padded: no bank conflicts
  static constexpr int k = kKeys * (D + 1);
  static constexpr int v = kKeys * D;
  static constexpr int s = kRows * (kKeys + 1);
  static constexpr size_t bytes = sizeof(float) * (q + k + v + s + 3 * kRows)
                                  + sizeof(int) * kRows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,   // (B, H, S, D)
    const T* __restrict__ k,   // (B, H_kv, T, D)
    const T* __restrict__ v,
    float* __restrict__ out,   // (B, H, S, D)
    float* __restrict__ m_out, // (B, H_kv, G, S)
    float* __restrict__ l_out,
    int Hkv, int G, int S, int Tk, int causal, int window, int kv_offset,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::q;
  float* Vs = Ks + Smem<D>::k;
  float* Ss = Vs + Smem<D>::v;
  float* ms = Ss + Smem<D>::s;
  float* ls = ms + kRows;
  float* al = ls + kRows;
  int* qpos = reinterpret_cast<int*>(al + kRows);  // -1: row outside q

  const int npos = kRows / G;                       // positions per tile
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = qt * npos;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G;

  // row r: head g = r / npos of the group, position s0 + r % npos
  auto row_off = [&](int r) {
    const int g = r / npos, s = s0 + r % npos;
    return ((static_cast<size_t>(b) * H + static_cast<size_t>(h) * G + g) * S + s);
  };
  for (int r = tid; r < kRows; r += kThreads) {
    const int g = r / npos, s = s0 + r % npos;
    qpos[r] = (g < G && s < S) ? kv_offset + s : -1;
    ms[r] = -1e30f;
    ls[r] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] =
        qpos[r] >= 0 ? round_to<T>(to_f(q[row_off(r) * D + d]) * scale) : 0.f;
  }

  // the keys any row of the tile can see: [lo, hi)
  const int s_last = min(S, s0 + npos) - 1;
  const int hi = causal ? min(Tk, kv_offset + s_last + 1) : Tk;
  // lo on the 64-key grid, so the tiles are those of a walk from key 0
  const int lo =
      window > 0 ? max(0, kv_offset + s0 - window + 1) / kKeys * kKeys : 0;
  auto live = [&](int r, int kpos) {
    const int qp = qpos[r];
    if (qp < 0) return false;
    if (causal && kpos > qp) return false;
    return window <= 0 || kpos > qp - window;
  };

  float acc[4][D / 16] = {};
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + h) * Tk;
  for (int j0 = lo; j0 < hi; j0 += kKeys) {
    const int nk = min(kKeys, hi - j0);
    __syncthreads();  // the previous tile is consumed (and Qs / qpos written)
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const size_t src = (kv_base + j0 + j) * D + d;
      Ks[j * (D + 1) + d] = to_f(k[src]);
      Vs[j * D + d] = to_f(v[src]);
    }
    __syncthreads();

    float sc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // online softmax, one warp per row at a time, two keys per lane; l sums
    // the float32 probabilities, P.V takes them rounded to the input type
    for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
      const int r = warp * (kRows / (kThreads / 32)) + rr;
      float* row = Ss + r * (kKeys + 1);
      const bool l0 = lane < nk && live(r, j0 + lane);
      const bool l1 = lane + 32 < nk && live(r, j0 + lane + 32);
      const float x0 = l0 ? row[lane] : -1e30f;
      const float x1 = l1 ? row[lane + 32] : -1e30f;
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = l0 ? expf(x0 - m_new) : 0.f;
      const float p1 = l1 ? expf(x1 - m_new) : 0.f;
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
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
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();  // ms / ls final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (qpos[r] < 0) continue;
    const float l = fmaxf(ls[r], 1e-30f);
    const size_t o = row_off(r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[o + tx + 16 * j] = acc[i][j] / l;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    if (qpos[r] < 0) continue;
    const int g = r / npos, s = s0 + r % npos;
    const size_t st = ((static_cast<size_t>(b) * Hkv + h) * G + g) * S + s;
    m_out[st] = ms[r];
    l_out[st] = fmaxf(ls[r], 1e-30f);
  }
}

// -- bfloat16 on the tensor cores ---------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 query rows

template <int D>
struct TcSmem {
  static constexpr int stride = D + 8;         // bf16 a row: 16 bytes of skew
  static constexpr int tile = kRows * stride;  // kRows == kKeys
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * 5 * tile;  // Q, 2 K, 2 V
};

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, H, S, D)
    const __nv_bfloat16* __restrict__ k,  // (B, H_kv, T, D)
    const __nv_bfloat16* __restrict__ v,
    float* __restrict__ out,    // (B, H, S, D)
    float* __restrict__ m_out,  // (B, H_kv, G, S)
    float* __restrict__ l_out,
    int Hkv, int G, int S, int Tk, int causal, int window, int kv_offset,
    float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = TcSmem<D>::stride;
  constexpr int TILE = TcSmem<D>::tile;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + TILE;      // two buffers each
  bf16* Vs = Ks + 2 * TILE;

  const int npos = kRows / G;                 // positions per tile
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = qt * npos;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G;
  // row r: head g = r / npos of the group, position s0 + r % npos
  auto row_off = [&](int r) {
    return (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G + r / npos) * S + s0 +
           r % npos;
  };
  auto row_live = [&](int r) { return r / npos < G && s0 + r % npos < S; };

  // the keys any row of the tile can see: [lo, hi), lo on the 64-key grid
  const int s_last = min(S, s0 + npos) - 1;
  const int hi = causal ? min(Tk, kv_offset + s_last + 1) : Tk;
  const int lo = window > 0 ? max(0, kv_offset + s0 - window + 1) / kKeys * kKeys : 0;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + h) * Tk;
  auto load_kv = [&](int buf, int j0) {
    bf16* kd = Ks + buf * TILE;
    bf16* vd = Vs + buf * TILE;
    for (int i = tid; i < kKeys * CH; i += kTcThreads) {
      const int j = i / CH, c = (i % CH) * 8;
      const bool ok = j0 + j < Tk;
      const size_t src = (kv_base + (ok ? j0 + j : 0)) * D + c;
      cp_async16(kd + j * ST + c, k + src, ok);
      cp_async16(vd + j * ST + c, v + src, ok);
    }
    cp_async_commit();
  };
  if (lo < hi) load_kv(0, lo);

  // Q scaled by rsqrt(D) in float32, rounded to bf16; rows outside q are 0
  for (int i = tid; i < kRows * CH; i += kTcThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (row_live(r)) {
      const uint4 x = *reinterpret_cast<const uint4*>(q + row_off(r) * D + c);
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
      bf16* we = reinterpret_cast<bf16*>(&w);
#pragma unroll
      for (int e = 0; e < 8; ++e) we[e] = __float2bfloat16(__bfloat162float(xe[e]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * ST + c) = w;
  }

  // this thread's rows of the tile: r0 and r0 + 8 (the mma fragment's)
  const int r0 = warp * 16 + lane / 4;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    qp[i] = row_live(r) ? kv_offset + s0 + r % npos : -1;
  }
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float mrow[2] = {-1e30f, -1e30f};
  float lrow[2] = {0.f, 0.f};  // this thread's share; the 4 lanes of a row add up at the end

  int buf = 0;
  for (int j0 = lo; j0 < hi; j0 += kKeys, buf ^= 1) {
    if (j0 + kKeys < hi) {
      load_kv(buf ^ 1, j0 + kKeys);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) visible to every warp
    const bf16* kb = Ks + buf * TILE;
    const bf16* vb = Vs + buf * TILE;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float sc[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + lane % 16) * ST + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; nt += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, kb + (nt * 8 + lane % 8 + (lane / 16) * 8) * ST + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(sc[nt], a, bb[0], bb[1]);
        mma_bf16(sc[nt + 1], a, bb[2], bb[3]);
      }
    }

    // dead (query, key) pairs get -inf: probability exactly 0, and the
    // running max stays that of the plain version (which starts at -1e30)
    const bool full = j0 + kKeys <= Tk && (!causal || j0 + kKeys - 1 <= kv_offset + s0) &&
                      (window <= 0 || j0 > kv_offset + s_last - window);
    if (!full) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + nt * 8 + 2 * (lane % 4) + (e & 1), p = qp[e / 2];
          const bool live = p >= 0 && key < Tk && (!causal || key <= p) &&
                            (window <= 0 || key > p - window);
          if (!live) sc[nt][e] = -__int_as_float(0x7f800000);  // -inf
        }
    }

    // online softmax in registers: the row max over the 4 lanes of a row
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
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
    // P as the A operand of P.V (16 keys a step), rounded to bf16; l takes
    // the unrounded float32 probabilities
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      const float p0 = expf(sc[nt][0] - mx[0]), p1 = expf(sc[nt][1] - mx[0]);
      const float p2 = expf(sc[nt][2] - mx[1]), p3 = expf(sc[nt][3] - mx[1]);
      lrow[0] += p0 + p1;
      lrow[1] += p2 + p3;
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P V
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt)
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vb + (kt * 16 + lane % 16) * ST + dt * 8 + (lane / 16) * 8);
        mma_bf16(o[dt], pa[kt], bb[0], bb[1]);
        mma_bf16(o[dt + 1], pa[kt], bb[2], bb[3]);
      }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = r0 + 8 * i;
    if (qp[i] < 0) continue;
    float* dst = out + row_off(r) * D + 2 * (lane % 4);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8) =
          make_float2(o[dt][2 * i] / l, o[dt][2 * i + 1] / l);
    if (lane % 4 == 0) {
      const size_t st = ((static_cast<size_t>(b) * Hkv + h) * G + r / npos) * S + s0 + r % npos;
      m_out[st] = mrow[i];
      l_out[st] = l;
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, float* out, float* m,
                      float* l, int B, int Hkv, int G, int S, int Tk, int causal, int window,
                      int kv_offset, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(flash_fwd_tc_kernel<D>, TcSmem<D>::bytes, allowed);
  if (e != cudaSuccess) return e;
  const int npos = kRows / G;
  const dim3 grid((S + npos - 1) / npos, Hkv, B);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, TcSmem<D>::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, m, l, Hkv, G, S, Tk, causal, window,
      kv_offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, float* m,
                   float* l, int B, int Hkv, int G, int S, int Tk, int causal, int window,
                   int kv_offset, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, Smem<D>::bytes, allowed);
  if (e != cudaSuccess) return e;
  const int npos = kRows / G;
  const dim3 grid((S + npos - 1) / npos, Hkv, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, Smem<D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, m,
      l, Hkv, G, S, Tk, causal, window, kv_offset, scale);
  return cudaGetLastError();
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); q, k and v alike
template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, float* out,
                         float* m, float* l, int B, int Hkv, int G, int S, int Tk, int causal,
                         int window, int kv_offset, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window, kv_offset,
                            scale, s);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window, kv_offset,
                        scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, float* out, float* m,
                         float* l, int B, int Hkv, int G, int S, int Tk, int D, int dtype,
                         int causal, int window, int kv_offset, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || G <= 0 || G > kRows || S <= 0 ||
      Tk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                              kv_offset, scale, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                              kv_offset, scale, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                              kv_offset, scale, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                               kv_offset, scale, s);
    case 256:
      return launch_dtype<256>(dtype, q, k, v, out, m, l, B, Hkv, G, S, Tk, causal, window,
                               kv_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
