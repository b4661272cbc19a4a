// Shared by the paged decode and paged prefill kernels: one element of a
// quantized KV page, read from device memory and converted to float32.
//
// A page of one kv head is ps_packed rows of D bytes; consecutive rows are
// row_stride = H_kv * D bytes apart (pool layout (P, ps_packed, H_kv, D)).
//   int8      one token per row, value as is
//   fp8_e4m3  one token per row, __nv_fp8_e4m3 -> float (exact)
//   int4      two tokens per row: token 2i in the low nibble of row i,
//             token 2i+1 in the high nibble, each sign-extended by an
//             arithmetic shift of a signed byte
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum KvFormat { KV_INT8 = 0, KV_FP8 = 1, KV_INT4 = 2 };

template <int KV>
__device__ __forceinline__ float page_value(const int8_t* __restrict__ page,
                                            int tok, int row_stride, int d) {
  if (KV == KV_INT4) {
    const int8_t b = page[(tok >> 1) * row_stride + d];
    const int v = (tok & 1) ? (b >> 4)
                            : (static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4);
    return static_cast<float>(v);
  } else if (KV == KV_FP8) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>(page[tok * row_stride + d]);
    return static_cast<float>(f);
  } else {
    return static_cast<float>(page[tok * row_stride + d]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise a kernel's dynamic shared memory limit past the 48 KB default;
// `allowed` is the caller's per-instantiation record of what is set.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}
