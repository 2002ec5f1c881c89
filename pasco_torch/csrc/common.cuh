// Shared helpers of the port's CUDA kernels (bf16 storage, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace pasco {

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 tobf(float v) { return __float2bfloat16(v); }
// Round an f32 value through bf16 (where the TPU kernel stores bf16).
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }
__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : 0.01f * v; }

// 16x16x16 bf16 fragments with f32 accumulation (mma.sync tensor cores).
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

}  // namespace pasco
