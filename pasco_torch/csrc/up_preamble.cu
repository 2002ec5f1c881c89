// up_preamble: the generative decoder's stage preamble, fused.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_deconv.py:up_preamble_padded
// (_up_kernel, _up_call).  For every child cell c of parent p (child offset
// k = kernel_offsets(2) index of c - 2p), on the port's [X, Z, Y, C] layout:
//   d   = leaky(a1 * ((parent * parent_keep)[p] @ wd[k] + bd) + c1)
//   xc  = [d, (box_min + scale * cell) / scale]            (Co + 3 channels)
//   r   = (a2 * xc + c2) @ wr + br
//   out = union[c] * (child[c] * r + skip[c])
// with bf16 rounding where the TPU kernel stores bf16 (deconv output, the
// activation, the coords, the resize input and r).  Coordinates are the
// absolute cell coordinates, read from the device box corner.
//
// What bounds it on an H100: two chained small products per child
// (Ci x Co, then (Co + 3) x Co) over a full stage volume; at dec_s1 that is
// ~0.2 TFLOP against ~1 GB of bf16 traffic, tensor-core bound in principle
// but short.  Design: a block owns 32 consecutive parents (flat
// [X2, Z2, Y2] order) and all Co output channels.  It stages the masked
// parent rows once, then for each of the 8 child offsets runs the deconv
// product into shared f32, applies bias/affine/leaky/coords/affine there to
// build the resize product's bf16 A tile in shared memory, runs the resize
// product, and writes the children with the skip add.  Neither intermediate
// leaves shared memory.  Parent tiles none of whose children lies in the
// union mask are skipped through the device-built tile list.
#include "common.cuh"

using namespace nvcuda;
using namespace pasco;

namespace {

constexpr int ROWS = 32;      // parents per block (two 16-row fragments)
constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32) up_preamble_kernel(
    const __nv_bfloat16* __restrict__ parent, const uint8_t* __restrict__ parent_keep,
    const uint8_t* __restrict__ child_mask, const uint8_t* __restrict__ union_mask,
    const __nv_bfloat16* __restrict__ skip, const __nv_bfloat16* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ a1,
    const float* __restrict__ c1, const float* __restrict__ a2,
    const float* __restrict__ c2, const __nv_bfloat16* __restrict__ wr,
    const float* __restrict__ br, const int* __restrict__ box_min,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ tile_ids,
    const int* __restrict__ n_active, int X2, int Z2, int Y2, int Ci, int Co,
    int scale) {
  if ((int)blockIdx.x >= *n_active) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K2 = Co + 16;                     // Co + 3 coords, zero padded
  __nv_bfloat16* a1s = reinterpret_cast<__nv_bfloat16*>(smem);       // [32, Ci]
  float* fs = reinterpret_cast<float*>(smem + ROWS * Ci * 2);         // [32, Co]
  __nv_bfloat16* a2s =
      reinterpret_cast<__nv_bfloat16*>(smem + ROWS * Ci * 2 + ROWS * Co * 4);  // [32, K2]

  const int Z = 2 * Z2, Y = 2 * Y2;
  const long long n_par = (long long)X2 * Z2 * Y2;
  const long long p0 = (long long)tile_ids[blockIdx.x] * ROWS;
  const int warp = threadIdx.x / 32;
  const int n_frag_jobs = 2 * (Co / 16);
  const float mn[3] = {(float)box_min[0], (float)box_min[1], (float)box_min[2]};

  for (int v = threadIdx.x; v < ROWS * (Ci / 8); v += blockDim.x) {
    const int r = v / (Ci / 8), part = v % (Ci / 8);
    const long long p = p0 + r;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (p < n_par && parent_keep[p])
      packed = *reinterpret_cast<const uint4*>(parent + p * Ci + part * 8);
    *reinterpret_cast<uint4*>(a1s + r * Ci + part * 8) = packed;
  }

  for (int k = 0; k < 8; ++k) {
    const int ix = k >> 2, iy = (k >> 1) & 1, iz = k & 1;
    __syncthreads();
    // deconv product for child offset k: [32, Ci] @ wd[k] -> fs
    for (int job = warp; job < n_frag_jobs; job += WARPS) {
      const int m = job & 1, n = job >> 1;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Ci; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, a1s + m * 16 * Ci + kk, Ci);
        wmma::load_matrix_sync(b, wd + ((long long)k * Ci + kk) * Co + n * 16, Co);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + m * 16 * Co + n * 16, acc, Co, wmma::mem_row_major);
    }
    __syncthreads();
    // up_bn affine + leaky, coords, resize_bn affine -> bf16 A tile
    for (int e = threadIdx.x; e < ROWS * K2; e += blockDim.x) {
      const int r = e / K2, col = e % K2;
      float u;
      if (col < Co) {
        u = rbf(fs[r * Co + col] + bd[col]);
        u = rbf(leaky(a1[col] * u + c1[col]));
      } else if (col < Co + 3) {
        const long long p = p0 + r;
        const int py = (int)(p % Y2), pz = (int)((p / Y2) % Z2);
        const int px = (int)(p / ((long long)Y2 * Z2));
        const int j = col - Co;   // 0: x, 1: y, 2: z
        const int cell = j == 0 ? 2 * px + ix : (j == 1 ? 2 * py + iy : 2 * pz + iz);
        u = rbf((mn[j] + (float)(scale * cell)) / (float)scale);
      } else {
        a2s[e] = tobf(0.f);
        continue;
      }
      a2s[e] = tobf(a2[col] * u + c2[col]);
    }
    __syncthreads();
    // resize product: [32, K2] @ wr -> fs
    for (int job = warp; job < n_frag_jobs; job += WARPS) {
      const int m = job & 1, n = job >> 1;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < K2; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, a2s + m * 16 * K2 + kk, K2);
        wmma::load_matrix_sync(b, wr + (long long)kk * Co + n * 16, Co);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + m * 16 * Co + n * 16, acc, Co, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * Co; e += blockDim.x) {
      const int r = e / Co, col = e % Co;
      const long long p = p0 + r;
      if (p >= n_par) continue;
      const int py = (int)(p % Y2), pz = (int)((p / Y2) % Z2);
      const int px = (int)(p / ((long long)Y2 * Z2));
      const long long g =
          ((long long)(2 * px + ix) * Z + (2 * pz + iz)) * Y + (2 * py + iy);
      float v = 0.f;
      if (union_mask[g]) {
        const float dec = child_mask[g] ? rbf(fs[e] + br[col]) : 0.f;
        v = dec + bf(skip[g * Co + col]);
      }
      out[g * Co + col] = tobf(v);
    }
  }
}

}  // namespace

extern "C" int pasco_up_preamble(
    const void* parent, const void* parent_keep, const void* child_mask,
    const void* union_mask, const void* skip, const void* wd, const void* bd,
    const void* a1, const void* c1, const void* a2, const void* c2,
    const void* wr, const void* br, const void* box_min, void* out,
    const void* tile_ids, const void* n_active, int X2, int Z2, int Y2, int Ci,
    int Co, int scale, int n_tiles, void* stream) {
  if (Ci % 16 != 0 || Co % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int smem = ROWS * Ci * 2 + ROWS * Co * 4 + ROWS * (Co + 16) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      up_preamble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  up_preamble_kernel<<<n_tiles, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)parent, (const uint8_t*)parent_keep,
      (const uint8_t*)child_mask, (const uint8_t*)union_mask,
      (const __nv_bfloat16*)skip, (const __nv_bfloat16*)wd, (const float*)bd,
      (const float*)a1, (const float*)c1, (const float*)a2, (const float*)c2,
      (const __nv_bfloat16*)wr, (const float*)br, (const int*)box_min,
      (__nv_bfloat16*)out, (const int*)tile_ids, (const int*)n_active, X2, Z2,
      Y2, Ci, Co, scale);
  return (int)cudaGetLastError();
}
