// down2_fused: the encoder's stride-2 down step with both BN affines fused.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_down.py:down_padded_to_padded
// (_down_kernel, _down_call).  On the port's [X, Z, Y, C] bf16 layout:
//   out[p] = mask_out[p] * relu(a2 * leaky(a1 * (sum_k (x * mask_in)[2p + o_k]
//            @ w[k] + b) + c1) + c2),   o_k = kernel_offsets(2)
// with mask_out = maxpool2_mask(mask_in); out is exact zero elsewhere.
//
// What bounds it on an H100: one implicit GEMM with K = 8 * Ci that reads
// each input cell exactly once (stride-2 children do not overlap), so it
// moves ~8x fewer bytes per output than the 3^3 conv and is small next to
// it (~0.1 TFLOP at enc_s2).  Design: a block owns 128 consecutive output
// cells (flat [X2, Z2, Y2] order, so every tile is full-width and only the
// last is ragged) and 64 output channels; for each of the 8 children and
// each 32-channel chunk it stages the masked child rows in shared memory,
// runs 16x16x16 bf16 mma.sync fragments with f32 accumulation, and applies
// bias, both affines and the activations in one epilogue pass.  Tiles with
// no valid output cell are skipped through the device-built tile list.
#include "common.cuh"

using namespace nvcuda;
using namespace pasco;

namespace {

constexpr int ROWS = 128;     // output cells per block
constexpr int KC = 32;        // input channels per staged chunk
constexpr int NT = 64;        // output channels per block
constexpr int WARPS = ROWS / 16;

__global__ void __launch_bounds__(WARPS * 32) down2_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask_in,
    const uint8_t* __restrict__ mask_out, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ a1,
    const float* __restrict__ c1, const float* __restrict__ a2,
    const float* __restrict__ c2, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ tile_ids, const int* __restrict__ n_active,
    int X, int Z, int Y, int Ci, int Co) {
  if ((int)blockIdx.x >= *n_active) return;
  __shared__ __align__(128) __nv_bfloat16 a_tile[ROWS * KC];
  __shared__ __align__(128) float accs[ROWS * NT];

  const int Z2 = Z / 2, Y2 = Y / 2;
  const long long n_out = (long long)(X / 2) * Z2 * Y2;
  const long long row0 = (long long)tile_ids[blockIdx.x] * ROWS;
  const int n0 = blockIdx.y * NT;
  const int warp = threadIdx.x / 32;

  FragC acc[NT / 16];
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k = 0; k < 8; ++k) {
    const int ix = k >> 2, iy = (k >> 1) & 1, iz = k & 1;   // (x, y, z) offset
    for (int c0 = 0; c0 < Ci; c0 += KC) {
      __syncthreads();
      for (int v = threadIdx.x; v < ROWS * (KC / 8); v += blockDim.x) {
        const int r = v / (KC / 8), part = v % (KC / 8);
        const long long o = row0 + r;
        uint4 packed = make_uint4(0, 0, 0, 0);
        if (o < n_out) {
          const int oy = (int)(o % Y2), oz = (int)((o / Y2) % Z2);
          const int ox = (int)(o / ((long long)Y2 * Z2));
          const long long g =
              ((long long)(2 * ox + ix) * Z + (2 * oz + iz)) * Y + (2 * oy + iy);
          if (mask_in[g])
            packed = *reinterpret_cast<const uint4*>(x + g * Ci + c0 + part * 8);
        }
        *reinterpret_cast<uint4*>(a_tile + r * KC + part * 8) = packed;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, a_tile + warp * 16 * KC + kk, KC);
        const __nv_bfloat16* b_base = w + ((long long)k * Ci + c0 + kk) * Co + n0;
#pragma unroll
        for (int j = 0; j < NT / 16; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, b_base + j * 16, Co);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
    wmma::store_matrix_sync(accs + warp * 16 * NT + j * 16, acc[j], NT,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * NT; e += blockDim.x) {
    const long long o = row0 + e / NT;
    if (o >= n_out) continue;
    const int col = n0 + e % NT;
    float v = 0.f;
    if (mask_out[o]) {
      v = accs[e] + bias[col];
      v = leaky(a1[col] * v + c1[col]);
      v = fmaxf(a2[col] * v + c2[col], 0.f);
    }
    out[o * Co + col] = tobf(v);
  }
}

}  // namespace

extern "C" int pasco_down2_fused(
    const void* x, const void* mask_in, const void* mask_out, const void* w,
    const void* bias, const void* a1, const void* c1, const void* a2,
    const void* c2, void* out, const void* tile_ids, const void* n_active,
    int X, int Z, int Y, int Ci, int Co, int n_tiles, void* stream) {
  if (Ci % KC != 0 || Co % NT != 0 || X % 2 || Z % 2 || Y % 2)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  dim3 grid(n_tiles, Co / NT);
  down2_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)mask_in,
      (const uint8_t*)mask_out, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)a1, (const float*)c1, (const float*)a2, (const float*)c2,
      (__nv_bfloat16*)out, (const int*)tile_ids, (const int*)n_active, X, Z, Y,
      Ci, Co);
  return (int)cudaGetLastError();
}
