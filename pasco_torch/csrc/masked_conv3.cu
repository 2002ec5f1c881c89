// masked_conv3: the residual-chain and refiner 3x3x3 conv of the dense
// substrate, with its BN prologue and residual epilogue fused.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_conv.py:fused_packed_conv
// (_fused_kernel, _fused_conv_call).  Same meaning on the port's logical
// [X, Z, Y, C] bf16 layout (no z-pair packing, no padded buffers):
//   x'  = mask * [relu](a * x + c)                      (prologue)
//   out = mask * [relu](conv3_same(x', w) + bias [+ skip])  (epilogue)
// and out is exact zero at mask-invalid cells.
//
// It also replaces the training conv pasco_tpu/ops/pallas_conv.py:
// packed_conv_trainable (_packed_kernel, whose Pallas body differs from
// _fused_kernel only in the TPU layout): with the prologue off it is that
// conv's forward, and on the masked cotangent with flipped taps and Ci/Co
// swapped it is its data gradient (pasco_torch/ops/conv.py:MaskedConv3Fn).
//
// What bounds it on an H100: a full-box stride-1 conv is ~0.66 TFLOP
// against ~1 GB of bf16 traffic, far above the card's ~295 FLOP/byte
// balance point, so it is tensor-core bound.  Design: an implicit GEMM
// over active tiles only.  A block owns a tile of 8 (x, z) rows x 16 y
// cells (M = 128 output cells) and 64 output channels; it stages the tile's
// (TX+2)(TZ+2)(16+2)-cell halo for 32 input channels at a time in shared
// memory, applying the prologue once per halo cell, and then reads all 27
// taps' A fragments straight out of that halo (a tap is a constant offset
// into it, so consecutive y cells are consecutive rows).  Products run as
// 16x16x16 bf16 mma.sync fragments with f32 accumulation; the epilogue goes
// through shared memory so that stores are coalesced per cell.  Tiles come
// from a device-built list (active tiles first, count on the device), so
// empty space costs one early exit per block and no host sync.
#include "common.cuh"

using namespace nvcuda;
using namespace pasco;

namespace {

constexpr int TY = 16;        // y cells per tile row (= fragment rows)
constexpr int HY = TY + 2;
constexpr int KC = 32;        // input channels per staged halo chunk
constexpr int NT = 64;        // output channels per block
constexpr int WARPS = 8;      // one warp per (x, z) row of the tile
constexpr int MAX_HALO_CELLS = 10 * 3 * HY;   // max over TX*TZ == 8
constexpr int HALO_BYTES = MAX_HALO_CELLS * KC * 2;
constexpr int ACC_BYTES = WARPS * TY * NT * 4;
constexpr int SMEM_BYTES = HALO_BYTES > ACC_BYTES ? HALO_BYTES : ACC_BYTES;

__global__ void __launch_bounds__(WARPS * 32) masked_conv3_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ aff_a, const float* __restrict__ aff_c,
    const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ tile_ids, const int* __restrict__ n_active,
    int X, int Z, int Y, int Ci, int Co, int TX, int TZ, int relu_in,
    int relu_out) {
  if ((int)blockIdx.x >= *n_active) return;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  float* accs = reinterpret_cast<float*>(smem);

  const int nbz = (Z + TZ - 1) / TZ, nby = (Y + TY - 1) / TY;
  const int tid = tile_ids[blockIdx.x];
  const int y0 = (tid % nby) * TY;
  const int z0 = ((tid / nby) % nbz) * TZ;
  const int x0 = (tid / (nby * nbz)) * TX;
  const int n0 = blockIdx.y * NT;
  const int HZd = TZ + 2;
  const int n_halo = (TX + 2) * HZd * HY;

  const int warp = threadIdx.x / 32;
  const int tx = warp / TZ, tz = warp % TZ;

  FragC acc[NT / 16];
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < Ci; c0 += KC) {
    __syncthreads();
    // Stage the halo chunk with the prologue applied (8 channels a thread).
    for (int v = threadIdx.x; v < n_halo * (KC / 8); v += blockDim.x) {
      const int cell = v / (KC / 8), part = v % (KC / 8);
      const int hy = cell % HY, hz = (cell / HY) % HZd, hx = cell / (HY * HZd);
      const int gx = x0 - 1 + hx, gz = z0 - 1 + hz, gy = y0 - 1 + hy;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (gx >= 0 && gx < X && gz >= 0 && gz < Z && gy >= 0 && gy < Y) {
        const long long g = ((long long)gx * Z + gz) * Y + gy;
        if (mask[g]) {
          const int c = c0 + part * 8;
          packed = *reinterpret_cast<const uint4*>(x + g * Ci + c);
          if (aff_a != nullptr || relu_in) {
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float f = bf(e[i]);
              if (aff_a != nullptr) f = aff_a[c + i] * f + aff_c[c + i];
              if (relu_in) f = fmaxf(f, 0.f);
              e[i] = tobf(f);
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(halo + (long long)cell * KC + part * 8) = packed;
    }
    __syncthreads();
    for (int dx = 0; dx < 3; ++dx)
      for (int dy = 0; dy < 3; ++dy)
        for (int dz = 0; dz < 3; ++dz) {
          const int tap = (dx * 3 + dy) * 3 + dz;   // kernel_offsets(3) order
          const __nv_bfloat16* a_base =
              halo + (((tx + dx) * HZd + (tz + dz)) * HY + dy) * KC;
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, a_base + kk, KC);
            const __nv_bfloat16* b_base =
                w + ((long long)tap * Ci + c0 + kk) * Co + n0;
#pragma unroll
            for (int j = 0; j < NT / 16; ++j) {
              FragB b;
              wmma::load_matrix_sync(b, b_base + j * 16, Co);
              wmma::mma_sync(acc[j], a, b, acc[j]);
            }
          }
        }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
    wmma::store_matrix_sync(accs + warp * TY * NT + j * 16, acc[j], NT,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < WARPS * TY * NT; e += blockDim.x) {
    const int row = e / NT, col = e % NT;
    const int rw = row / TY;
    const int gx = x0 + rw / TZ, gz = z0 + rw % TZ, gy = y0 + row % TY;
    if (gx >= X || gz >= Z || gy >= Y) continue;
    const long long g = ((long long)gx * Z + gz) * Y + gy;
    const long long o = g * Co + n0 + col;
    float v = 0.f;
    if (mask[g]) {
      v = accs[e];
      if (bias != nullptr) v += bias[n0 + col];
      if (skip != nullptr) v += bf(skip[o]);
      if (relu_out) v = fmaxf(v, 0.f);
    }
    out[o] = tobf(v);
  }
}

}  // namespace

extern "C" int pasco_masked_conv3(
    const void* x, const void* mask, const void* w, const void* bias,
    const void* aff_a, const void* aff_c, const void* skip, void* out,
    const void* tile_ids, const void* n_active, int X, int Z, int Y, int Ci,
    int Co, int TX, int TZ, int relu_in, int relu_out, int n_tiles,
    void* stream) {
  if (Ci % KC != 0 || Co % NT != 0 || TX * TZ != WARPS) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  dim3 grid(n_tiles, Co / NT);
  masked_conv3_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)mask, (const __nv_bfloat16*)w,
      (const float*)bias, (const float*)aff_a, (const float*)aff_c,
      (const __nv_bfloat16*)skip, (__nv_bfloat16*)out, (const int*)tile_ids,
      (const int*)n_active, X, Z, Y, Ci, Co, TX, TZ, relu_in, relu_out);
  return (int)cudaGetLastError();
}
