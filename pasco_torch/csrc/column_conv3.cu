// column_conv3: 'same' 3x3x3 conv over the listed 8x8xZ columns, f32.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_conv.py:_kernel (entry
// block_sparse_conv3, call _block_conv_call).  Given x [X, Y, Z, C] f32,
// w [27, C, D] f32 (taps x-major, z fastest: t = dx*9 + dy*3 + dz) and the
// column list ids[0 .. n_active) (flat id bx * ceil(Y/8) + by), it writes
//   out[x, y, z, :] = sum_t x[x+dx-1, y+dy-1, z+dz-1, :] @ w[t]
// at every cell of every listed column (zero padding outside the volume)
// and leaves every other cell untouched (the wrapper zero-fills out).
//
// What bounds it on an H100: arithmetic.  A full column at Z=32, C=D=64 is
// 0.45 GFLOP against 1.1 MB of input halo, and the reference computes in
// f32, so the products run on the f32 FMA units (67 TFLOP/s), not the
// tensor cores.  The design keeps the FMA pipes fed from registers:
//   * one block per listed column (blocks past n_active exit at once);
//   * the column is walked in z-slabs of ZS = 8 and output channel tiles
//     of DT = 64; for each (slab, tile) the (8+2) x (8+2) x (ZS+2) input
//     halo and the matching weights are staged in shared memory in input
//     channel chunks of CK = 16 (64 KB + 111 KB);
//   * each of the 512 threads owns one (x, y), four consecutive z and 16
//     output channels (64 f32 accumulators): per input channel and (dx,
//     dy) it loads six z-neighbours once and reuses them across the three
//     dz taps, and reads the weights as float4 broadcasts (every thread of
//     a warp reads the same channel group).
#include "common.cuh"

namespace {

constexpr int BLK = 8;                 // column x/y extent
constexpr int ZS = 8;                  // z-slab
constexpr int DT = 64;                 // output channels per tile
constexpr int CK = 16;                 // input channels per staged chunk
constexpr int HX = BLK + 2, HZ = ZS + 2;
constexpr int HALO = HX * HX * HZ;     // halo cells per slab
constexpr int THREADS = BLK * BLK * (ZS / 4) * (DT / 16);   // 512
constexpr size_t SMEM = (size_t)(CK * HALO + 27 * CK * DT) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1) column_conv3_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, const int* __restrict__ ids,
    const int* __restrict__ n_active, int X, int Y, int Z, int C, int D) {
  if ((int)blockIdx.x >= *n_active) return;
  extern __shared__ float smem[];
  float* halo = smem;                  // [CK][HX][HX][HZ]
  float* ws = smem + CK * HALO;        // [27][CK][DT]
  const int by = (Y + BLK - 1) / BLK;
  const int cid = ids[blockIdx.x];
  const int ox = (cid / by) * BLK, oy = (cid % by) * BLK;
  const int t = threadIdx.x;
  const int xy = t & 63, zg = (t >> 6) & 1, cg = t >> 7;
  const int px = xy >> 3, py = xy & 7;

  for (int z0 = 0; z0 < Z; z0 += ZS) {
    for (int d0 = 0; d0 < D; d0 += DT) {
      const int dc = d0 + cg * 16;     // this thread's first output channel
      float acc[4][16];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[j][k] = 0.f;

      for (int c0 = 0; c0 < C; c0 += CK) {
        __syncthreads();
        // Stage the input halo: consecutive threads read consecutive
        // channels of one cell (coalesced), zero outside the volume.
        for (int i = t; i < CK * HALO; i += THREADS) {
          const int ci = i % CK, cell = i / CK;
          const int hz = cell % HZ, hy = (cell / HZ) % HX, hx = cell / (HZ * HX);
          const int gx = ox + hx - 1, gy = oy + hy - 1, gz = z0 + hz - 1;
          float v = 0.f;
          if (c0 + ci < C && gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
            v = x[(((long long)gx * Y + gy) * Z + gz) * C + c0 + ci];
          halo[ci * HALO + cell] = v;
        }
        // Stage the weights of this chunk and tile, zero past C and D.
        for (int i = t; i < 27 * CK * DT; i += THREADS) {
          const int dd = i % DT, ci = (i / DT) % CK, tap = i / (DT * CK);
          float v = 0.f;
          if (c0 + ci < C && d0 + dd < D)
            v = w[((long long)tap * C + c0 + ci) * D + d0 + dd];
          ws[i] = v;
        }
        __syncthreads();
        if (dc < D) {
          for (int ci = 0; ci < CK; ++ci) {
            const float* hc = halo + ci * HALO;
#pragma unroll 1
            for (int dxy = 0; dxy < 9; ++dxy) {
              const int ddx = dxy / 3, ddy = dxy % 3;
              const float* col = hc + ((px + ddx) * HX + (py + ddy)) * HZ + zg * 4;
              float v[6];
#pragma unroll
              for (int j = 0; j < 6; ++j) v[j] = col[j];
#pragma unroll
              for (int ddz = 0; ddz < 3; ++ddz) {
                const int tap = dxy * 3 + ddz;
                const float4* wr = reinterpret_cast<const float4*>(
                    ws + (tap * CK + ci) * DT + cg * 16);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float4 wv = wr[q];
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float a = v[j + ddz];
                    acc[j][4 * q + 0] = fmaf(a, wv.x, acc[j][4 * q + 0]);
                    acc[j][4 * q + 1] = fmaf(a, wv.y, acc[j][4 * q + 1]);
                    acc[j][4 * q + 2] = fmaf(a, wv.z, acc[j][4 * q + 2]);
                    acc[j][4 * q + 3] = fmaf(a, wv.w, acc[j][4 * q + 3]);
                  }
                }
              }
            }
          }
        }
      }
      // D % 16 == 0 (the wrapper checks), so a live channel group is whole.
      const int gx = ox + px, gy = oy + py;
      if (dc < D && gx < X && gy < Y) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gz = z0 + zg * 4 + j;
          if (gz >= Z) continue;
          float4* o = reinterpret_cast<float4*>(
              out + (((long long)gx * Y + gy) * Z + gz) * D + dc);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                               acc[j][4 * q + 3]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int pasco_column_conv3(const void* x, const void* w, void* out,
                                  const void* ids, const void* n_active, int X,
                                  int Y, int Z, int C, int D, int capacity,
                                  void* stream) {
  if (D % 16 != 0 || capacity <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      column_conv3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  column_conv3_kernel<<<capacity, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, (const int*)ids,
      (const int*)n_active, X, Y, Z, C, D);
  return (int)cudaGetLastError();
}
