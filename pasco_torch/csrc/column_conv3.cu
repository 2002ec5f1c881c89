// column_conv3: 'same' 3x3x3 conv over the listed 8x8xZ columns of an
// [X, Y, Z, C] f32 volume, at f32 accuracy on the TF32 tensor cores.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_conv.py:_kernel (entry
// block_sparse_conv3, call _block_conv_call).  Given x [X, Y, Z, Cs] f32,
// the wrapper's split weight image (below) and the column list ids[0 ..
// n_active) (flat id bx * ceil(Y/8) + by), it writes
//   out[x, y, z, :] = sum_t x[x+dx-1, y+dy-1, z+dz-1, :] @ w[t]  (+ bias at mask cells)
// at every cell of every listed column (zero padding outside the volume),
// and bias-at-mask-cells / 0 at every cell of the other columns: the whole
// output once, so the wrapper allocates it with torch.empty.
//
// What bounds it on an H100: operations.  At C = D = 64 a column of Z = 32
// is 0.45 GFLOP against 1.1 MB of halo.  The reference computes in f32,
// and the f32 FMA pipes peak at 67 TFLOP/s; the TF32 tensor cores at 495.
// One TF32 product keeps 11 bits of each operand (~3e-4 of max|out| here),
// so each operand is split, v = hi + lo with hi = rna_tf32(v) and lo =
// rna_tf32(v - hi), and three products are summed in f32, small ones first:
// lo_a hi_b + hi_a lo_b + hi_a hi_b (lo lo is below f32's rounding).  That
// is f32 accuracy (~5e-7 of max|out|) at 3 x the tensor work: the bound is
// 3 x FLOP / 495 TFLOP/s.  The design:
//   * Implicit GEMM.  A work item is one z-slab of ZS = 4 of one listed
//     column and 64 output channels: M = 8 x 8 x 4 = 256 output cells
//     (two warpgroups, two m64 blocks each), N = 64 (D is padded
//     to a multiple of 64 with zero weights), K = 27 taps x C.  Persistent
//     CTAs (one per SM) walk the items of the n_active listed columns,
//     reading ids and n_active on the device (no host sync).
//   * The slab's whole halo, 10 x 10 x 6 cells x 64 channels f32 (150 KB),
//     arrives by cp.async (zero-filled outside the volume and past C).  A
//     cell is a 256-byte row; its 16-byte chunks are XOR-swizzled by
//     (hz & 1) << 2, so the A-fragment loads of every tap (a constant row
//     shift) are free of bank conflicts.  C > 64 is walked in 64-channel
//     chunks, each with its own halo.  The next halo is issued as soon as
//     the last tap's A fragments are in registers, under the last products
//     and the epilogue; a second halo buffer does not fit beside the ring.
//   * A from registers: each thread loads its fragment rows straight from
//     the raw f32 halo at the tap's row offset (a shifted tap is no aligned
//     8-row core matrix, so no A descriptor fits), one 16-byte load per row
//     and k16 step (the k order inside each 8-step is permuted to make the
//     four values contiguous; the weight image uses the same order), and
//     splits it into hi and lo with cvt.rna.tf32 in registers.
//   * B by descriptor: wgmma.m64n64k8.f32.tf32.tf32, K-major (TF32 has no
//     transposed operand).  The wrapper splits the weights once per call
//     and lays them out as the shared-memory image itself: per (tap, 32
//     channels) one 16 KB unit, the hi and the lo slab of 64 rows x 128 B
//     with the 128-byte swizzle.  Thread 0 streams the units, two ahead,
//     through a 4-stage ring with bulk copies (cp.async.bulk) on full/empty
//     mbarriers; no CTA-wide barrier per tap.  (A producer warp of its own
//     made ptxas budget registers for three warpgroups: 168 a thread, and
//     the per-tap accumulators spilled.)
//   * Each (k16 step, m64 block) is one wgmma group (6 wgmmas) whose A
//     registers are free again when the block's last group is done, so
//     one block's next loads and splits overlap the other block's
//     products at no extra registers.
//   * The tensor core's f32 accumulation does not round to nearest, and its
//     error grows with the number of wgmmas that feed one accumulator: over
//     all 27 x 24 of a slab it reached 1e-5 of max|out| at the scan shape.
//     So each tap's products go to their own accumulator (the first with
//     scale-d = 0), which is added to the slab's sum with IEEE f32 adds.
//   * Epilogue from the fragment layout: the bias at mask cells, f32
//     stores of the cells inside the volume.  column_fill_kernel writes the
//     columns that are not listed (a bitmap the wrapper builds on the
//     device).
#include "common.cuh"

// COLUMN_CONV3_ABLATE (0 in the port's build) changes one part of the
// work, for scripts_torch/column_ablation.py to time: 1 removes the wgmmas,
// 2 the two small products (one TF32 product per k8 step), 3 the halo
// loads, 5 the fill of the unlisted columns, 6 the weight copies (the ring
// keeps what it holds); the results of these builds are wrong.  4 accumulates every product in the slab's sum (no per-tap
// accumulator): right, but less accurate.
#ifndef COLUMN_CONV3_ABLATE
#define COLUMN_CONV3_ABLATE 0
#endif

using namespace pasco;

namespace {

constexpr int ABLATE = COLUMN_CONV3_ABLATE;

constexpr int BLK = 8;                   // column x/y extent
constexpr int ZS = 4;                    // z-slab of a work item
constexpr int HX = BLK + 2, HZ = ZS + 2;
constexpr int CELLS = HX * HX * HZ;      // 600 halo cells
constexpr int ROW = 256;                 // bytes of a halo cell: 64 f32 channels
constexpr int N = 64;                    // output channels of a work item
constexpr int UNIT = 2 * N * 128;        // hi + lo slab of one (tap, 32 channels)
constexpr int STAGES = 4;                // weight ring
constexpr int THREADS = 256;             // two warpgroups
constexpr int SMEM = STAGES * UNIT + CELLS * ROW + 2 * STAGES * 8 + 1024;
static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block can use");

struct Params {
  const float* x;         // [X, Y, Z, Cs]
  const float* img;       // [ND][NKC][27][NB] units of [2][64][32] f32, swizzled
  const float* bias;      // [D] or null
  const uint8_t* mask;    // [X, Y, Z]
  const uint8_t* listed;  // [ceil(X/8) * ceil(Y/8)]
  float* out;             // [X, Y, Z, D]
  const int* ids;
  const int* n_active;
  int X, Y, Z, Cs, D, NB, NKC;
};

__global__ void __launch_bounds__(THREADS, 1) column_conv3_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const unsigned char* halo = smem + STAGES * UNIT;
  const uint32_t ring_s = smem_u32(smem), halo_s = ring_s + STAGES * UNIT;
  const uint32_t bars = halo_s + CELLS * ROW;   // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int X = p.X, Y = p.Y, Z = p.Z;
  const int by = (Y + BLK - 1) / BLK;
  const int NS = (Z + ZS - 1) / ZS, ND = (p.D + N - 1) / N;
  const int UPI = p.NKC * 27 * p.NB;   // weight units per item
  const int n_items = *p.n_active * NS * ND;

  // Thread 0 streams the weight units: unit q of this CTA's sequence (its
  // items in order, UPI units each) goes to stage q % STAGES once every
  // warp has released the unit that stage held.  It runs two units ahead
  // of the warpgroups, so the unit it waits for was released before.
  auto issue = [&](uint32_t q) {
    const int item = blockIdx.x + (int)(q / UPI) * gridDim.x;
    if (item >= n_items) return;
    const int s = q % STAGES;
    mbar_wait(empty(s), ((q / STAGES) & 1) ^ 1);
    if constexpr (ABLATE == 6) {
      mbar_arrive(full(s));
      return;
    }
    mbar_expect_tx(full(s), UNIT);
    bulk_copy_g2s(ring_s + s * UNIT,
                  p.img + ((size_t)(item % ND) * UPI + q % UPI) * (UNIT / 4), UNIT, full(s));
  };
  if (tid == 0) {
    issue(0);
    issue(1);
  }

  const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // Row g + 8h of m64 block mt is output cell (px, py, pz) of the slab:
  // px = 2 (2 wg + mt) + wq / 2, py = 4 (wq % 2) + 2h + g / 4, pz = g % 4.
  const int pz = g & 3;
  int cbase[2][2];   // its halo cell at tap (0, 0, 0)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 2 * (2 * wg + mt) + (wq >> 1), py = 4 * (wq & 1) + 2 * h + (g >> 2);
      cbase[mt][h] = (px * HX + py) * HZ + pz;
    }

  // Halo of item `it`, channels kc * 64 .. + 32 NB: chunk q of cell c at
  // c * ROW + 16 * ((q & 8) | ((q & 7) ^ ((hz & 1) << 2))).
  auto load_halo = [&](int it, int kc) {
    if constexpr (ABLATE != 3) {
      const int cid = p.ids[it / (NS * ND)];
      const int ox = (cid / by) * BLK - 1, oy = (cid % by) * BLK - 1;
      const int oz = ((it / ND) % NS) * ZS - 1;
      const int qn = p.NB * 8, qs = p.NB + 2;   // chunks per cell, log2
      for (int v = tid; v < CELLS * qn; v += THREADS) {
        const int cell = v >> qs, q = v & (qn - 1);
        const int hz = cell % HZ, hy = (cell / HZ) % HX, hx = cell / (HZ * HX);
        const int gx = ox + hx, gy = oy + hy, gz = oz + hz, ch = kc * 64 + 4 * q;
        const bool ok = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z &&
                        ch < p.Cs;
        const float* src = ok ? p.x + (((long long)gx * Y + gy) * Z + gz) * p.Cs + ch : p.x;
        cp_async16(halo_s + cell * ROW + (((q & 8) | ((q & 7) ^ ((hz & 1) << 2))) << 4), src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // acc: the item's sum; tap: one tap's products, folded into acc with
  // IEEE adds after the tap.  The tensor core's own f32 accumulation does
  // not round to nearest, and its error grows with the number of wgmmas
  // that feed one accumulator: 24 per tap instead of 27 x 24.
  float acc[2][32], tap[2][32];
  uint32_t ahi[2][2][4], alo[2][2][4];   // [mt][k8 step][reg] of one k16 step
  uint32_t k = 0;                        // weight units consumed

  if ((int)blockIdx.x < n_items) load_halo(blockIdx.x, 0);
#pragma unroll 1
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

#pragma unroll 1
    for (int kc = 0; kc < p.NKC; ++kc) {
      cp_async_wait<0>();
      __syncthreads();   // the halo of (it, kc) is in
#pragma unroll 1
      for (int t = 0; t < 27; ++t) {
        const int dz = t % 3;
        const int toff = ((t / 9) * HX + (t / 3) % 3) * HZ + dz;
        const int xr = ((pz + dz) & 1) << 2;
#pragma unroll 1
        for (int b = 0; b < p.NB; ++b, ++k) {
          if (tid == 0) issue(k + 2);
          const int st = k % STAGES;
          mbar_wait(full(st), (k / STAGES) & 1);
#pragma unroll
          for (int j = 0; j < 2; ++j) {     // k16 step j of the unit
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {  // one wgmma group per m64 block
              wgmma_wait<1>();                // the block's last group is done: A[mt] is free
              if (j == 0 && mt == 1 && b > 0 && lane == 0)
                mbar_arrive(empty((k - 1) % STAGES));   // ... and all of unit k - 1
              // Thread (g, t4) takes channels 4 t4 .. 4 t4 + 3 of the k16
              // step for rows g and g + 8: k position t4 of k8 step s is
              // channel 4 t4 + 2s, position t4 + 4 channel 4 t4 + 2s + 1.
              const int chunk = b * 8 + ((j * 4 + t4) ^ xr);
              float4 v[2];
#pragma unroll
              for (int h = 0; h < 2; ++h)
                v[h] = *reinterpret_cast<const float4*>(halo + (cbase[mt][h] + toff) * ROW +
                                                         chunk * 16);
              const float e[2][4] = {{v[0].x, v[1].x, v[0].y, v[1].y},
                                     {v[0].z, v[1].z, v[0].w, v[1].w}};
#pragma unroll
              for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  ahi[mt][s][r] = tf32_rna(e[s][r]);
                  alo[mt][s][r] = tf32_rna(e[s][r] - __uint_as_float(ahi[mt][s][r]));
                }
              wgmma_fence();
              auto& sum = ABLATE == 4 ? acc[mt] : tap[mt];
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                const uint64_t dhi =
                    smem_desc(ring_s + st * UNIT + (2 * j + s) * 32, 16, 1024);
                const uint64_t dlo = dhi + ((N * 128) >> 4);   // the lo slab, 8 KB on
                const int keep = b > 0 || j > 0 || s > 0;      // 0: the tap's first product
                if constexpr (ABLATE == 2) {
                  wgmma_tf32_n64(sum, ahi[mt][s], dhi, keep);
                } else if constexpr (ABLATE != 1) {
                  wgmma_tf32_n64(sum, alo[mt][s], dhi, ABLATE == 4 || keep);
                  wgmma_tf32_n64(sum, ahi[mt][s], dlo, 1);
                  wgmma_tf32_n64(sum, ahi[mt][s], dhi, 1);
                }
              }
              wgmma_commit();
            }
          }
        }
        if (t == 26) {
          // Every thread has its last A fragments of this halo: load the
          // next one under the last products and the epilogue.
          __syncthreads();
          if (kc + 1 < p.NKC) load_halo(it, kc + 1);
          else if (it + (int)gridDim.x < n_items) load_halo(it + gridDim.x, 0);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty((k - 1) % STAGES));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc_fence(tap[mt]);
          acc_fence(acc[mt]);
          if constexpr (ABLATE != 1 && ABLATE != 4) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[mt][i] += tap[mt][i];
          }
        }
      }
    }

    // Epilogue: d[4j + 2h + e] is row g + 8h, column 8j + 2 t4 + e.
    const int cid = p.ids[it / (NS * ND)];
    const int ox = (cid / by) * BLK, oy = (cid % by) * BLK;
    const int gz = ((it / ND) % NS) * ZS + pz, n0 = (it % ND) * N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = ox + 2 * (2 * wg + mt) + (wq >> 1);
        const int gy = oy + 4 * (wq & 1) + 2 * h + (g >> 2);
        if (gx >= X || gy >= Y || gz >= Z) continue;
        const long long cell = ((long long)gx * Y + gy) * Z + gz;
        const bool m = p.bias != nullptr && p.mask[cell];
        float* o = p.out + cell * p.D + n0;
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int col = 8 * jj + 2 * t4;
          if (n0 + col >= p.D) continue;
          float2 r = make_float2(acc[mt][4 * jj + 2 * h], acc[mt][4 * jj + 2 * h + 1]);
          if (m) {
            r.x += p.bias[n0 + col];
            r.y += p.bias[n0 + col + 1];
          }
          *reinterpret_cast<float2*>(o + col) = r;
        }
      }
  }
  cp_async_wait<0>();
}

// The columns that are not listed: the bias at mask cells, 0 elsewhere.
// One block per column; float4 stores along (z, channel).
__global__ void __launch_bounds__(256) column_fill_kernel(const Params p) {
  const int col = blockIdx.x;
  if (p.listed[col]) return;
  const int by = (p.Y + BLK - 1) / BLK;
  const int ox = (col / by) * BLK, oy = (col % by) * BLK;
  const int dq = p.D / 4, Z = p.Z;
  const int total = BLK * BLK * Z * dq;
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    const int q = v % dq, cell = v / dq;
    const int gz = cell % Z, pxy = cell / Z;
    const int gx = ox + pxy / BLK, gy = oy + pxy % BLK;
    if (gx >= p.X || gy >= p.Y) continue;
    const long long idx = ((long long)gx * p.Y + gy) * Z + gz;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.bias != nullptr && p.mask[idx]) {
      const float* bq = p.bias + 4 * q;
      r = make_float4(bq[0], bq[1], bq[2], bq[3]);
    }
    reinterpret_cast<float4*>(p.out + idx * p.D)[q] = r;
  }
}

}  // namespace

// x [X, Y, Z, Cs] f32 (Cs % 4 == 0, zero past C), img the split weight
// image of NKC chunks of 32 NB channels (NB in {1, 2}; NB = 1 only with
// NKC = 1) and ceil(D / 64) tiles of 64 output channels, bias [D] f32 or
// null, mask [X, Y, Z] and listed [ceil(X/8) ceil(Y/8)] bool, out
// [X, Y, Z, D] f32 (D % 16 == 0), ids [capacity], n_active [1] int32.
extern "C" int pasco_column_conv3(const void* x, const void* img, const void* bias,
                                  const void* mask, const void* listed, void* out,
                                  const void* ids, const void* n_active, int X, int Y, int Z,
                                  int Cs, int D, int NB, int NKC, int capacity, void* stream) {
  if (D <= 0 || D % 16 != 0 || capacity <= 0 || Cs <= 0 || Cs % 4 != 0 ||
      (NB != 1 && NB != 2) || NKC < 1 || (NB == 1 && NKC != 1) || Cs > 32 * NB * NKC)
    return (int)cudaErrorInvalidValue;
  const Params p{(const float*)x, (const float*)img, (const float*)bias, (const uint8_t*)mask,
                 (const uint8_t*)listed, (float*)out, (const int*)ids, (const int*)n_active,
                 X, Y, Z, Cs, D, NB, NKC};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      column_conv3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items =
      (long long)capacity * ((Z + ZS - 1) / ZS) * ((D + N - 1) / N);
  const int grid = items < sms ? (int)items : sms;
  if (grid > 0) {
    column_conv3_kernel<<<grid, THREADS, SMEM, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int cols = ((X + BLK - 1) / BLK) * ((Y + BLK - 1) / BLK);
  if (ABLATE != 5 && cols > 0 && Z > 0) column_fill_kernel<<<cols, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
