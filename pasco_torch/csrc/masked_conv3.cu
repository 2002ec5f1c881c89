// masked_conv3: the residual-chain and refiner 3x3x3 conv of the dense
// substrate, with its BN prologue and residual epilogue fused.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_conv.py:fused_packed_conv
// (_fused_kernel, _fused_conv_call).  Same meaning on the port's logical
// [X, Z, Y, C] bf16 layout (no z-pair packing, no padded buffers):
//   x'  = mask * [relu](a * x + c)                      (prologue)
//   out = mask * [relu](conv3_same(x', w) + bias [+ skip])  (epilogue)
// with f32 accumulation, and out is exact zero at mask-invalid cells.
//
// It also replaces the training conv pasco_tpu/ops/pallas_conv.py:
// packed_conv_trainable (_packed_kernel, whose Pallas body differs from
// _fused_kernel only in the TPU layout): with the prologue off it is that
// conv's forward, and with `flip` set it is its data gradient: it reads
// the original [27, C, C] weight with the taps reversed and Ci/Co swapped
// (w_t[t] = w[26 - t]^T), so no transposed copy is made per launch
// (pasco_torch/ops/conv.py:MaskedConv3Fn).
//
// What bounds it on an H100: a stride-1 3^3 conv at Ci = Co = 64..256 does
// 27 * Ci * 2 FLOP per output value against a few bytes per cell, far
// above the card's ~295 FLOP/byte balance point, so its bound is the bf16
// tensor-core rate (989 TFLOP/s dense).  Within the SM the operands of
// every tap pass through shared memory (A by ldmatrix, B by wgmma): at
// C = 64 that is 128 B per 4 KFLOP, the SM's whole shared-memory rate at
// the tensor peak, so C = 64 is shared-memory bound as well.  The design:
//   * Only Ci = Co in {64, 128, 256} (the model's widths); the host entry
//     refuses other widths.
//   * One CTA (two consumer warpgroups, 256 threads) owns a tile of
//     4 x 4 x 16 output cells (M = 256) and N output channels: all of them
//     (N = C) at C = 64 and 128; at C = 256 two CTAs split the channels
//     (N = 128 each), which keeps the accumulators at 128 registers a
//     thread.  Its halo, 6 x 6 x 18 cells (2.5 per output cell), is staged
//     once per 64-channel chunk, with the prologue applied once per cell.
//   * Halo staging: the tile's valid cells are read from the mask once
//     into a flag per halo cell; cp.async with zero-fill for masked and
//     out-of-box cells; then (prologue launches only) one in-place pass in
//     shared memory that applies a*x+c and relu at the valid cells.  A
//     halo cell is one 128-byte row whose eight 16-byte chunks are XOR-
//     swizzled by (cell % 8), so the ldmatrix of any tap (a constant row
//     shift) hits eight distinct bank groups.
//   * A from registers (ldmatrix at the tap's row offset), B from shared
//     memory by descriptor: wgmma.m64nNk16, N the CTA's output channels.
//     Weights stream through a ring of [64 x N] bf16 slabs per (tap,
//     64-channel chunk),
//     128-byte swizzled: N-major from w[t] in the forward, K-major from
//     w[26 - t] in the flipped (dx) mode.  cp.async fills each slab
//     STAGES - 2 steps ahead of the wgmmas that read it.
//   * A fragments in two register sets, each phase of k16 steps committed
//     as its own wgmma group, so the next ldmatrix overlaps the running
//     products; one __syncthreads per tap frees the ring slot.
//   * Persistent CTAs (SMs x resident CTAs) walk the device-built tile list
//     (active tiles first, their count on the device: no host sync).  At
//     C = 64 two CTAs share an SM (3 ring slots each), so one CTA's halo
//     staging and epilogue overlap the other's products; at C = 128 and
//     256 one CTA holds a deeper ring (8 slots).  Inactive tiles are
//     written as zeros, so the output needs no memset.
//   * Epilogue on the f32 accumulators: bias, skip, relu, mask, bf16x2
//     stores straight from the fragment layout.
// Measured on an H100 (PERF.md): 33-43% of the bf16 bound on near-dense
// masks at s1-s4 and the train box, and slower there than one F.conv3d.  The weight slabs, the per-tap barrier and the ldmatrix each cost
// 5-20% of the time, and without its products the kernel still takes half
// of it: staging and the epilogue do not overlap the products of their own
// CTA (scripts_torch/conv_ablation.py).  That is the next thing to remove.
#include "common.cuh"

// MASKED_CONV3_ABLATE (0 in the model's build) removes one part of the
// per-tap loop, for scripts_torch/conv_ablation.py to time: 1 the
// weight-slab loads, 2 the per-tap barrier, 3 the ldmatrix, 4 the wgmma.
// The results of such a build are wrong.
#ifndef MASKED_CONV3_ABLATE
#define MASKED_CONV3_ABLATE 0
#endif

using namespace pasco;

namespace {

constexpr int ABLATE = MASKED_CONV3_ABLATE;

constexpr int THREADS = 256;          // two consumer warpgroups
constexpr int TY = 16, TZ = 4;        // tile: TX x TZ x TY output cells
constexpr int HY = TY + 2, HZ = TZ + 2;
constexpr int KC = 64;                // channels per halo chunk / slab rows
constexpr int CELL_BYTES = KC * 2;    // one halo cell: 128 bytes

constexpr int MB = 2;                 // m64 blocks per warpgroup
constexpr int TX = 2 * MB;            // 8 * MB lines of 16 cells / TZ
constexpr int NPH = 4;                // wgmma groups (one k16 step each) per tap
constexpr int CELLS = (TX + 2) * HZ * HY;   // halo cells
constexpr int FLAGS = (CELLS + 15) / 16 * 16;

// Per channel count C = Ci = Co: N output channels per CTA (C / N CTAs
// split a tile's channels), STAGES weight-ring slots, CTAS resident CTAs
// per SM the launch bounds aim for.
template <int C> struct Cfg;
template <> struct Cfg<64> { static constexpr int N = 64, STAGES = 3, CTAS = 2; };
template <> struct Cfg<128> { static constexpr int N = 128, STAGES = 8, CTAS = 1; };
template <> struct Cfg<256> { static constexpr int N = 128, STAGES = 8, CTAS = 1; };

template <int C> struct Geom {
  static constexpr int N = Cfg<C>::N, STAGES = Cfg<C>::STAGES;
  static constexpr int SPLIT = C / N;               // CTAs per tile
  static constexpr int SLAB = KC * N * 2;           // bytes of one weight slab
  static constexpr int BYTES = STAGES * SLAB + CELLS * CELL_BYTES + FLAGS +
                               3 * C * 4 + 1024;   // + alignment slack
  static_assert(BYTES <= 232448, "over the 227 KB of shared memory a block can use");
};

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* mask;
  const __nv_bfloat16* w;
  const float* bias;
  const float* aff_a;
  const float* aff_c;
  const __nv_bfloat16* skip;
  __nv_bfloat16* out;
  const int* tile_ids;
  const int* n_active;
  int X, Z, Y, n_tiles, relu_in, relu_out;
};

// Weight slab `s` (tap s % 27, channel chunk s / 27) of output channels
// n0..n0+N into ring slot `dst`.  Forward: B[k][n] = w[t][kc*64 + k][n0 + n],
// stored N-major: 64-column atoms of 64 rows x 128 B (8 KB apart), row k
// at k * 128, 16-byte chunk c of the atom at (c ^ k % 8).  Flipped:
// B[k][n] = w[26 - t][n0 + n][kc*64 + k], stored K-major: row n at
// (n / 8) * 1024 + (n % 8) * 128, chunk c of its 64 k at (c ^ n % 8).
template <int C, int N, bool FLIP>
__device__ __forceinline__ void load_slab(uint32_t dst, const __nv_bfloat16* w, int s, int n0) {
  const int kc = s / 27, t = s % 27;
  if constexpr (!FLIP) {
    const __nv_bfloat16* src = w + ((long long)t * C + kc * KC) * C + n0;
#pragma unroll
    for (int v = threadIdx.x; v < KC * N / 8; v += THREADS) {
      const int k = v / (N / 8), c = v % (N / 8);
      cp_async16(dst + (c >> 3) * (KC * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4),
                 src + (long long)k * C + c * 8, 16);
    }
  } else {
    const __nv_bfloat16* src = w + ((long long)(26 - t) * C + n0) * C + kc * KC;
#pragma unroll
    for (int v = threadIdx.x; v < KC * N / 8; v += THREADS) {
      const int n = v >> 3, c = v & 7;
      cp_async16(dst + (n >> 3) * 1024 + (n & 7) * 128 + ((c ^ (n & 7)) << 4),
                 src + (long long)n * C + c * 8, 16);
    }
  }
}

template <int C, bool FLIP>
__global__ void __launch_bounds__(THREADS, Cfg<C>::CTAS) masked_conv3_kernel(const Params p) {
  using G = Geom<C>;
  constexpr int N = G::N, SPLIT = G::SPLIT, STAGES = G::STAGES, SLAB = G::SLAB;
  constexpr int STEPS = (C / KC) * 27;   // (chunk, tap) steps per tile
  constexpr int D = STAGES - 2;          // slabs in flight ahead of the wgmmas
  constexpr int TB = FLIP ? 0 : 1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* halo = smem + STAGES * SLAB;
  uint8_t* flags = halo + CELLS * CELL_BYTES;
  float* s_a = reinterpret_cast<float*>(flags + FLAGS);
  float* s_c = s_a + C;
  float* s_bias = s_c + C;
  const uint32_t ring_s = smem_u32(smem), halo_s = smem_u32(halo);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const bool affine = p.aff_a != nullptr;
  const bool prologue = affine || p.relu_in;
  for (int i = tid; i < C; i += THREADS) {
    s_a[i] = affine ? p.aff_a[i] : 1.f;
    s_c[i] = affine ? p.aff_c[i] : 0.f;
    s_bias[i] = p.bias != nullptr ? p.bias[i] : 0.f;
  }
  const int n_active = *p.n_active;
  __syncthreads();   // s_a, s_c, s_bias
  const int X = p.X, Z = p.Z, Y = p.Y;
  const int nbz = (Z + TZ - 1) / TZ, nby = (Y + TY - 1) / TY;

  // Warp wq of warpgroup wg owns line (wg * MB + mb) * 4 + wq of the tile
  // (line = tx * TZ + tz, 16 y cells) in its m64 block mb.  ldmatrix lane
  // `lane` addresses row lane % 16 at 8-channel chunk lane / 16.
  int lbase[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int L = (wg * MB + mb) * 4 + wq;
    lbase[mb] = ((L / TZ + 1) * HZ + (L % TZ + 1)) * HY + 1 + (lane & 15);
  }
  const int hi = lane >> 4;

  float acc[MB][N / 2];

  // Work item `it` is output channels n0..n0+N of tile tile_ids[it / SPLIT].
  for (int it = blockIdx.x; it < p.n_tiles * SPLIT; it += gridDim.x) {
    const int tile = p.tile_ids[it / SPLIT], n0 = (it % SPLIT) * N;
    const int y0 = (tile % nby) * TY, z0 = ((tile / nby) % nbz) * TZ;
    const int x0 = (tile / (nby * nbz)) * TX;
    __syncthreads();   // the last tile's readers of the halo and ring are done

    if (it >= n_active * SPLIT) {   // no valid cell: zeros, so no memset
      for (int v = tid; v < TX * TZ * TY * (N / 8); v += THREADS) {
        const int row = v / (N / 8), c = v % (N / 8), line = row / TY;
        const int gx = x0 + line / TZ, gz = z0 + line % TZ, gy = y0 + row % TY;
        if (gx < X && gz < Z && gy < Y)
          *reinterpret_cast<uint4*>(p.out + (((long long)gx * Z + gz) * Y + gy) * C + n0 +
                                    c * 8) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }

#pragma unroll
    for (int s = 0; s < D; ++s) {
      load_slab<C, N, FLIP>(ring_s + s * SLAB, p.w, s, n0);
      cp_async_commit();
    }
    // Halo cells that are in the box and valid (the same for every chunk).
    for (int cell = tid; cell < CELLS; cell += THREADS) {
      const int hy = cell % HY, hz = (cell / HY) % HZ, hx = cell / (HY * HZ);
      const int gx = x0 - 1 + hx, gz = z0 - 1 + hz, gy = y0 - 1 + hy;
      flags[cell] = gx >= 0 && gx < X && gz >= 0 && gz < Z && gy >= 0 && gy < Y &&
                    p.mask[((long long)gx * Z + gz) * Y + gy] != 0;
    }
    __syncthreads();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mb][i] = 0.f;

#pragma unroll 1
    for (int kc = 0; kc < C / KC; ++kc) {
      if (kc > 0) {
        wgmma_wait<0>();
        __syncthreads();   // every warpgroup is done with the last chunk's halo
      }
      // Stage the halo chunk: zero-filled at masked and out-of-box cells.
      for (int v = tid; v < CELLS * 8; v += THREADS) {
        const int cell = v >> 3, part = v & 7;
        const bool ok = flags[cell];
        const __nv_bfloat16* src = p.x;
        if (ok) {
          const int hy = cell % HY, hz = (cell / HY) % HZ, hx = cell / (HY * HZ);
          src += (((long long)(x0 - 1 + hx) * Z + (z0 - 1 + hz)) * Y + (y0 - 1 + hy)) * C +
                 kc * KC + part * 8;
        }
        cp_async16(halo_s + cell * CELL_BYTES + ((part ^ (cell & 7)) << 4), src, ok ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      if (prologue) {   // x' = relu?(a * x + c) at valid cells, in place
        // THREADS is a multiple of 8, so a thread's 8 channels stay fixed.
        const int part = tid & 7, c0 = kc * KC + part * 8;
        float ra[8], rc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ra[i] = s_a[c0 + i];
          rc[i] = s_c[c0 + i];
        }
        constexpr int BATCH = 4, STRIDE = THREADS / 8;
        for (int cell0 = tid >> 3; cell0 < CELLS; cell0 += BATCH * STRIDE) {
          uint4 u[BATCH];   // loads of the batch first, then its stores
          bool ok[BATCH];
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            const int cell = cell0 + k * STRIDE;
            ok[k] = cell < CELLS && flags[cell];
            if (ok[k])
              u[k] = *reinterpret_cast<const uint4*>(halo + cell * CELL_BYTES +
                                                     ((part ^ (cell & 7)) << 4));
          }
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            if (!ok[k]) continue;
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u[k]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float2 f = __bfloat1622float2(e[i]);
              f.x = ra[2 * i] * f.x + rc[2 * i];
              f.y = ra[2 * i + 1] * f.y + rc[2 * i + 1];
              if (p.relu_in) {
                f.x = fmaxf(f.x, 0.f);
                f.y = fmaxf(f.y, 0.f);
              }
              e[i] = __float22bfloat162_rn(f);
            }
            const int cell = cell0 + k * STRIDE;
            *reinterpret_cast<uint4*>(halo + cell * CELL_BYTES + ((part ^ (cell & 7)) << 4)) =
                u[k];
          }
        }
        __syncthreads();
      }

#pragma unroll 1
      for (int t = 0; t < 27; ++t) {
        const int s = kc * 27 + t;
        wgmma_wait<1>();        // all of step s-2 is done: its ring slot is free
        cp_async_wait<D - 1>(); // this thread's part of slab s has landed
        if constexpr (ABLATE != 2) {
          fence_async_smem();
          __syncthreads();
        }
        if (ABLATE != 1 && s + D < STEPS)
          load_slab<C, N, FLIP>(ring_s + ((s + D) % STAGES) * SLAB, p.w, s + D, n0);
        cp_async_commit();

        const uint32_t slot = ring_s + (s % STAGES) * SLAB;
        const int toff = (t / 9 - 1) * HZ * HY + (t % 3 - 1) * HY + ((t / 3) % 3 - 1);
        // A fragments in two register sets, alternating by phase: the
        // ldmatrix of one phase overlaps the wgmmas of the one before.
        uint32_t a[2][MB][4];
#pragma unroll
        for (int ph = 0; ph < NPH; ++ph) {   // phase ph: the slab's k16 step ph
          const int buf = ph & 1;
          if (ph > 0) wgmma_wait<1>();   // the phase that last used `buf` is done
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const int cell = lbase[mb] + toff;
            if constexpr (ABLATE != 3)
              ldmatrix_x4(a[buf][mb], halo_s + cell * CELL_BYTES +
                                          (((ph * 2 + hi) ^ (cell & 7)) << 4));
          }
          wgmma_fence();
          const uint64_t desc = FLIP ? smem_desc(slot + ph * 32, 16, 1024)
                                     : smem_desc(slot + ph * 2048, KC * 128, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            if constexpr (ABLATE != 4) wgmma<N, TB>(acc[mb], a[buf][mb], desc);
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) acc_fence(acc[mb]);

    // Epilogue on the f32 accumulators, straight from the fragment layout:
    // d[4j + 2h + e] is row g + 8h, column 8j + 2(lane % 4) + e of the m64
    // block, g = lane / 4.  Every skip load of the tile comes before its
    // stores (the compiler cannot tell that they do not alias, and would
    // wait on each load in turn).
    long long gidx[MB][2];
    __nv_bfloat162 sk[MB][2][N / 8];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int L = (wg * MB + mb) * 4 + wq;
      const int gx = x0 + L / TZ, gz = z0 + L % TZ;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ty = (lane >> 2) + 8 * h, gy = y0 + ty;
        const bool in_box = gx < X && gz < Z && gy < Y;
        const bool valid = in_box && flags[((L / TZ + 1) * HZ + (L % TZ + 1)) * HY + ty + 1];
        // -1: out of the box (no store); -2 - g: a masked cell (zeros)
        const long long g = ((long long)gx * Z + gz) * Y + gy;
        gidx[mb][h] = !in_box ? -1 : valid ? g : -2 - g;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          sk[mb][h][j] = valid && p.skip != nullptr
                             ? *reinterpret_cast<const __nv_bfloat162*>(
                                   p.skip + g * C + n0 + 8 * j + 2 * (lane & 3))
                             : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gi = gidx[mb][h];
        if (gi == -1) continue;
        const bool valid = gi >= 0;
        __nv_bfloat16* o = p.out + (valid ? gi : -2 - gi) * C + n0;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          float2 v = make_float2(0.f, 0.f);
          if (valid) {
            const float2 q = __bfloat1622float2(sk[mb][h][j]);
            v.x = acc[mb][4 * j + 2 * h] + s_bias[n0 + col] + q.x;
            v.y = acc[mb][4 * j + 2 * h + 1] + s_bias[n0 + col + 1] + q.y;
            if (p.relu_out) {
              v.x = fmaxf(v.x, 0.f);
              v.y = fmaxf(v.y, 0.f);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __float22bfloat162_rn(v);
        }
      }
  }
  cp_async_wait<0>();
}

template <int C, bool FLIP>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = masked_conv3_kernel<C, FLIP>;
  constexpr int bytes = Geom<C>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int items = p.n_tiles * Geom<C>::SPLIT;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C = Ci = Co in {64, 128, 256}; flip != 0 runs the data-gradient mode.
extern "C" int pasco_masked_conv3(
    const void* x, const void* mask, const void* w, const void* bias,
    const void* aff_a, const void* aff_c, const void* skip, void* out,
    const void* tile_ids, const void* n_active, int X, int Z, int Y, int C,
    int flip, int relu_in, int relu_out, int n_tiles, void* stream) {
  if (n_tiles == 0) return 0;
  const Params p{(const __nv_bfloat16*)x, (const uint8_t*)mask, (const __nv_bfloat16*)w,
                 (const float*)bias, (const float*)aff_a, (const float*)aff_c,
                 (const __nv_bfloat16*)skip, (__nv_bfloat16*)out, (const int*)tile_ids,
                 (const int*)n_active, X, Z, Y, n_tiles, relu_in, relu_out};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 64: return flip ? launch<64, true>(p, st) : launch<64, false>(p, st);
    case 128: return flip ? launch<128, true>(p, st) : launch<128, false>(p, st);
    case 256: return flip ? launch<256, true>(p, st) : launch<256, false>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
