// spc_dense3d: the dense completion bottleneck at stride 8 (SPCDense3D,
// pasco_torch/models/bottleneck.py) in four launches of one implicit-GEMM
// kernel, each conv's eval BatchNorm and ReLU and the branch sums in its
// epilogue.
//
// Replaces no TPU kernel: the reference runs these eleven anisotropic
// convs as XLA convolutions (pasco_tpu/models/bottleneck.py:zfold_conv3d,
// the z extent folded into channels), and the port ran them as F.conv3d.
// Volumes are [B, X, Z, Y, C] bf16 (the dense net's layout); a launch
// computes, for its group of convs g that read one input volume,
//   v_g = relu(a_g * conv_g(x) + c_g)     (BN folded to a per-channel affine)
//   sum = v_0 + v_1 + ... (f32, in that order)
// and stores any of: v_0 (bf16 and f32), bf16(sum), sum + addend (f32 or
// bf16).  The four launches (pasco_torch/ops/spc_dense3d.py):
//   1. x  -> a1, r1, r2, r3: x1 (bf16, f32) and P = x1 + y1 + y2 + y3
//   2. x1 -> a2, a3, a4:     t = x2 + x3 + x4 (bf16), S = x1 + t (f32)
//   3. t  -> a5, a6, a7:     s = S + x5 + x6 + x7 (bf16)
//   4. s  -> ch1 (1x1):      out = y0 + P (f32)
// The conv sums go into the affine in f32, never rounded to bf16 first.
//
// What bounds it on an H100: 256 -> 256 channels over 997 taps on a 44 x
// 44 x 4 grid is 2 * 7744 * 997 * 256^2 = 1.01 TFLOP at the 352 box; the
// taps that reach only the z padding add exact zeros and are skipped, which
// leaves ~0.70 TFLOP: ~0.7 ms at the 989 TFLOP/s bf16 tensor-core rate.
// The weights (131 MB in bf16 a forward) take 0.04 ms at HBM rate, and an
// activation volume 4 MB, so the bound is operations.  The design:
//   * A tile is 128 cells of one output z plane, consecutive in the
//     plane's (x, y) raster order (~61 tiles at B = 1 and the 352 box), and
//     N output channels (N = 128 where C % 128 == 0, else 64): one CTA of
//     two consumer warpgroups (m64 each) per (tile, channel block), about
//     one wave on 132 SMs at B = 1.  Raster tiles waste at most one partial
//     tile a plane (4% at 44 x 44), where 8 x 16 boxes waste 19%.
//   * Because a tile is one z plane, a z tap either reaches the plane's
//     input plane for the whole tile or only padding: the taps of each conv
//     are walked as (dz, 64-channel chunk, (dx, dy)), and a dz outside the
//     volume is never walked (30% of a (7,7,5) conv's taps at Z = 4).
//   * Per (conv, dz, chunk) the tile's halo (its x lines +- rx, all y +- ry;
//     at most 11 x 50 cells of 128 bytes) is staged once into shared memory
//     by cp.async with zero fill outside the box, its 16-byte chunks XOR-
//     swizzled by (cell % 8); every (dx, dy) tap is then a constant row shift
//     that the A operand's ldmatrix reads from it (each lane its own row,
//     so raster tiles need no gather).
//   * Weights are the big operand (one (7,7,5) conv is 32 MB): [64 x N] bf16
//     slabs per (tap, chunk) stream through a ring of STAGES slots by
//     cp.async, STAGES - 3 slabs ahead of the wgmmas that read them
//     (wgmma.m64nNk16, B by descriptor, 128-byte swizzle), with one block
//     barrier every other tap.  Every CTA of a launch walks the same taps of
//     the same conv in the same order from the same start, so a slab is read
//     from HBM about once and from L2 by the other CTAs.
//   * The per-tap path does no integer division: a thread's slab chunks keep
//     their offsets, a cursor steps the prefetched slab's pointer, and the
//     A row moves by one halo cell a tap.  (Before, the address arithmetic
//     of each tap cost more than its products: 3.88 ms a call at 44 x 44.)
//   * Epilogue on the f32 accumulators: the conv's affine and ReLU, then
//     the branch sum, kept in an f32 scratch volume that each thread reads
//     back only where it wrote (a second register accumulator took all 255
//     registers), stores straight from the fragment layout.  A branch
//     reaches device memory only in the scratch or where a later launch
//     reads it.
// Measured on an H100 (PERF.md): 2.03 ms a call at the 352 box's 44 x 44 x
// 4 grid, 37% of the 0.758 ms bound, and the same at 36 x 36 x 4: a CTA's
// (tile, channel block) at an inner z plane sets the time, ~850 taps.
// Without its products, a barrier every tap, the kernel took 1.38 of its
// 2.29 ms: the barriers, the slab copies and the halo staging, which does
// not overlap the products of its own CTA, are what to remove next.
#include "common.cuh"

using namespace pasco;

namespace {


constexpr int THREADS = 256;          // two consumer warpgroups
constexpr int TM = 128;               // output cells of a tile (64 a warpgroup)
constexpr int KC = 64;                // input channels per halo chunk / slab rows
constexpr int CELL_BYTES = KC * 2;    // one halo cell: 128 bytes
constexpr int NPH = KC / 16;          // k16 steps (wgmma groups) per slab
constexpr int MAXG = 4;               // convs per launch
constexpr int SMEM_MAX = 232448;      // shared memory a block can use

template <int N> struct Cfg;
template <> struct Cfg<64> { static constexpr int STAGES = 8; };
template <> struct Cfg<128> { static constexpr int STAGES = 8; };

struct Params {
  const __nv_bfloat16* x;             // [B, X, Z, Y, C] input of every conv
  const __nv_bfloat16* w[MAXG];       // [kx * ky * kz, C, C] each
  int kx[MAXG], ky[MAXG], kz[MAXG];
  const float* aff;                   // [G, 2, C]: a, then c, per conv
  __nv_bfloat16* first_b;             // bf16(v_0), or null
  float* first_f;                     // v_0, or null
  const float* addend;                // f32 [B, X, Z, Y, C], or null
  __nv_bfloat16* sum_b;               // bf16(sum), or null
  float* res_f;                       // sum + addend, or null (may be addend)
  __nv_bfloat16* res_b;               // bf16(sum + addend), or null
  float* scr;                         // f32 [B, X, Z, Y, C]: the running sum (G > 1)
  int G, B, X, Z, Y, C;
  int tpp;                            // tiles a plane: ceil(X * Y / TM)
  int rxm, rym, hw, halo_cells;       // halo: radii of the launch, width, cells
  int n_items;                        // B * Z * tpp * (C / N)
};

template <int N>
__global__ void __launch_bounds__(THREADS, 1) spc_dense3d_kernel(const Params p) {
  constexpr int STAGES = Cfg<N>::STAGES;
  constexpr int D = STAGES - 3;       // slabs in flight ahead of the wgmmas
  constexpr int SLAB = KC * N * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_s = smem_u32(smem);
  unsigned char* halo = smem + STAGES * SLAB;
  const uint32_t halo_s = smem_u32(halo);
  float* s_aff = reinterpret_cast<float*>(halo + p.halo_cells * CELL_BYTES);
  // Per conv: kernel extents, weights, and this item's z walk.
  __shared__ int s_kx[MAXG], s_ky[MAXG], s_kz[MAXG];
  __shared__ int s_dz0[MAXG], s_ndz[MAXG], s_steps[MAXG];
  __shared__ const __nv_bfloat16* s_w[MAXG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int G = p.G, C = p.C, X = p.X, Z = p.Z, Y = p.Y, XY = X * Y;
  const int nkc = C / KC, split = C / N;
  for (int i = tid; i < G * 2 * C; i += THREADS) s_aff[i] = p.aff[i];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (tid == g && g < G) {
      s_kx[g] = p.kx[g];
      s_ky[g] = p.ky[g];
      s_kz[g] = p.kz[g];
      s_w[g] = p.w[g];
    }

  // Weight slab of 64 K rows (input channels) x N columns (output
  // channels) of one [C, C] tap matrix, stored N-major for wgmma with TB =
  // 1: 64-column atoms of 64 rows x 128 B, 8 KB apart, row k at k * 128,
  // 16-byte chunk c of the atom at (c ^ k % 8).  A thread copies the same
  // NSL chunks of every slab: their offsets are computed once.
  constexpr int NSL = KC * N / 8 / THREADS;
  uint32_t sl_dst[NSL];
  int sl_src[NSL];
#pragma unroll
  for (int i = 0; i < NSL; ++i) {
    const int v = tid + i * THREADS, k = v / (N / 8), c = v % (N / 8);
    sl_dst[i] = (c >> 3) * (KC * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4);
    sl_src[i] = k * C + c * 8;
  }
  auto load_slab = [&](uint32_t dst, const __nv_bfloat16* src) {
#pragma unroll
    for (int i = 0; i < NSL; ++i) cp_async16(dst + sl_dst[i], src + sl_src[i], 16);
  };

  // The prefetch cursor: the slab D steps ahead of the wgmmas.  Steps run
  // over the convs in order, each over (dz, chunk, (dx, dy)) with (dx, dy)
  // fastest; a slab is tap (ix * ky + iy) * kz + iz, rows kc * 64.., of
  // the conv's [taps, C, C] weight.
  int cg = 0, cdz = 0, ckc = 0, ctxy = 0, ctaps = 1, cndz = 1, ckz = 1;
  const __nv_bfloat16* cptr = p.w[0];
  auto cursor_at = [&](int n0) {   // (cg, cdz, ckc) set, ctxy = 0
    ctaps = s_kx[cg] * s_ky[cg];
    cndz = s_ndz[cg];
    ckz = s_kz[cg];
    const int iz = s_dz0[cg] + cdz + ckz / 2;
    cptr = s_w[cg] + ((long long)iz * C + ckc * KC) * C + n0;
  };
  auto advance = [&](int n0) {
    cptr += (long long)ckz * C * C;
    if (++ctxy < ctaps) return;
    ctxy = 0;
    if (++ckc == nkc) {
      ckc = 0;
      if (++cdz == cndz) {
        cdz = 0;
        if (++cg == G) return;
      }
    }
    cursor_at(n0);
  };

  float acc[N / 2];
  const int hi = lane >> 4;

  for (int it = blockIdx.x; it < p.n_items; it += gridDim.x) {
    const int tile = it / split, n0 = (it % split) * N;
    const int t = tile % p.tpp, z = (tile / p.tpp) % Z, b = tile / (p.tpp * Z);
    const int cell0 = t * TM;
    const int xf = cell0 / Y;                                   // first x line
    const int nl = ((cell0 + TM < XY ? cell0 + TM : XY) - 1) / Y - xf + 1;
    __syncthreads();   // the last item's readers of the halo, ring and walk are done
    if (tid < G) {
      const int rz = s_kz[tid] / 2;
      const int lo = -rz > -z ? -rz : -z, hi_dz = rz < Z - 1 - z ? rz : Z - 1 - z;
      s_dz0[tid] = lo;
      s_ndz[tid] = hi_dz - lo + 1;
      s_steps[tid] = (hi_dz - lo + 1) * nkc * s_kx[tid] * s_ky[tid];
    }
    __syncthreads();
    int total = 0;
    for (int g = 0; g < G; ++g) total += s_steps[g];

    cg = cdz = ckc = ctxy = 0;
    cursor_at(n0);
#pragma unroll
    for (int s = 0; s < D; ++s) {
      if (s < total) {
        load_slab(ring_s + s * SLAB, cptr);
        advance(n0);
      }
      cp_async_commit();
    }

    // Lane `lane` of warp wq addresses A row wg * 64 + wq * 16 + lane % 16
    // (its halo cell) at 8-channel chunk lane / 16 of each k16 step.  Rows
    // past the plane's last cell read that cell and are not stored.
    int hbase;
    {
      const int r = wg * 64 + wq * 16 + (lane & 15);
      const int c = cell0 + r < XY ? cell0 + r : XY - 1;
      hbase = (c / Y - xf + p.rxm) * p.hw + (c % Y + p.rym);
    }

    int s = 0;
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      const int kx = s_kx[g], ky = s_ky[g], rx = kx / 2, ry = ky / 2;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
      for (int dzi = 0; dzi < s_ndz[g]; ++dzi) {
        const int zi = z + s_dz0[g] + dzi;
#pragma unroll 1
        for (int kc = 0; kc < nkc; ++kc) {
          wgmma_wait<0>();
          __syncthreads();   // every warpgroup is done with the last halo
          // Stage lines xf - rx .. xf + nl - 1 + rx, columns -ry .. Y - 1 + ry
          // of input plane zi, chunk kc: zeros outside the box.
          {
            const int cols = Y + 2 * ry, n = (nl + 2 * rx) * cols * 8;
            const int l0 = p.rxm - rx, c0 = p.rym - ry;
            for (int v = tid; v < n; v += THREADS) {
              const int part = v & 7, q = v >> 3;
              const int li = q / cols, ci = q - li * cols;
              const int gx = xf - rx + li, gy = ci - ry;
              const int h = (l0 + li) * p.hw + c0 + ci;
              const bool ok = gx >= 0 && gx < X && gy >= 0 && gy < Y;
              const __nv_bfloat16* src =
                  ok ? p.x + ((((long long)b * X + gx) * Z + zi) * Y + gy) * C + kc * KC +
                           part * 8
                     : p.x;
              cp_async16(halo_s + h * CELL_BYTES + ((part ^ (h & 7)) << 4), src, ok ? 16 : 0);
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
          fence_async_smem();
          __syncthreads();

          // A fragments in two register sets, alternating by k16 step: the
          // ldmatrix of one step overlaps the wgmma of the one before, and a
          // tap's first fragment is loaded before the barrier of its step.
          uint32_t a[2][4];
          auto ld_a = [&](uint32_t (&r)[4], int cell, int ph) {
            ldmatrix_x4(r, halo_s + cell * CELL_BYTES + (((ph * 2 + hi) ^ (cell & 7)) << 4));
          };
          int cell = hbase - rx * p.hw - ry;
          ld_a(a[0], cell, 0);
          const int taps = kx * ky;
#pragma unroll 1
          for (int j = 0, iy = 0; j < taps; ++j, ++s) {
            // A block barrier every other tap (the first follows the halo's):
            // slabs s and s + 1 have landed, and every warp is done with step
            // s - 2, so the slots of s - 3 and s - 2 take the next slabs.
            if ((j & 1) == 0 && j > 0) {
              wgmma_wait<1>();
              cp_async_wait<D - 2>();
              fence_async_smem();
              __syncthreads();
            }
            if (s + D < total) {
              load_slab(ring_s + ((s + D) % STAGES) * SLAB, cptr);
              advance(n0);
            }
            cp_async_commit();
            const uint32_t slot = ring_s + (s % STAGES) * SLAB;
#pragma unroll
            for (int ph = 0; ph < NPH; ++ph) {
              const int buf = ph & 1;
              if (ph > 0) {
                wgmma_wait<1>();
                ld_a(a[buf], cell, ph);
              }
              wgmma_fence();
              wgmma<N, 1>(acc, a[buf], smem_desc(slot + ph * 2048, KC * 128, 1024));
              wgmma_commit();
            }
            if (++iy < ky) {
              ++cell;
            } else {
              iy = 0;
              cell += p.hw - (ky - 1);
            }
            if (j + 1 < taps) {
              wgmma_wait<1>();   // the tap's k16 step 2 (buffer 0) is done
              ld_a(a[0], cell, 0);
            }
          }
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);

      // Epilogue: d[4j + 2h + e] is row 16 wq + lane / 4 + 8h of the
      // warpgroup's m64 block, column 8j + 2 (lane % 4) + e.  The running
      // sum of the branches before the last lives in `scr`, each value read
      // back by the thread that wrote it.
      const float* sa = s_aff + g * 2 * C + n0;
      const float* sc = sa + C;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * (lane & 3) + (e & 1);
          acc[4 * j + e] = fmaxf(fmaf(sa[col], acc[4 * j + e], sc[col]), 0.f);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = cell0 + wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
        if (cc >= XY) continue;
        const long long o =
            ((((long long)b * X + cc / Y) * Z + z) * Y + cc % Y) * C + n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const long long oj = o + 8 * j;
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (g == 0) {
            if (p.first_f != nullptr) *reinterpret_cast<float2*>(p.first_f + oj) = v;
            if (p.first_b != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(p.first_b + oj) = __float22bfloat162_rn(v);
          } else {
            const float2 q = *reinterpret_cast<const float2*>(p.scr + oj);
            v.x = q.x + v.x;
            v.y = q.y + v.y;
          }
          if (g < G - 1) {
            *reinterpret_cast<float2*>(p.scr + oj) = v;
            continue;
          }
          if (p.sum_b != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(p.sum_b + oj) = __float22bfloat162_rn(v);
          if (p.addend != nullptr) {
            const float2 q = *reinterpret_cast<const float2*>(p.addend + oj);
            v.x += q.x;
            v.y += q.y;
          }
          if (p.res_f != nullptr) *reinterpret_cast<float2*>(p.res_f + oj) = v;
          if (p.res_b != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(p.res_b + oj) = __float22bfloat162_rn(v);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int N>
int launch(Params p, cudaStream_t stream) {
  auto kern = spc_dense3d_kernel<N>;
  p.n_items = p.B * p.Z * p.tpp * (p.C / N);
  const int bytes =
      Cfg<N>::STAGES * KC * N * 2 + p.halo_cells * CELL_BYTES + p.G * 2 * p.C * 4 + 1024;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.n_items < sms ? p.n_items : sms;
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes of a launch at these shapes (0: not launchable), for
// the wrapper's check before it allocates anything.  rxm, rym: the largest
// x and y radius of the launch's convs.
extern "C" int pasco_spc_dense3d_smem(int X, int Y, int C, int G, int rxm, int rym) {
  if (X < 1 || Y < 1 || C < KC || C > 256 || C % KC != 0 || G < 1 || G > MAXG) return 0;
  const int XY = X * Y, tpp = (XY + TM - 1) / TM;
  int nl = 0;
  for (int t = 0; t < tpp; ++t) {
    const int c0 = t * TM, c1 = (c0 + TM < XY ? c0 + TM : XY) - 1;
    nl = c1 / Y - c0 / Y + 1 > nl ? c1 / Y - c0 / Y + 1 : nl;
  }
  const long long cells = (long long)(nl + 2 * rxm) * (Y + 2 * rym);
  const int n = C % 128 == 0 ? 128 : 64, stages = n == 128 ? Cfg<128>::STAGES : Cfg<64>::STAGES;
  const long long bytes = (long long)stages * KC * n * 2 + cells * CELL_BYTES + G * 2 * C * 4 + 1024;
  return bytes > SMEM_MAX ? 0 : (int)bytes;
}

// One launch over G (1..4) convs of kernel extents (kx, ky, kz) (odd) on
// x [B, X, Z, Y, C] bf16, C a multiple of 64 up to 256; see the top of
// this file for the outputs (each null or [B, X, Z, Y, C]); scr, an f32
// scratch volume of x's cells (G > 1), holds the running sum.
extern "C" int pasco_spc_dense3d(
    const void* x, const void* w0, const void* w1, const void* w2, const void* w3,
    const void* aff, void* first_b, void* first_f, const void* addend, void* sum_b,
    void* res_f, void* res_b, void* scr, int G, int kx0, int ky0, int kz0, int kx1, int ky1, int kz1,
    int kx2, int ky2, int kz2, int kx3, int ky3, int kz3, int B, int X, int Z, int Y, int C,
    void* stream) {
  Params p{};
  p.x = (const __nv_bfloat16*)x;
  const void* ws[MAXG] = {w0, w1, w2, w3};
  const int ks[MAXG][3] = {{kx0, ky0, kz0}, {kx1, ky1, kz1}, {kx2, ky2, kz2}, {kx3, ky3, kz3}};
  if (G < 1 || G > MAXG || B < 1 || Z < 1 || (G > 1 && scr == nullptr))
    return (int)cudaErrorInvalidValue;
  int rxm = 0, rym = 0;
  for (int g = 0; g < G; ++g) {
    if (ws[g] == nullptr || ks[g][0] < 1 || ks[g][1] < 1 || ks[g][2] < 1 ||
        !(ks[g][0] & ks[g][1] & ks[g][2] & 1))
      return (int)cudaErrorInvalidValue;
    p.w[g] = (const __nv_bfloat16*)ws[g];
    p.kx[g] = ks[g][0];
    p.ky[g] = ks[g][1];
    p.kz[g] = ks[g][2];
    rxm = ks[g][0] / 2 > rxm ? ks[g][0] / 2 : rxm;
    rym = ks[g][1] / 2 > rym ? ks[g][1] / 2 : rym;
  }
  const int bytes = pasco_spc_dense3d_smem(X, Y, C, G, rxm, rym);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  p.aff = (const float*)aff;
  p.first_b = (__nv_bfloat16*)first_b;
  p.first_f = (float*)first_f;
  p.addend = (const float*)addend;
  p.sum_b = (__nv_bfloat16*)sum_b;
  p.res_f = (float*)res_f;
  p.res_b = (__nv_bfloat16*)res_b;
  p.scr = (float*)scr;
  p.G = G;
  p.B = B;
  p.X = X;
  p.Z = Z;
  p.Y = Y;
  p.C = C;
  p.tpp = (X * Y + TM - 1) / TM;
  p.rxm = rxm;
  p.rym = rym;
  p.hw = Y + 2 * rym;
  const int n = C % 128 == 0 ? 128 : 64;
  const int stages = n == 128 ? Cfg<128>::STAGES : Cfg<64>::STAGES;
  p.halo_cells = (bytes - 1024 - G * 2 * C * 4 - stages * KC * n * 2) / CELL_BYTES;
  cudaStream_t st = (cudaStream_t)stream;
  return n == 128 ? launch<128>(p, st) : launch<64>(p, st);
}
