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
// What bounds it on an H100: at dec_s1 near dense it reads the parent
// (127 MB) and the skip at the union (~500 MB) and writes the whole output
// (507 MB): ~1.14 GB, 0.34 ms at 3.35 TB/s, against ~97 GFLOP (0.1 ms of
// bf16 tensor-core time).  It is bound by bytes, so the products and the
// elementwise math have to hide under the streaming of skip and out.  The
// design:
//   * Only (Ci, Co) in {(128, 64), (256, 128), (256, 256)} (dec_s1, s2, s4);
//     the host entry refuses others.
//   * Persistent CTAs walk the device-built list of 64-parent tiles (active
//     first, their count on the device); a warpgroup owns a tile (one m64
//     block) and all Co.  Inactive tiles are written as zeros, so the output
//     needs no memset.  A batch of B scans (the batched forward) is one list
//     over all of them: tile id `id` is tile id % n of scan b = id / n (n
//     tiles a scan), whose volumes start b times a scan's cells in and
//     whose coordinates come from its own box corner box_min[b].
//   * Weights in shared memory as [64 x N] slabs (N = min(Co, 128)),
//     128-byte swizzled.  dec_s1: all of wd and wr stay resident for the
//     CTA's life (136 KB) and its three warpgroups walk their own tiles
//     with no CTA-wide barrier.  dec_s2/s4: the slabs stream through a
//     cp.async ring STAGES - 2 slabs ahead of the products, and the CTA's
//     warpgroups (two at dec_s2, one at s4) share a unit of tiles.
//   * Per tile: the index math once per parent (32 bits), the child and
//     union masks read once, the coordinate values computed once, and the
//     masked parent rows staged once by cp.async (zero-filled at
//     ~parent_keep).
//   * Per child offset k: the deconv product (A by ldmatrix from the parent
//     rows, B = wd[k] slabs by descriptor, wgmma, the bias as the
//     accumulator's start), then bf16, up_bn, leaky, bf16 and resize_bn on
//     the f32 accumulators in registers, packed straight into the bf16 A
//     fragments of the resize product (the m64nN accumulator layout is the
//     k16 A-fragment layout): d never touches shared memory.
//   * The coordinate channels are one more k16 product of the resize with
//     A = the three bf16 coordinate values (K columns 0-2, built in
//     registers) and B = wr's coordinate rows padded to 16: the same
//     products as Co + 3 channels, without padding the K = Co slabs.
//   * The skip rows of the next child are staged by cp.async (zero-filled
//     outside the union) while this child's products run; the epilogue adds
//     child * bf16(r) to them in place (one bf16x2 add: the sum of two bf16
//     values is exact in f32) and the rows leave as 16-byte stores, whole
//     128-byte lines per cell.
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): 0.61 ms at dec_s1
// near dense, 56% of the bound, but slower than one F.conv_transpose3d of
// the deconv alone (0.54 ms); the stores, the products and the elementwise
// math each take 13-19% of it (scripts_torch/updown_ablation.py).  At
// dec_s2/s4 the ring's per-slab barrier and cp.async latency dominate
// (2-4x the library call).
#include "common.cuh"

// UPDOWN_ABLATE (0 in the model's build) removes one part of the kernel for
// a timing experiment: 1 the weight-slab loads, 2 the wgmma products, 3
// the output stores, 4 (up_preamble only) the elementwise math of both
// epilogues; the results of such a build are wrong.  5 runs dec_s1 on the
// weight ring of dec_s2/s4 in place of its resident weights (right
// results, to time the resident path against it).
#ifndef UPDOWN_ABLATE
#define UPDOWN_ABLATE 0
#endif

using namespace pasco;

namespace {

constexpr int ABLATE = UPDOWN_ABLATE;

constexpr int TP = 64;   // parents per tile: one m64 block, one warpgroup

template <int CI, int CO> struct Geom {
  // dec_s1: every slab resident (8 ND deconv + NR resize), and the
  // warpgroups walk their own tiles; else a ring, in lockstep
  static constexpr bool RESIDENT = CI == 128 && CO == 64 && ABLATE != 5;
  static constexpr int WGS = RESIDENT ? 3 : CO == 256 ? 1 : 2;   // warpgroups per CTA
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NS = CO < 128 ? CO : 128;       // slab columns
  static constexpr int NH = CO / NS;                   // column halves
  static constexpr int ND = (CI / 64) * NH;            // deconv slabs per child
  static constexpr int NR = NH * (CO / 64);            // resize slabs per child
  static constexpr int NJ = ND + NR;
  static constexpr int SLAB = 64 * NS * 2;
  static constexpr int IOB = RESIDENT ? 1 : 2;         // io buffers per warpgroup
  static constexpr int STAGES = RESIDENT ? 8 * ND + NR : (CO == 128 ? 5 : 6);
  static constexpr int PAR = TP * CI * 2;              // a warpgroup's parent rows
  static constexpr int IO = TP * CO * 2;               // a warpgroup's output rows
  static constexpr int CW = CO * 32;                   // the coordinate slab: [CO/64][16][128 B]
  static constexpr int BYTES = STAGES * SLAB + CW + WGS * (PAR + IOB * IO + TP * 32) +
                               (6 * CO + 10) * 4 + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB of shared memory a block can use");
};

struct Params {
  const __nv_bfloat16* parent;
  const uint8_t* keep;
  const uint8_t* child;
  const uint8_t* uni;
  const __nv_bfloat16* skip;
  const __nv_bfloat16* wd;   // [8, Ci, Co]
  const float* bd;
  const float* a1;
  const float* c1;
  const float* a2;           // [Co + 3]
  const float* c2;           // [Co + 3]
  const __nv_bfloat16* wr;   // [Co + 3, Co]
  const float* br;
  const int* box_min;
  __nv_bfloat16* out;
  const int* tile_ids;
  const int* n_active;
  int B, X2, Z2, Y2, scale, n_tiles;
};

template <int CI, int CO>
__global__ void __launch_bounds__(Geom<CI, CO>::THREADS, 1) up_preamble_kernel(const Params p) {
  using G = Geom<CI, CO>;
  constexpr int WGS = G::WGS, THREADS = G::THREADS, IOB = G::IOB;
  constexpr int NS = G::NS, NH = G::NH, ND = G::ND, NJ = G::NJ, SLAB = G::SLAB;
  constexpr int STAGES = G::STAGES, STEPS = 8 * NJ;
  constexpr bool RESIDENT = G::RESIDENT;
  constexpr int D = STAGES - 2;   // ring: slabs loaded ahead of the products
  constexpr int NKR = CO / 64;    // resize K slabs per column half
  constexpr int CH = CO / 8;      // 16-byte chunks of an output row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  // Per warpgroup: parent rows, IOB io buffers, row info.
  unsigned char* cw = smem + STAGES * SLAB;           // wr's coordinate rows, zero-padded
  unsigned char* par = cw + G::CW + wg * (G::PAR + IOB * G::IO);
  unsigned char* io = par + G::PAR;                   // [IOB][64 rows x CO], swizzled
  int* s_g0 = reinterpret_cast<int*>(cw + G::CW + WGS * (G::PAR + IOB * G::IO)) +
              wg * TP * 8;                            // child (0,0,0) cell or -1
  int* s_bits = s_g0 + TP;       // child mask bits 0-7, union bits 8-15
  float* s_cA = reinterpret_cast<float*>(s_bits + TP);   // [TP][3 axes][2 offsets]
  float* s_bd = reinterpret_cast<float*>(cw + G::CW + WGS * (G::PAR + IOB * G::IO + TP * 32));
  float* s_a1 = s_bd + CO;
  float* s_c1 = s_a1 + CO;
  float* s_a2 = s_c1 + CO;
  float* s_c2 = s_a2 + CO;
  float* s_br = s_c2 + CO;
  float* s_ca = s_br + CO;           // a2, c2 of the coordinate channels
  const uint32_t slabs = smem_u32(smem), cw_s = smem_u32(cw);
  const uint32_t par_s = smem_u32(par), io_s = smem_u32(io);

  for (int i = tid; i < CO; i += THREADS) {
    s_bd[i] = p.bd[i];
    s_a1[i] = p.a1[i];
    s_c1[i] = p.c1[i];
    s_a2[i] = p.a2[i];
    s_c2[i] = p.c2[i];
    s_br[i] = p.br[i];
  }
  // The coordinate slab: a K = 16 B operand (N-major, 64-column atoms of
  // 16 rows x 128 B, 2 KB apart) whose rows 0-2 are wr[Co .. Co + 2].
  for (int v = tid; v < 16 * CO / 8; v += THREADS) {
    const int k = v / (CO / 8), c = v % (CO / 8);
    uint4 w = make_uint4(0, 0, 0, 0);
    if (k < 3) w = *reinterpret_cast<const uint4*>(p.wr + (CO + k) * CO + c * 8);
    *reinterpret_cast<uint4*>(cw + (c >> 3) * 2048 + swz(k, c)) = w;
  }
  fence_async_smem();
  if (tid < 3) {
    s_ca[tid] = p.a2[CO + tid];
    s_ca[3 + tid] = p.c2[CO + tid];
  }

  const int X2 = p.X2, Z2 = p.Z2, Y2 = p.Y2, Z = 2 * Z2, Y = 2 * Y2;
  const int n_par = X2 * Z2 * Y2;               // parents of one scan
  const int per_scan = p.n_tiles / p.B;         // tiles of one scan
  const int n_active = *p.n_active;
  auto child_off = [&](int k) { return (k >> 2) * Z * Y + (k & 1) * Y + ((k >> 1) & 1); };

  // Slab j of child k: deconv slabs (kc, h) = wd[k][kc*64 .., h*NS ..], then
  // resize slabs (h, kc) = wr[kc*64 .., h*NS ..].
  auto load_slab = [&](uint32_t dst, int k, int j) {
    const __nv_bfloat16* src;
    if (j < ND) src = p.wd + ((long long)k * CI + (j / NH) * 64) * CO + (j % NH) * NS;
    else src = p.wr + ((j - ND) % NKR) * 64 * CO + ((j - ND) / NKR) * NS;
    cp_slab_nmajor<NS>(dst, src, CO, tid, THREADS);
  };
  if constexpr (RESIDENT) {
    for (int k = 0; k < 8; ++k)
      for (int j = 0; j < ND; ++j) load_slab(slabs + (k * ND + j) * SLAB, k, j);
    for (int j = ND; j < NJ; ++j) load_slab(slabs + (8 * ND + j - ND) * SLAB, 0, j);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
  }
  __syncthreads();   // the vectors (and the resident slabs)

  // The slab of step s = k * NJ + j.  Ring: waits for it, frees the slot of
  // step s - 2 (its products are done) and loads step s + D there.
  auto step = [&](int s) -> uint32_t {
    const int k = s / NJ, j = s % NJ;
    if constexpr (RESIDENT) {
      return slabs + (j < ND ? k * ND + j : 8 * ND + j - ND) * SLAB;
    } else {
      wgmma_wait<1>();
      cp_async_wait<D - 1>();
      fence_async_smem();
      __syncthreads();
      if (ABLATE != 1 && s + D < STEPS)
        load_slab(slabs + ((s + D) % STAGES) * SLAB, (s + D) / NJ, (s + D) % NJ);
      cp_async_commit();
      return slabs + (s % STAGES) * SLAB;
    }
  };
  // A barrier over the threads that share a tile: the warpgroup where the
  // warpgroups walk their own tiles, else the CTA.
  auto tile_sync = [&]() {
    if constexpr (RESIDENT) named_barrier(1 + wg, 128);
    else __syncthreads();
  };

  const int arow = wq * 16 + (lane & 15), hi = lane >> 4;
  const int g = lane >> 2, t = lane & 3;
  // Byte offset of 16-byte chunk c of io row `row` (swizzled per 128 B).
  auto io_off = [](int row, int c) {
    return row * (CO * 2) + ((c >> 3) << 7) + (((c ^ row) & 7) << 4);
  };
  // The warpgroup's skip rows of child k into io buffer k % IOB, zero-filled
  // outside the union (one commit group, possibly empty).
  auto stage_skip = [&](int k) {
    if (k < 8) {
      const int off = child_off(k);
      for (int v = wtid; v < TP * CH; v += 128) {
        const int row = v / CH, c = v % CH;
        const bool ok = (s_bits[row] >> (8 + k)) & 1;
        cp_async16(io_s + (k % IOB) * G::IO + io_off(row, c),
                   ok ? p.skip + (long long)(s_g0[row] + off) * CO + c * 8 : p.skip,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float dacc[NH][NS / 2];
  float racc[NS / 2];
  uint32_t fr[CO / 16][4];
  uint32_t a[2][4][4];   // parent A fragments, double-buffered by 64-channel chunk

  // Work unit u: tile u * WGS + wg of the list for warpgroup wg.  Resident:
  // each warpgroup walks its own units.  Ring: the CTA's warpgroups share a
  // unit and its weight slabs; a tile past the active ones (or the list)
  // runs with empty masks, which writes its zeros (or nothing).
  const int u0 = RESIDENT ? blockIdx.x * WGS + wg : blockIdx.x;
  const int du = RESIDENT ? gridDim.x * WGS : gridDim.x;
  const int n_units = RESIDENT ? p.n_tiles : (p.n_tiles + WGS - 1) / WGS;
  for (int u = u0; u < n_units; u += du) {
    const int tile = RESIDENT ? u : u * WGS + wg;
    const bool present = tile < p.n_tiles, active = tile < n_active;
    const int id = present ? p.tile_ids[tile] : 0;
    const int b = id / per_scan;                 // the tile's scan
    const int p0 = present ? (id % per_scan) * TP : n_par;   // its first parent in the scan
    const int pb = b * n_par;   // the scan's first parent; its first child cell is 8 * pb
    tile_sync();   // the last tile's readers of the row info, parents and io are done
    // Per parent: its child (0,0,0) cell, child and union bits, and the
    // resize A values of its children's coordinate channels (axis j, child
    // offset o along it): bf16(a2 * bf16((min + scale * cell) / scale) + c2),
    // min the scan's box corner.  g0 counts the cells of the scans before.
    if (wtid < TP) {
      const int q = p0 + wtid;
      int g0 = -1, bits = 0;
      if (q < n_par) {
        const int py = q % Y2, r = q / Y2, pz = r % Z2, px = r / Z2;
        g0 = 8 * pb + (2 * px * Z + 2 * pz) * Y + 2 * py;
        if (active) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int c = g0 + child_off(k);
            bits |= (p.child[c] != 0) << k | (p.uni[c] != 0) << (8 + k);
          }
          const int pc[3] = {px, py, pz};
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const float u = rbf(((float)p.box_min[3 * b + j] +
                                   (float)(p.scale * (2 * pc[j] + o))) / (float)p.scale);
              s_cA[wtid * 6 + j * 2 + o] = rbf(s_ca[j] * u + s_ca[3 + j]);
            }
        }
      }
      s_g0[wtid] = g0;
      s_bits[wtid] = bits;
    }
    tile_sync();

    if (RESIDENT ? !active : u * WGS >= n_active) {   // no child in the union: zeros
      for (int v = wtid; v < TP * 8 * CH; v += 128) {
        const int c = v % CH, k = (v / CH) % 8, g0 = s_g0[v / (8 * CH)];
        if (ABLATE != 3 && g0 >= 0)
          *reinterpret_cast<uint4*>(p.out + (long long)(g0 + child_off(k)) * CO + c * 8) =
              make_uint4(0, 0, 0, 0);
      }
      continue;
    }

    // The masked parent rows: [Ci / 64 chunks][64 rows][128 B].
    for (int v = wtid; v < TP * (CI / 8); v += 128) {
      const int R = v / (CI / 8), c = v % (CI / 8), q = p0 + R;
      const bool ok = q < n_par && p.keep[pb + q];
      cp_async16(par_s + (c >> 3) * 8192 + swz(R, c),
                 ok ? p.parent + (long long)(pb + q) * CI + c * 8 : p.parent, ok ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < IOB; ++k) stage_skip(k);
    if constexpr (RESIDENT) {
      cp_async_wait<IOB>();   // the parents
      tile_sync();
    } else {
#pragma unroll
      for (int s = 0; s < D; ++s) {
        load_slab(slabs + s * SLAB, s / NJ, s % NJ);
        cp_async_commit();
      }
    }

#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int ix = k >> 2, iy = (k >> 1) & 1, iz = k & 1;
      const int off = child_off(k);

      // --- deconv: dacc = parent rows @ wd[k] ---------------------------
#pragma unroll
      for (int h = 0; h < NH; ++h)   // the bias is the accumulator's start
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const float2 vb = *reinterpret_cast<const float2*>(s_bd + h * NS + 8 * j + 2 * t);
          dacc[h][4 * j] = dacc[h][4 * j + 2] = vb.x;
          dacc[h][4 * j + 1] = dacc[h][4 * j + 3] = vb.y;
        }
#pragma unroll
      for (int kc = 0; kc < CI / 64; ++kc)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint32_t b = step(k * NJ + kc * NH + h);
          if (h == 0) {
            if constexpr (RESIDENT) wgmma_wait<1>();   // chunk kc - 2's products are done
#pragma unroll
            for (int ph = 0; ph < 4; ++ph)
              ldmatrix_x4(a[kc & 1][ph], par_s + kc * 8192 + swz(arow, ph * 2 + hi));
          }
          wgmma_fence();
#pragma unroll
          for (int ph = 0; ph < 4; ++ph)
            if constexpr (ABLATE != 2)
              wgmma<NS, 1>(dacc[h], a[kc & 1][ph], smem_desc(b + ph * 2048, 8192, 1024));
          wgmma_commit();
        }
      wgmma_wait<0>();
      // bf16, up_bn, leaky, bf16, resize_bn -> the resize's A fragments
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        acc_fence(dacc[h]);
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int col = h * NS + 8 * j + 2 * t;
          const float2 v1 = *reinterpret_cast<const float2*>(s_a1 + col);
          const float2 w1 = *reinterpret_cast<const float2*>(s_c1 + col);
          const float2 v2 = *reinterpret_cast<const float2*>(s_a2 + col);
          const float2 w2 = *reinterpret_cast<const float2*>(s_c2 + col);
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; i += 2) {
            if constexpr (ABLATE == 4) continue;
            float2 u = rbf2(dacc[h][i], dacc[h][i + 1]);
            u = rbf2(leaky(v1.x * u.x + w1.x), leaky(v1.y * u.y + w1.y));
            dacc[h][i] = v2.x * u.x + w2.x;
            dacc[h][i + 1] = v2.y * u.y + w2.y;
          }
        }
#pragma unroll
        for (int q = 0; q < NS / 16; ++q) pack_a(fr[h * (NS / 16) + q], dacc[h], q);
      }

      // Per row (g + 8 hh of the warp's 16): a generated child in the union
      // (its skip is zero-filled outside the union), and the A fragment of
      // the coordinate product: K columns 0-2 = the coordinate channels.
      bool gen[2];
      uint32_t ac[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wq * 16 + g + 8 * hh;
        const int bits = s_bits[row];
        gen[hh] = (bits >> k) & (bits >> (8 + k)) & 1;
        const float* cA = s_cA + row * 6;
        __nv_bfloat162 v = __floats2bfloat162_rn(t == 0 ? cA[ix] : cA[4 + iz],
                                                 t == 0 ? cA[2 + iy] : 0.f);
        if (t < 2) ac[hh] = *reinterpret_cast<uint32_t*>(&v);
      }

      unsigned char* io_k = io + (k % IOB) * G::IO;
      // --- resize: r = [d, coords] @ wr, by column half ------------------
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {   // the bias is the accumulator's start
          const float2 rb = *reinterpret_cast<const float2*>(s_br + h * NS + 8 * j + 2 * t);
          racc[4 * j] = racc[4 * j + 2] = rb.x;
          racc[4 * j + 1] = racc[4 * j + 3] = rb.y;
        }
#pragma unroll
        for (int kc = 0; kc < NKR; ++kc) {
          const uint32_t b = step(k * NJ + ND + h * NKR + kc);
          wgmma_fence();
          if (kc == 0 && ABLATE != 2)   // the coordinate channels
            wgmma<NS, 1>(racc, ac, smem_desc(cw_s + h * (NS / 64) * 2048, 2048, 1024));
#pragma unroll
          for (int ph = 0; ph < 4; ++ph)
            if constexpr (ABLATE != 2)
              wgmma<NS, 1>(racc, fr[kc * 4 + ph], smem_desc(b + ph * 2048, 8192, 1024));
          wgmma_commit();
        }
        wgmma_wait<0>();
        acc_fence(racc);
        if (h == 0) {   // this child's skip rows have landed
          if constexpr (RESIDENT) cp_async_wait<IOB - 1>();
          else cp_async_wait<D - 1>();
          named_barrier(1 + wg, 128);
        }
        // out = union * (child * bf16(r) + skip), in place of the skip
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int c = (h * NS) / 8 + j;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = wq * 16 + g + 8 * hh;
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(io_k + io_off(row, c) + 4 * t);
            float2 r = rbf2(racc[4 * j + 2 * hh], racc[4 * j + 2 * hh + 1]);
            if (ABLATE != 4 && !gen[hh]) r = make_float2(0.f, 0.f);
            // the sum of two bf16 values is exact in f32: one rounding
            *o = __hadd2(*o, __floats2bfloat162_rn(r.x, r.y));
          }
        }
      }
      named_barrier(1 + wg, 128);   // the warpgroup's io rows are written
      for (int v = wtid; v < TP * CH; v += 128) {
        const int row = v / CH, c = v % CH, g0 = s_g0[row];
        if (ABLATE != 3 && g0 >= 0)
          *reinterpret_cast<uint4*>(p.out + (long long)(g0 + off) * CO + c * 8) =
              *reinterpret_cast<const uint4*>(io_k + io_off(row, c));
      }
      named_barrier(1 + wg, 128);   // io buffer k % IOB is read out: the skip of k + IOB
      stage_skip(k + IOB);
    }
  }
  cp_async_wait<0>();
}

// Launch configuration, found once per kernel and device.
template <int CI, int CO>
int launch(const Params& p, cudaStream_t stream) {
  using G = Geom<CI, CO>;
  auto kern = up_preamble_kernel<CI, CO>;
  static int grid_cap[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, G::THREADS, G::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap[dev] = sms * per_sm;
  }
  const int units = (p.n_tiles + G::WGS - 1) / G::WGS;
  const int grid = units < grid_cap[dev] ? units : grid_cap[dev];
  kern<<<grid, G::THREADS, G::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// (Ci, Co) in {(128, 64), (256, 128), (256, 256)}; tiles of 64 flat
// parents of each of the B scans (pasco_torch/ops/deconv.py:up_tiles);
// box_min [B, 3].
extern "C" int pasco_up_preamble(
    const void* parent, const void* parent_keep, const void* child_mask,
    const void* union_mask, const void* skip, const void* wd, const void* bd,
    const void* a1, const void* c1, const void* a2, const void* c2,
    const void* wr, const void* br, const void* box_min, void* out,
    const void* tile_ids, const void* n_active, int B, int X2, int Z2, int Y2, int Ci,
    int Co, int scale, int n_tiles, void* stream) {
  if (n_tiles == 0) return 0;
  if (B < 1 || n_tiles != B * ((X2 * Z2 * Y2 + TP - 1) / TP)) return (int)cudaErrorInvalidValue;
  const Params p{(const __nv_bfloat16*)parent, (const uint8_t*)parent_keep,
                 (const uint8_t*)child_mask, (const uint8_t*)union_mask,
                 (const __nv_bfloat16*)skip, (const __nv_bfloat16*)wd, (const float*)bd,
                 (const float*)a1, (const float*)c1, (const float*)a2, (const float*)c2,
                 (const __nv_bfloat16*)wr, (const float*)br, (const int*)box_min,
                 (__nv_bfloat16*)out, (const int*)tile_ids, (const int*)n_active,
                 B, X2, Z2, Y2, scale, n_tiles};
  cudaStream_t st = (cudaStream_t)stream;
  if (Ci == 128 && Co == 64) return launch<128, 64>(p, st);
  if (Ci == 256 && Co == 128) return launch<256, 128>(p, st);
  if (Ci == 256 && Co == 256) return launch<256, 256>(p, st);
  return (int)cudaErrorInvalidValue;
}
