// down2_fused: the encoder's stride-2 down step with both BN affines fused.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_down.py:down_padded_to_padded
// (_down_kernel, _down_call).  On the port's [X, Z, Y, C] bf16 layout:
//   out[p] = mask_out[p] * relu(a2 * leaky(a1 * (sum_k (x * mask_in)[2p + o_k]
//            @ w[k] + b) + c1) + c2),   o_k = kernel_offsets(2)
// with mask_out = maxpool2_mask(mask_in); out is exact zero elsewhere.
//
// What bounds it on an H100: the main path runs it on the scan's occupancy,
// where few output cells are valid (3.7% at enc_s2: 18178 of 495616).  The
// products at the valid cells are small (~2.4 GFLOP at enc_s2) and the
// input is read only at valid children (~9 MB), so the bound is the dense
// output it must write, zeros included: 127 MB at enc_s2, ~0.04 ms.  The
// design:
//   * Only (Ci, Co) in {(64, 128), (128, 256), (256, 256)} (the model's
//     widths); the host entry refuses others.
//   * The products run on a compacted list of the valid output cells (built
//     on the device by the wrapper; its count stays on the device), 64 cells
//     per work item: no product on an invalid row.
//   * One warpgroup per CTA (two CTAs per SM) owns 64 cells and 128 output
//     channels of an item (two items per 64 cells at Co = 256, so that the
//     accumulators stay at 64 registers and enc_s4/s8 have twice the items).
//     Each cell's 8 input children are found once per item (index math in
//     32 bits, the mask read once per (cell, child)).
//   * A ring of 4 (A, B) stages, filled by cp.async two steps ahead of the
//     products: per step (child k, 64-channel chunk) the 64 gathered child
//     rows (zero-filled at masked children) and the [64 x 128] weight slab,
//     128-byte swizzled.  A from registers (ldmatrix, two register sets), B
//     by descriptor: wgmma.m64n128k16; one step's products run while the
//     next step's fragments load.
//   * Epilogue on the f32 accumulators: bias, both affines, leaky, relu,
//     bf16x2 stores straight from the fragment layout.
//   * Persistent CTAs walk the product items first, then items of 128 flat
//     output cells in which they write zeros at the invalid cells (the mask
//     read once into shared memory, 16-byte stores), so the output needs no
//     memset and every cell is written once.
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): 0.073 ms at enc_s2,
// 57% of the bound, and faster than one stride-2 F.conv3d at enc_s2/s4; at
// enc_s8 its 38 items of 32 steps each leave most SMs idle, and one
// F.conv3d is faster.
#include "common.cuh"

// UPDOWN_ABLATE (0 in the model's build) removes one part of the kernel for
// a timing experiment: 1 the weight-slab loads, 2 the wgmma products, 3
// the output stores (4 and 5: as built).  The results of such a build are
// wrong.
#ifndef UPDOWN_ABLATE
#define UPDOWN_ABLATE 0
#endif

using namespace pasco;

namespace {

constexpr int ABLATE = UPDOWN_ABLATE;

constexpr int THREADS = 128;   // one consumer warpgroup
constexpr int MR = 64;         // compacted output cells per product item
constexpr int N = 128;         // output channels per product item
constexpr int ZR = 128;        // flat output cells per zero item
constexpr int A_BYTES = MR * 128;            // 64 rows x 64 channels
constexpr int STAGE = A_BYTES + 64 * N * 2;  // + a [64 x 128] weight slab

template <int CI, int CO> struct Geom {
  static constexpr int SPLIT = CO / N;   // product items per 64 cells
  static constexpr int STEPS = 8 * CI / 64;
  static constexpr int CTAS = 2;         // per SM
  static constexpr int STAGES = 4;
  static constexpr int D = STAGES - 2;   // steps loaded ahead of the products
  static constexpr int BYTES = STAGES * STAGE + MR * 12 + ZR * 4 + 5 * CO * 4 + 1024;
  static_assert(BYTES * CTAS <= 232448, "over the shared memory of an SM");
  static_assert(STEPS % 2 == 0, "steps run in pairs");
};

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* mask_in;
  const uint8_t* mask_out;
  const __nv_bfloat16* w;
  const float* vec[5];   // bias, a1, c1, a2, c2
  __nv_bfloat16* out;
  const int* ids;        // valid output cells first (flat [X/2, Z/2, Y/2])
  const int* n_valid;
  int X, Z, Y;
};

template <int CI, int CO>
__global__ void __launch_bounds__(THREADS, Geom<CI, CO>::CTAS) down2_kernel(const Params p) {
  using G = Geom<CI, CO>;
  constexpr int SPLIT = G::SPLIT, STEPS = G::STEPS, STAGES = G::STAGES, D = G::D;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* s_gin = reinterpret_cast<int*>(smem + STAGES * STAGE);   // child (0,0,0) cell
  int* s_out = s_gin + MR;                                      // output cell or -1
  int* s_bits = s_out + MR;                                     // valid children
  int* s_zero = s_bits + MR;                                    // zero item: cell invalid
  float* s_vec = reinterpret_cast<float*>(s_zero + ZR);         // 5 x CO
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  for (int i = tid; i < 5 * CO; i += THREADS) s_vec[i] = p.vec[i / CO][i % CO];
  const int X = p.X, Z = p.Z, Y = p.Y, Z2 = Z / 2, Y2 = Y / 2;
  const int n_out = (X / 2) * Z2 * Y2;
  const int n_valid = *p.n_valid;
  const int n_prod = (n_valid + MR - 1) / MR * SPLIT;
  const int n_items = n_prod + (n_out + ZR - 1) / ZR;

  float acc[64];

  auto child_off = [&](int k) { return (k >> 2) * Z * Y + (k & 1) * Y + ((k >> 1) & 1); };
  // Step s (child k, 64-channel chunk kc) of output channels n0..n0+127.
  auto load_step = [&](int s, int n0) {
    const int k = s / (CI / 64), kc = s % (CI / 64);
    const uint32_t a_s = ring + (s % STAGES) * STAGE, b_s = a_s + A_BYTES;
    const int off = child_off(k);
    for (int v = tid; v < MR * 8; v += THREADS) {
      const int r = v >> 3, c = v & 7;
      const bool ok = (s_bits[r] >> k) & 1;
      const __nv_bfloat16* src =
          ok ? p.x + (long long)(s_gin[r] + off) * CI + kc * 64 + c * 8 : p.x;
      cp_async16(a_s + swz(r, c), src, ok ? 16 : 0);
    }
    if (ABLATE != 1)
      cp_slab_nmajor<N>(b_s, p.w + ((long long)k * CI + kc * 64) * CO + n0, CO, tid, THREADS);
  };

  const int arow = wq * 16 + (lane & 15), hi = lane >> 4;
  // One step: wait for its stage, free the stage of step s - 2 (its
  // products are done) and load step s + D there, then its four k16
  // products with A fragments `a` (the set of step s - 2 is free too).
  auto run_step = [&](int s, int n0, uint32_t (&a)[4][4]) {
    wgmma_wait<1>();
    cp_async_wait<D - 1>();
    fence_async_smem();
    __syncthreads();
    if (s + D < STEPS) load_step(s + D, n0);
    cp_async_commit();
    const uint32_t a_s = ring + (s % STAGES) * STAGE, b_s = a_s + A_BYTES;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) ldmatrix_x4(a[ph], a_s + swz(arow, ph * 2 + hi));
    wgmma_fence();
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
      if constexpr (ABLATE != 2) wgmma<N, 1>(acc, a[ph], smem_desc(b_s + ph * 2048, 8192, 1024));
    wgmma_commit();
  };

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    __syncthreads();   // the last item's readers of the ring and row info are done

    if (it >= n_prod) {   // zeros at the invalid cells of 128 flat output cells
      const int o0 = (it - n_prod) * ZR;
      for (int r = tid; r < ZR; r += THREADS)
        s_zero[r] = o0 + r < n_out && !p.mask_out[o0 + r];
      __syncthreads();
      for (int v = tid; v < ZR * (CO / 8); v += THREADS)
        if (ABLATE != 3 && s_zero[v / (CO / 8)])
          *reinterpret_cast<uint4*>(p.out + (long long)o0 * CO + v * 8) = make_uint4(0, 0, 0, 0);
      continue;
    }

    const int blk = it / SPLIT, n0 = (it % SPLIT) * N;
    for (int r = tid; r < MR; r += THREADS) {
      const int i = blk * MR + r;
      int o = -1, g = 0, bits = 0;
      if (i < n_valid) {
        o = p.ids[i];
        const int oy = o % Y2, t = o / Y2, oz = t % Z2, ox = t / Z2;
        g = (2 * ox * Z + 2 * oz) * Y + 2 * oy;
#pragma unroll
        for (int k = 0; k < 8; ++k) bits |= (p.mask_in[g + child_off(k)] != 0) << k;
      }
      s_out[r] = o;
      s_gin[r] = g;
      s_bits[r] = bits;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < D; ++s) {
      load_step(s, n0);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];   // A fragments of even and odd steps
#pragma unroll 1
    for (int s = 0; s < STEPS; s += 2) {
      run_step(s, n0, a0);
      run_step(s + 1, n0, a1);
    }
    wgmma_wait<0>();
    acc_fence(acc);

    // acc[4j + 2h + e] is row 16 wq + g + 8h, column 8j + 2(lane % 4) + e.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = s_out[wq * 16 + (lane >> 2) + 8 * h];
      if (ABLATE == 3 || o < 0) continue;
      __nv_bfloat16* dst = p.out + (long long)o * CO + n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* vc = s_vec + n0 + col + e;
          float u = acc[4 * j + 2 * h + e] + vc[0];
          u = leaky(vc[CO] * u + vc[2 * CO]);
          v[e] = fmaxf(vc[3 * CO] * u + vc[4 * CO], 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
  cp_async_wait<0>();
}

// Launch configuration, found once per kernel and device.
template <int CI, int CO>
int launch(const Params& p, int n_out, cudaStream_t stream) {
  auto kern = down2_kernel<CI, CO>;
  constexpr int bytes = Geom<CI, CO>::BYTES;
  static int grid_cap[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap[dev] = sms * per_sm;
  }
  const int items = (n_out + MR - 1) / MR * Geom<CI, CO>::SPLIT + (n_out + ZR - 1) / ZR;
  const int grid = items < grid_cap[dev] ? items : grid_cap[dev];
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// (Ci, Co) in {(64, 128), (128, 256), (256, 256)}; ids/n_valid: the valid
// output cells, compacted on the device (pasco_torch/ops/down.py).
extern "C" int pasco_down2_fused(
    const void* x, const void* mask_in, const void* mask_out, const void* w,
    const void* bias, const void* a1, const void* c1, const void* a2,
    const void* c2, void* out, const void* ids, const void* n_valid,
    int X, int Z, int Y, int Ci, int Co, void* stream) {
  if (X % 2 || Z % 2 || Y % 2) return (int)cudaErrorInvalidValue;
  const int n_out = (X / 2) * (Z / 2) * (Y / 2);
  if (n_out == 0) return 0;
  const Params p{(const __nv_bfloat16*)x, (const uint8_t*)mask_in, (const uint8_t*)mask_out,
                 (const __nv_bfloat16*)w,
                 {(const float*)bias, (const float*)a1, (const float*)c1, (const float*)a2,
                  (const float*)c2},
                 (__nv_bfloat16*)out, (const int*)ids, (const int*)n_valid, X, Z, Y};
  cudaStream_t st = (cudaStream_t)stream;
  if (Ci == 64 && Co == 128) return launch<64, 128>(p, n_out, st);
  if (Ci == 128 && Co == 256) return launch<128, 256>(p, n_out, st);
  if (Ci == 256 && Co == 256) return launch<256, 256>(p, n_out, st);
  return (int)cudaErrorInvalidValue;
}
