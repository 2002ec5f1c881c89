// featurizer: per-cell max of sorted point features, occupancy and the
// enc_in 1x1 + bias, with the whole [X, Z, Y, C] volume and its occupancy
// written once, by this kernel.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_featurizer.py:
// _featurizer_kernel (entry featurizer_fused, call _featurizer_call).
// Given the point features f [P, F], the cell keys ks [P] sorted ascending
// (flat [X, Z, Y] cell; invalid points carry n_cells and sort last) and the
// sort's permutation order [P] (ks[i] is the key of point order[i]), it
// writes for every cell c < n_cells
//   occ[c]    = any valid point in c
//   x[c, :]   = max_{points p in c} f[p, :] @ w + b   (max, w and b rounded to
//                                                     x's type; f32 sums)
//   x[c, :]   = 0                                     (no point in c)
// The max is order-independent, so the result is exact whatever order the
// sort leaves a cell's points in.
//
// What bounds it on an H100: bytes, and almost all of them are the output
// (at the 352 x 32 x 352 box and C = 64 in bf16, 507 MB of x against a few
// MB of points).  So every byte of x and occ is stored once and nothing
// else is stored.  Two kinds of work share the kernel and every warp does
// both, without a barrier between them:
//   1. runs (occupied cells), spread over all warps of the grid by points:
//      warp w takes windows of 32 sorted points and finds the heads of the
//      cells' runs by ballot.  Runs go in batches of up to four: each run
//      to a subgroup of F/8 lanes that reads its rows f[order[i]] (no
//      gathered copy) with 16-byte loads, two rows in flight, and keeps the
//      max in registers; the batch's maxes meet in the warp's slice of
//      shared memory and one pass over W (staged once per CTA in shared
//      memory) applies the 1x1 to all four: lane l owns output channels l,
//      l + 32, .. .  A run of more than LONG points goes on a per-CTA list
//      and is reduced later by the whole CTA (256 threads over its points,
//      a shared-memory max), so a crowded cell is split across threads, not
//      walked by one warp;
//   2. zeros (empty cells): persistent CTAs own contiguous ranges of
//      chunks of CH cells; the sorted keys make a chunk's points one slice
//      of ks, found at the start by a binary search per chunk (one thread
//      each); each warp owns 16 rows of a chunk, marks those of its rows
//      that hold a point from the slice's keys (an OR-reduced mask, the
//      keys of four chunks loaded at once) and writes zeros to the others
//      with 16-byte stores, and the occupancy of all 16.
// The 1x1 is ~4k FMA per occupied cell, a few microseconds of f32 FMA at a
// scan's ~70k occupied cells: it stays on the CUDA cores.
#include "common.cuh"

#ifndef FEATURIZER_ABLATE
#define FEATURIZER_ABLATE 0   // scripts_torch/extract_ablation.py; 0 in the model's build
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 128;                 // cells per chunk
constexpr int ROWS = CH / WARPS;        // rows of a chunk per warp (<= 32)
constexpr int WIN = 32;                 // sorted points per run window
constexpr int LONG = 128;               // longer runs go to the whole CTA (>= WIN)
constexpr int BATCH = 4;                // runs whose 1x1 shares one pass over W
constexpr int MAX_F = 128, MAX_CHUNKS = 1024;
// Dynamic shared memory a block may ask for on an H100 (232448 bytes less
// room for the static part).
constexpr int SMEM_MAX = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;

// Eight features (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = t.x;
    v[2 * j + 1] = t.y;
  }
}
// The max in the compute type (rounding is monotone: round(max) = max(round)).
__device__ __forceinline__ float to_compute(float v, const float*) { return v; }
__device__ __forceinline__ float to_compute(float v, const __nv_bfloat16*) {
  return pasco::rbf(v);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = pasco::tobf(v);
}

// max into shared memory; the word starts at -inf.  Non-negative floats
// order as signed ints, negative ones reversed as unsigned ints.
__device__ __forceinline__ void atomic_max(float* a, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

template <typename TI>
__device__ __forceinline__ void max_row(const TI* f, const long long* order, int p, int F,
                                        int g, float (&m)[8]) {
  float v[8];
#if FEATURIZER_ABLATE == 3   // 3: no feature reads
  const long long o = order[p];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (float)(o & 7);
#else
  load8(f + order[p] * F + 8 * g, v);
#endif
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], v[j]);
}

// Rows keys[s] (s < n_runs) of x: the 1x1 of the maxes mw[s][F] + bias, by
// one warp; lane l holds output channels l, l + 32, ..; W is read once for
// the BATCH runs.
template <int NQ, typename TO>
__device__ __forceinline__ void write_rows(const float* mw, const int (&keys)[BATCH],
                                           int n_runs, int F, const float* ws,
                                           const float* bs, TO* x, int lane) {
  constexpr int C = NQ * 32;
  float acc[BATCH][NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float bq = bs[lane + 32 * q];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) acc[s][q] = bq;
  }
#if FEATURIZER_ABLATE != 2   // 2: no 1x1 (the bias alone)
  for (int k = 0; k < F; k += 4) {
    float4 m4[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) m4[s] = *reinterpret_cast<const float4*>(mw + s * F + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float wq = ws[(k + kk) * C + lane + 32 * q];
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
          const float ms = kk == 0 ? m4[s].x : kk == 1 ? m4[s].y : kk == 2 ? m4[s].z : m4[s].w;
          acc[s][q] = fmaf(ms, wq, acc[s][q]);
        }
      }
    }
  }
#endif
#pragma unroll
  for (int s = 0; s < BATCH; ++s) {
    if (s < n_runs) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) store(x, (long long)keys[s] * C + lane + 32 * q, acc[s][q]);
    }
  }
}

template <int NQ, typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) featurizer_kernel(
    const TI* __restrict__ f, const long long* __restrict__ order,
    const int* __restrict__ ks, int P, int F, const float* __restrict__ w,
    const float* __restrict__ b, TO* __restrict__ x, uint8_t* __restrict__ occ,
    int n_cells, int n_chunks, int per_cta) {
  constexpr int C = NQ * 32;
  extern __shared__ float smem[];
  float* ws = smem;                                  // [F][C]
  float* bs = ws + F * C;                            // [C]
  float* mxw = bs + C;                               // [WARPS][BATCH][F] run maxes
  float* mx = mxw + WARPS * BATCH * F;               // [F], a long run's max
  int* off = reinterpret_cast<int*>(mx + F);         // [per_cta + 1]
  int* longs = off + per_cta + 1;                    // heads of long runs
  __shared__ int n_long;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * per_cta;
  const int k1 = min(k0 + per_cta, n_chunks);
  for (int i = tid; i < F * C; i += THREADS) ws[i] = to_compute(w[i], x);
  for (int i = tid; i < C; i += THREADS) bs[i] = to_compute(b[i], x);
  for (int j = tid; j <= k1 - k0; j += THREADS) {
    const int cell = min((k0 + j) * CH, n_cells);
    int lo = 0, hi = P;                              // first point with key >= cell
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ks[mid] < cell) lo = mid + 1; else hi = mid;
    }
    off[j] = lo;
  }
  if (tid == 0) n_long = 0;
  __syncthreads();

  // 1. runs.  Subgroup `sub` (F/8 lanes, feature group g) walks one run of
  // a batch; the batch's 1x1 follows from the warp's slice of mxw.
  const int lpp = F / 8, ppw = 32 / lpp;
  const int nb = ppw < BATCH ? ppw : BATCH;          // runs per batch
  const int sub = lane / lpp, g = lane % lpp;
  float* mw = mxw + warp * BATCH * F;
  const int n_warps = gridDim.x * WARPS;
  for (int base = (blockIdx.x * WARPS + warp) * WIN; base < P; base += n_warps * WIN) {
    const int i = base + lane;
    const int key_l = i < P ? ks[i] : n_cells;
    const int prev = i > 0 && i < P ? ks[i - 1] : -1;
    const bool head = key_l < n_cells && key_l != prev;
    const bool is_long = head && i + LONG < P && ks[i + LONG] == key_l;
    if (is_long) longs[atomicAdd(&n_long, 1)] = i;
    // where a key changes: the heads, the first invalid point, the end of ks
    const unsigned bounds = __ballot_sync(FULL, i >= P || key_l != prev);
    unsigned heads = __ballot_sync(FULL, head && !is_long);
    while (heads) {
      unsigned hm = heads;                           // this subgroup's head
      for (int t = 0; t < sub && hm; ++t) hm &= hm - 1;
      const bool active = sub < nb && hm != 0;
      const int n_runs = min(nb, __popc(heads));
      for (int t = 0; t < nb; ++t) heads &= heads - 1;
      const int h = active ? __ffs(hm) - 1 : 0;
      const int key = __shfl_sync(FULL, key_l, h);
      float m[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
      if (active) {
        // the run ends where the key next changes in the window, else past it
        const unsigned later = bounds & ~((2u << h) - 1u);
        const int end = later ? base + __ffs(later) - 1 : base + WIN;
        int p = base + h;
        for (; p + 1 < end; p += 2) {
          max_row(f, order, p, F, g, m);
          max_row(f, order, p + 1, F, g, m);
        }
        if (p < end) max_row(f, order, p++, F, g, m);
        if (!later)
          for (; p < P && ks[p] == key; ++p) max_row(f, order, p, F, g, m);
      }
      __syncwarp();                                  // the last batch's reads of mw
      if (active) {
        float* dst = mw + sub * F + 8 * g;
        *reinterpret_cast<float4*>(dst) =
            make_float4(to_compute(m[0], x), to_compute(m[1], x), to_compute(m[2], x),
                        to_compute(m[3], x));
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(to_compute(m[4], x), to_compute(m[5], x), to_compute(m[6], x),
                        to_compute(m[7], x));
      }
      __syncwarp();
      int keys[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s) keys[s] = __shfl_sync(FULL, key, (s * lpp) & 31);
      write_rows<NQ>(mw, keys, n_runs, F, ws, bs, x, lane);
    }
  }

  // 2. zeros and occupancy over the CTA's chunks, four chunks at a time;
  // rows r0 .. r0 + ROWS - 1 of each chunk are this warp's.
  const int vpr = C * (int)sizeof(TO) / 16;          // 16-byte vectors per row
  const int lpr = vpr < 32 ? vpr : 32, rpp = 32 / lpr;
  const int rsub = lane / lpr, c_lane = lane % lpr;
  const int r0 = warp * ROWS;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int kb = k0; kb < k1; kb += 4) {
    unsigned mask[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {                    // the first 32 points of each
      const int k = kb + u;
      const int p = k < k1 ? off[k - k0] + lane : 0;
      const bool in = k < k1 && p < off[k - k0 + 1];
      const unsigned r = in ? (unsigned)(ks[p] - k * CH - r0) : ROWS;
      mask[u] = r < ROWS ? 1u << r : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = kb + u;
      if (k >= k1) break;
      for (int p = off[k - k0] + 32 + lane; p < off[k - k0 + 1]; p += 32) {
        const unsigned r = (unsigned)(ks[p] - k * CH - r0);
        if (r < ROWS) mask[u] |= 1u << r;
      }
      const unsigned mk = __reduce_or_sync(FULL, mask[u]);
      const int c0 = k * CH, nc = min(CH, n_cells - c0);
#if FEATURIZER_ABLATE != 1   // 1: no zero stores
      uint4* xv = reinterpret_cast<uint4*>(x + (long long)c0 * C);
      for (int rr = rsub; rr < ROWS; rr += rpp) {
        const int r = r0 + rr;
        if (r < nc && !((mk >> rr) & 1u))
          for (int v = c_lane; v < vpr; v += lpr) xv[(long long)r * vpr + v] = zero;
      }
#endif
      if (lane < ROWS && r0 + lane < nc) occ[c0 + r0 + lane] = (mk >> lane) & 1u;
    }
  }

  // 3. long runs, each by the whole CTA: THREADS / lpp points at once.
  __syncthreads();
  const int n = n_long;
  for (int e = 0; e < n; ++e) {
    const int start = longs[e];
    const int key = ks[start];
    for (int i = tid; i < F; i += THREADS) mx[i] = -INFINITY;
    __syncthreads();
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
    for (int p = start + tid / lpp; p < P && ks[p] == key; p += THREADS / lpp)
      max_row(f, order, p, F, g, m);
#pragma unroll
    for (int j = 0; j < 8; ++j) atomic_max(&mx[8 * g + j], m[j]);
    __syncthreads();
    if (warp == 0) {
      for (int k = lane; k < F; k += 32) mw[k] = to_compute(mx[k], x);
      __syncwarp();
      int keys[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s) keys[s] = key;
      write_rows<NQ>(mw, keys, 1, F, ws, bs, x, lane);
    }
    __syncthreads();
  }
}

template <int NQ, typename TI, typename TO>
int launch(const void* f, const void* order, const void* ks, const void* w, const void* b,
           void* x, void* occ, int P, int F, int n_cells, cudaStream_t s) {
  constexpr int C = NQ * 32;
  const int n_chunks = (n_cells + CH - 1) / CH;
  auto kernel = featurizer_kernel<NQ, TI, TO>;
  // Shared memory: W, b, the warps' run maxes, a long run's max, then the
  // chunk offsets (at most MAX_CHUNKS + 1) and the long-run list.
  const size_t fixed = (size_t)(F * C + C + WARPS * BATCH * F + F) * 4;
  static int resident[64][MAX_F + 1];   // resident CTAs per SM, per device and F
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev][F] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev][F], kernel, THREADS,
                                                        fixed + (MAX_CHUNKS + 1) * 4);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = resident[dev][F] * sms[dev];
  if (grid > n_chunks) grid = n_chunks;
  if (grid < 1) grid = 1;
  int per_cta = (n_chunks + grid - 1) / grid;
  if (per_cta > MAX_CHUNKS) per_cta = MAX_CHUNKS;
  grid = (n_chunks + per_cta - 1) / per_cta;
  // A window of WIN points holds at most one head of a long run (LONG >= WIN),
  // and a CTA's warps take at most WARPS * ceil(windows / warps) windows.
  const int windows = (P + WIN - 1) / WIN;
  const int long_cap = WARPS * ((windows + grid * WARPS - 1) / (grid * WARPS));
  const size_t smem = fixed + (size_t)(per_cta + 1 + long_cap) * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, s>>>(
      (const TI*)f, (const long long*)order, (const int*)ks, P, F, (const float*)w,
      (const float*)b, (TO*)x, (uint8_t*)occ, n_cells, n_chunks, per_cta);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch_c(const void* f, const void* order, const void* ks, const void* w, const void* b,
             void* x, void* occ, int P, int F, int C, int n_cells, cudaStream_t s) {
  switch (C) {
    case 32: return launch<1, TI, TO>(f, order, ks, w, b, x, occ, P, F, n_cells, s);
    case 64: return launch<2, TI, TO>(f, order, ks, w, b, x, occ, P, F, n_cells, s);
    case 128: return launch<4, TI, TO>(f, order, ks, w, b, x, occ, P, F, n_cells, s);
    case 256: return launch<8, TI, TO>(f, order, ks, w, b, x, occ, P, F, n_cells, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// in_dtype, out_dtype: 0 = f32, 1 = bf16.  F is a power of two in [8, 128],
// C one of 32, 64, 128, 256; f and x are 16-byte aligned (the wrapper
// checks).
extern "C" int pasco_featurizer(const void* f, const void* order, const void* ks,
                                const void* w, const void* b, void* x, void* occ, int P,
                                int F, int C, int n_cells, int in_dtype, int out_dtype,
                                void* stream) {
  if (F < 8 || F > MAX_F || (F & (F - 1)) || n_cells < 1 || P < 0 ||
      ((uintptr_t)x & 15) != 0 || ((uintptr_t)f & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return launch_c<float, float>(f, order, ks, w, b, x, occ, P, F, C, n_cells, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_c<float, __nv_bfloat16>(f, order, ks, w, b, x, occ, P, F, C, n_cells, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_c<__nv_bfloat16, float>(f, order, ks, w, b, x, occ, P, F, C, n_cells, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_c<__nv_bfloat16, __nv_bfloat16>(f, order, ks, w, b, x, occ, P, F, C,
                                                   n_cells, s);
  return (int)cudaErrorInvalidValue;
}
